"""The port's data-parallel train step and its dry run
(gravit_tpu_torch/render/train.py::make_sharded_train_step,
gravit_tpu_torch/dryrun.py) on the CPU.

The step splits the arena into contiguous shards (the JAX package's
P("rays")), sums the members' framebuffers inside the loss and sums the
parameter gradients over the group. Its gradient is the one of the loss it
returns, so for the same arena it equals make_train_step's up to summation
order: on LocalGroup(n) in one process, and on a DistGroup of 2 gloo
processes (spawned on a free port, in the manner of
test_torch_parallel.py). The JAX package's sharded step is a known fault
of the reference: its gradient is n times its single-device gradient. The
committed golden records it, from JAX on 4 virtual CPU devices, so that
this file compiles no shard_map; refresh it by hand:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/test_torch_dryrun.py --write-golden

The fixture is SimpleApp at 16^2 (the dry run's), 3 rounds, a zero
target, optax.sgd(1.0) / torch.optim.SGD(lr=1.0) so that a step's
parameter change is its gradient.
"""

import contextlib
import io
import pathlib
import re
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)

from gravit_tpu_torch import dryrun, parallel
from gravit_tpu_torch.parallel import LocalGroup, global_mesh
from gravit_tpu_torch.render import train
from gravit_tpu_torch.render.scene_build import build_scene
from gravit_tpu_torch.render.tracer import make_arena

FILM = 16
ROUNDS = 3
GOLDEN = pathlib.Path(__file__).parent / "data" / \
    "torch_port_train_golden.npz"
FIELDS = train.TrainParams._fields


def _sgd(params):
    return torch.optim.SGD(params, lr=1.0)


def _fixture():
    meshes, instances, lights, cam = dryrun.simple_app(FILM, FILM)
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), scene.num_lights)
    return scene, arena, torch.zeros((FILM * FILM, 4))


def _update(step, optimizer):
    """(loss, the parameters' change) of one step from the scene's own
    parameters: with SGD at lr 1 the change is the gradient."""
    scene, arena, target = _fixture()
    p = train.params_from_scene(scene)
    before = [x.detach().clone() for x in p]
    p, _, loss = step(p, optimizer(list(p)), scene, arena, target)
    return float(loss), [(b - x.detach()).numpy()
                         for b, x in zip(before, p)]


def _single():
    return _update(*train.make_train_step(_sgd, ROUNDS, FILM, FILM))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def single():
    return _single()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_step_equals_single(single, n):
    """LocalGroup(n): the same loss (every pixel's rays stay in one
    shard, so the summed framebuffer is the single frame) and the
    gradient within 1e-6 relative (2-norm) of make_train_step's, not n
    times it (measured: kd, light equal; vertices 1.5e-8 at n = 4, the
    summation order of the shared vertices' gradients; kd and vertex
    gradients also vary by about 1e-9 between two CPU runs with several
    threads, their scatter-adds accumulating in no fixed order)."""
    loss, upd = _update(*train.make_sharded_train_step(
        LocalGroup(n, "cpu"), optimizer=_sgd, rounds=ROUNDS, width=FILM,
        height=FILM))
    assert loss == single[0]
    for name, got, ref in zip(FIELDS, upd, single[1]):
        assert np.abs(ref).max() > 0, name
        assert _rel(got, ref) < 1e-6, name


def test_mesh_takes_the_ray_axis(single):
    """A Mesh hands the step its `ray_axis` group: (domains 2, rays 2)."""
    mesh = global_mesh(("domains", "rays"), (2, 2), device="cpu")
    loss, upd = _update(*train.make_sharded_train_step(
        mesh, ray_axis="rays", optimizer=_sgd, rounds=ROUNDS, width=FILM,
        height=FILM))
    assert loss == single[0]
    for got, ref in zip(upd, single[1]):
        assert _rel(got, ref) < 1e-6


def test_shard_arena_pads_and_splits():
    _, arena, _ = _fixture()
    shards = train.shard_arena(arena, 3)
    c = -(-arena.capacity // 3)
    assert [s.capacity for s in shards] == [c] * 3
    joined = torch.cat([s.origin for s in shards])
    np.testing.assert_array_equal(joined[:arena.capacity].numpy(),
                                  arena.origin.numpy())
    assert not bool(torch.cat([s.active for s in shards])[
        arena.capacity:].any())


def test_sum_replicated_backward_passes_the_cotangent():
    """The DistGroup reduce's backward is the identity (the cotangent is
    the same on every member); LocalGroup(1) stands in for the group."""
    x = torch.arange(4.0, requires_grad=True)
    y = train._SumReplicated.apply(x, LocalGroup(1, "cpu"))
    (y * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 2.0, 3.0, 4.0])


def test_jax_sharded_gradient_is_n_times(gold, single):
    """The reference's fault, from the golden: JAX's sharded step over 4
    devices reports its single-device loss, and its update is 4 times the
    single-device update (within 1e-5 relative). The port's update is the
    JAX single-device update within 1e-5 relative, both on one device and
    on LocalGroup(4)."""
    assert abs(float(gold["loss_sharded"]) - float(gold["loss_single"])) \
        <= 1e-7
    assert abs(single[0] - float(gold["loss_single"])) <= 1e-7
    port4 = _update(*train.make_sharded_train_step(
        LocalGroup(4, "cpu"), optimizer=_sgd, rounds=ROUNDS, width=FILM,
        height=FILM))[1]
    for name, mine, mine4 in zip(FIELDS, single[1], port4):
        js, jn = gold[f"single_{name}"], gold[f"sharded_{name}"]
        assert _rel(jn, 4.0 * js) < 1e-5, name
        assert _rel(mine, js) < 1e-5, name
        assert _rel(mine4, js) < 1e-5, name
        assert _rel(mine4, jn) > 0.5, name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 2-process step: a DistGroup of the world, gloo."""
    torch.set_num_threads(2)
    parallel.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        mesh = global_mesh(("rays",), device="cpu")
        assert isinstance(mesh.groups["rays"], parallel.DistGroup)
        loss, upd = _update(*train.make_sharded_train_step(
            mesh, optimizer=_sgd, rounds=ROUNDS, width=FILM, height=FILM))
        np.savez(f"{out_dir}/rank{rank}.npz", loss=loss,
                 **dict(zip(FIELDS, upd)))
    finally:
        parallel.shutdown()


def test_two_process_gloo_step(tmp_path, single):
    """The step over a DistGroup of 2 gloo processes: both ranks report
    the single-device loss and make the same update bit for bit (the
    all-reduced gradient), within 1e-6 relative of LocalGroup(2)'s and of
    the single-device update."""
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + 300
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError("the 2-process step did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    _, local2 = _update(*train.make_sharded_train_step(
        LocalGroup(2, "cpu"), optimizer=_sgd, rounds=ROUNDS, width=FILM,
        height=FILM))
    for got in ranks:
        assert float(got["loss"]) == single[0]
        for name, loc, ref in zip(FIELDS, local2, single[1]):
            np.testing.assert_array_equal(got[name], ranks[0][name],
                                          err_msg=name)
            assert _rel(got[name], loc) < 1e-6, name
            assert _rel(got[name], ref) < 1e-6, name


def test_dryrun_multichip(gold):
    """dryrun_multichip(4) on the CPU: a (2, 2) layout, every forward's
    frame finite, the train loss finite; each frame sum within 1e-5
    relative of the JAX dry run's (its printed line, in the golden) and
    the loss within 1e-6; the accel and replica-routed frames equal to the
    brute domain frame (bit-equal on the CPU)."""
    out, frames = dryrun.dryrun_multichip(4, device="cpu", return_frames=True)
    assert out["layout"] == {"domains": 2, "rays": 2}
    for key in ("accel_domain_forward", "replica_routed_forward"):
        assert torch.equal(frames[key], frames["domain_forward"]), key
    for key in ("domain_forward", "accel_domain_forward",
                "replica_routed_forward", "volume_domain_forward"):
        ref = float(gold[f"dryrun_{key}"])
        assert abs(out[key] - ref) <= 1e-5 * abs(ref), (key, out[key], ref)
    assert abs(out["train_loss"] - float(gold["dryrun_train_loss"])) <= 1e-6


def test_entry_renders():
    """entry(): a forward render of SimpleApp at 32^2, lit and finite."""
    fn, args = dryrun.entry("cpu")
    fb = fn(*args)
    assert fb.shape == (32 * 32, 4) and bool(torch.isfinite(fb).all())
    assert float((fb[:, :3].sum(dim=1) > 0).float().mean()) > 0.2


# ---------------------------------------------------------------------------

def write_golden(path=GOLDEN) -> None:
    """JAX's single-device and 4-device sharded SGD(1.0) updates, and the
    numbers its dry run prints (run by hand, 8 virtual devices)."""
    import jax.numpy as jnp
    import optax

    import __graft_entry__
    import scenes
    from gravit_tpu.render.tracer import make_arena as jmake_arena
    from gravit_tpu.render.train import (make_sharded_train_step,
                                         make_train_step, params_from_scene)

    jscene, jcam = scenes.simple_scene(FILM, FILM)
    jarena = jmake_arena(jcam.generate_rays(), jscene.num_lights)
    target = jnp.zeros((FILM * FILM, 4), jnp.float32)
    out = {}
    for kind, (step, opt) in (
            ("single", make_train_step(optax.sgd(1.0), ROUNDS, FILM, FILM)),
            ("sharded", make_sharded_train_step(
                tp.jax_mesh((4,), ("rays",)), "rays", optax.sgd(1.0),
                ROUNDS, FILM, FILM))):
        p = params_from_scene(jscene)
        q, _, loss = step(p, opt.init(p), jscene, jarena, target)
        out[f"loss_{kind}"] = np.float32(loss)
        for name, a, b in zip(FIELDS, p, q):
            out[f"{kind}_{name}"] = np.asarray(a) - np.asarray(b)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        __graft_entry__.dryrun_multichip(4)
    line = buf.getvalue()
    for key, label in (("domain_forward", "domain-forward fbsum"),
                       ("accel_domain_forward", "accel-domain fbsum"),
                       ("replica_routed_forward", "replica-routed fbsum"),
                       ("volume_domain_forward", "volume-domain fbsum"),
                       ("train_loss", "train loss")):
        out[f"dryrun_{key}"] = np.float64(
            re.search(re.escape(label) + r"=([-0-9.e]+)", line).group(1))
    np.savez(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
