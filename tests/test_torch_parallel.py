"""The port's multi-process layer (gravit_tpu_torch/parallel/) on the CPU:
the single-process helpers (the counterpart of
tests/test_multihost.py::test_parallel_single_process_helpers), the
LocalGroup collectives against numpy, GlobalCounter.device_sum and
image.composite over a group, and a real 2-process run on gloo (spawned by
torch.multiprocessing on a free port, the mpiexec -n 2 analog of
tests/test_multihost.py::test_two_process_domain_render_matches): there
DistGroup's collectives equal LocalGroup's, and trace_domain's image on
one member per process equals LocalGroup(2)'s in one process, bit for bit
(two members: a sum of two framebuffers does not depend on its order),
and the all-resident frame within 1e-5 (the JAX tests' bound).
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke

from gravit_tpu_torch import parallel
from gravit_tpu_torch.core import timing
from gravit_tpu_torch.core.timing import GlobalCounter
from gravit_tpu_torch.parallel import LocalGroup, global_mesh, host_array
from gravit_tpu_torch.render.scene_build import build_scene
from gravit_tpu_torch.render.tracer import make_arena, trace_image
from gravit_tpu_torch.scene import image
from gravit_tpu_torch.schedule import domain_sched as ds

torch.set_num_threads(2)

FILM = 32
ENV = ("GRAVIT_COORDINATOR", "GRAVIT_NUM_PROCESSES", "GRAVIT_PROCESS_ID")


def test_parallel_single_process_helpers(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    parallel.initialize()            # single-process mode: no coordinator
    assert parallel.is_initialized()
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    mesh = parallel.global_mesh(("domains",), device="cpu")
    assert mesh.shape == {"domains": 1}
    mesh2 = parallel.global_mesh(("domains", "rays"), shape=(4, 2),
                                 device="cpu")
    assert mesh2.shape == {"domains": 4, "rays": 2} and mesh2.size == 8
    assert all(isinstance(g, LocalGroup) for g in mesh2.groups.values())
    parallel.shutdown()
    assert not parallel.is_initialized()


def test_initialize_needs_every_setting(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GRAVIT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        parallel.initialize()
    assert not parallel.is_initialized()


def test_no_card_no_default_device():
    """A group's device is resolved as every entry point's: None means the
    card, and without one it raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalGroup(2)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_local_group_collectives(n):
    g = LocalGroup(n, "cpu")
    rng = np.random.default_rng(n)
    xs = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(n)]
    t = [torch.as_tensor(x) for x in xs]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x                     # member order, as the group
    for got in g.all_reduce(t):
        np.testing.assert_array_equal(got.numpy(), total)
    for got in g.all_reduce(t, "max"):
        np.testing.assert_array_equal(got.numpy(), np.max(xs, axis=0))
    for got in g.all_gather(t):
        np.testing.assert_array_equal(got.numpy(), np.stack(xs))
    sends = [rng.integers(0, 99, (n, 4, 2)) for _ in range(n)]
    recv = g.all_to_all([torch.as_tensor(s) for s in sends])
    for k in range(n):                # member k gets every member's row k
        np.testing.assert_array_equal(recv[k].numpy(),
                                      np.stack([s[k] for s in sends]))
    with pytest.raises(ValueError, match="local members"):
        g.all_reduce(t[:-1] + [t[0], t[0]])
    with pytest.raises(ValueError, match="op"):
        g.all_reduce(t, "min")


def test_host_array_counter_and_composite():
    g = LocalGroup(4, "cpu")
    parts = host_array(g, np.arange(8 * 3).reshape(8, 3))
    assert [p.shape for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  np.arange(24).reshape(8, 3))
    # host counts are spans of one name
    with timing.recording() as rec:
        for _ in range(7):
            with timing.span("rays"):
                pass
    assert (sum(s.name == "rays" for s in rec.spans()) == 7
            and "rays" in rec.report())
    sums = GlobalCounter.device_sum([torch.tensor(k) for k in range(4)], g)
    assert [int(s) for s in sums] == [6] * 4
    assert int(GlobalCounter.device_sum(torch.tensor(5))) == 5
    assert int(GlobalCounter.device_sum(torch.tensor(5),
                                        LocalGroup(1, "cpu"))) == 5
    fbs = [torch.full((6, 4), 0.4) for _ in range(4)]
    for fb in image.composite(fbs, g):          # sum, then clamp rgb at 1
        np.testing.assert_allclose(fb[:, :3].numpy(), 1.0)
        np.testing.assert_allclose(fb[:, 3].numpy(), 1.6, rtol=1e-6)
    np.testing.assert_array_equal(image.composite(fbs[0]).numpy(),
                                  fbs[0].numpy())


def _scene():
    spec = chip_smoke.simple_app(FILM, FILM)
    return spec.meshes, tp.grid_instances(lambda k: k % 2), spec.lights, \
        spec.camera


def _trace(mesh, ray_axis=None):
    meshes, instances, lights, cam = _scene()
    stacked, owners = ds.partition_scene(meshes, instances, lights, 2,
                                         device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    fb, drops, load = ds.trace_domain(
        stacked, owners, arena, FILM, FILM, mesh, ray_axis=ray_axis,
        max_rounds=32, return_stats=True, return_load=True)
    return fb, drops, load


def _worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 2-process run: DistGroup collectives, then the
    domain-scheduled frame on the 1-D and on a (2, 1) two-axis layout."""
    parallel.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        mesh = global_mesh(("domains",), device="cpu")
        g = mesh.groups["domains"]
        assert isinstance(g, parallel.DistGroup) and g.local == (rank,)
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
        out = {"sum": g.all_reduce([x])[0], "max": g.all_reduce([x], "max")[0],
               "gather": g.all_gather([x])[0],
               "a2a": g.all_to_all([x.reshape(2, 3, 1)])[0],
               "a2a_bool": g.all_to_all([(x > 12).reshape(2, 3)])[0]}
        fb, drops, load = _trace(mesh)
        fb2, _, _ = _trace(global_mesh(("domains", "rays"), (2, 1),
                                       device="cpu"), ray_axis="rays")
        out.update(fb=fb, drops=drops, load=load, fb_2d=fb2)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        parallel.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_local_group(tmp_path):
    ctx = mp.start_processes(_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + 300
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError("the 2-process run did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(2)]
    local = LocalGroup(2, "cpu")
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(got["max"], np.maximum(*xs))
        np.testing.assert_array_equal(got["gather"], np.stack(xs))
        want = local.all_to_all([torch.as_tensor(x).reshape(2, 3, 1)
                                 for x in xs])[r]
        np.testing.assert_array_equal(got["a2a"], want.numpy())
        np.testing.assert_array_equal(got["a2a_bool"],
                                      np.stack([x[r] > 12 for x in xs]))
    fb, drops, load = _trace(global_mesh(("domains",), (2,), device="cpu"))
    for got in ranks:
        np.testing.assert_array_equal(got["fb"], fb.numpy())
        np.testing.assert_array_equal(got["fb_2d"], fb.numpy())
        assert int(got["drops"]) == int(drops) == 0
        np.testing.assert_array_equal(got["load"], load.numpy())
    meshes, instances, lights, cam = _scene()
    scene = build_scene(meshes, instances, lights, device="cpu")
    ref = trace_image(scene, make_arena(cam.generate_rays("cpu"), 1), FILM,
                      FILM, max_rounds=32)
    assert float((fb - ref)[:, :3].abs().max()) < 1e-5
