"""The port's checkpoint (gravit_tpu_torch/render/checkpoint.py) and the
JAX training state carried across (interop.train_state_from_numpy), on
the CPU.

The file format is the JAX package's npz fallback (render/checkpoint.py:
40-83): one `leaf_i` per leaf of {"opt_state", "params", "step"} in
flatten order, Adam's state as optax's ScaleByAdamState(count, mu, nu).
Orbax imports in this environment, so the JAX package's own `save` writes
orbax; these tests force its fallback with
monkeypatch.setitem(sys.modules, "orbax.checkpoint", None).

The fixture is SimpleApp at 16^2 (the dry run's), 3 rounds, a uniform
random target from a numpy seed.
"""

import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: F401,I001 (puts the repo root on sys.path)

from gravit_tpu_torch import dryrun, interop
from gravit_tpu_torch.render import checkpoint, train
from gravit_tpu_torch.render.scene_build import build_scene
from gravit_tpu_torch.render.tracer import make_arena

FILM = 16
ROUNDS = 3


def _fixture():
    meshes, instances, lights, cam = dryrun.simple_app(FILM, FILM)
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), scene.num_lights)
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        size=(FILM * FILM, 4)).astype(np.float32))
    return scene, arena, target


def _trained(steps: int, lr: float = 5e-2):
    """The scene's params after `steps` Adam steps, the optimiser, the
    step function and the fixture."""
    scene, arena, target = _fixture()
    step, optimizer = train.make_train_step(train.adam(lr), ROUNDS, FILM,
                                            FILM)
    p = train.params_from_scene(scene)
    opt = optimizer(list(p))
    for _ in range(steps):
        p, opt, _ = step(p, opt, scene, arena, target)
    return p, opt, step, (scene, arena, target)


def _host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_params_equal(a, b):
    for name, x, y in zip(train.TrainParams._fields, a, b):
        np.testing.assert_array_equal(_host(x), _host(y), err_msg=name)


def test_round_trip(tmp_path):
    """save then restore gives the params, Adam's count and moments and
    the step back bit for bit; the params come back as leaf tensors that
    require grad. An AdamState saves as the optimiser does."""
    p, opt, _, _ = _trained(2)
    checkpoint.save(tmp_path / "ck", p, opt, step=7)
    q, st, step = checkpoint.restore(tmp_path / "ck", device="cpu")
    assert step == 7
    _assert_params_equal(q, p)
    assert all(x.requires_grad and x.is_leaf for x in q)
    want = train.adam_state(opt, p)
    assert int(st.count) == int(want.count) == 2
    _assert_params_equal(st.mu, want.mu)
    _assert_params_equal(st.nu, want.nu)
    checkpoint.save(str(tmp_path / "ck2.npz"), p, want, step=7)
    a, b = np.load(tmp_path / "ck.npz"), np.load(tmp_path / "ck2.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 14
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_round_trip_without_optimiser(tmp_path):
    """opt_state None is one empty float32 leaf, as in the JAX package."""
    p, _, _, _ = _trained(0)
    checkpoint.save(tmp_path / "ck", p, None, step=3)
    data = np.load(tmp_path / "ck.npz")
    assert len(data.files) == 6 and data["leaf_0"].size == 0
    q, st, step = checkpoint.restore(tmp_path / "ck", device="cpu")
    assert st is None and step == 3
    _assert_params_equal(q, p)


def test_restore_rejects_other_files(tmp_path):
    np.savez(tmp_path / "x.npz", leaf_0=np.zeros(3), leaf_1=np.zeros(3))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(tmp_path / "x.npz", device="cpu")


def test_resume_equals_uninterrupted(tmp_path):
    """Two steps, a save, then a third step in the same optimiser, against
    a restore into a fresh optimiser and a third step: bit-equal params,
    count and moments. The third steps run on one CPU thread: with
    several (as on the card) a vertex gradient's last bits vary from run
    to run, its scatter-adds accumulating in no fixed order."""
    p, opt, step, (scene, arena, target) = _trained(2)
    checkpoint.save(tmp_path / "ck", p, opt, step=2)
    q, st, k = checkpoint.restore(tmp_path / "ck", device="cpu")
    resumed = train.load_adam_state(train.adam(5e-2)(list(q)), q, st)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p, opt, loss = step(p, opt, scene, arena, target)
        q, resumed, loss_q = step(q, resumed, scene, arena, target)
    finally:
        torch.set_num_threads(threads)
    assert float(loss) == float(loss_q)
    _assert_params_equal(q, p)
    got, want = train.adam_state(resumed, q), train.adam_state(opt, p)
    assert int(got.count) == int(want.count) == k + 1
    _assert_params_equal(got.mu, want.mu)
    _assert_params_equal(got.nu, want.nu)


def _jax_state(seed: int = 0, updates: int = 2):
    """JAX's params of the fixture's scene and an optax.adam(5e-2) state
    after `updates` updates with random gradients (no render)."""
    import jax
    import jax.numpy as jnp
    import optax

    import scenes
    from gravit_tpu.render.train import params_from_scene

    jscene, _ = scenes.simple_scene(FILM, FILM)
    p = params_from_scene(jscene)
    opt = optax.adam(5e-2)
    state = opt.init(p)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32)), p)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
    return p, state, opt


def test_reads_jax_npz_fallback(tmp_path, monkeypatch):
    """A file written by the JAX package's npz fallback restores in the
    port: params, count, mu, nu and step equal; and the port's file
    restores in the JAX package against its template."""
    import jax

    from gravit_tpu.render import checkpoint as jckpt

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    p, state, _ = _jax_state()
    jckpt.save(str(tmp_path / "jax"), p, state, step=5)
    assert (tmp_path / "jax.npz").exists()
    q, st, step = checkpoint.restore(tmp_path / "jax", device="cpu")
    assert step == 5
    _assert_params_equal(q, p)
    adam = state[0]
    assert int(st.count) == int(adam.count) == 2
    _assert_params_equal(st.mu, adam.mu)
    _assert_params_equal(st.nu, adam.nu)

    # the JAX fallback's restore takes its 0-d leaves' types from the
    # template: numpy arrays there (a 0-d jax.Array cannot be rebuilt by
    # type(t)(value))
    checkpoint.save(tmp_path / "port", q, st, step=6)
    template = jax.tree.map(np.asarray, (p, state))
    jp, jstate, jstep = jckpt.restore(str(tmp_path / "port"),
                                      (*template, 0))
    assert jstep == 6
    for a, b in zip(jax.tree.leaves((jp, jstate)),
                    jax.tree.leaves((p, state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_from_jax_state():
    """train_state_from_numpy carries JAX's params and optax Adam state
    across; the port's next step equals optax's next update fed the same
    gradient (the port's), within 2.4e-7 (2 ulp at the leaves' largest
    magnitude, 1.0: the two order their roundings differently). Without
    leaves it gives a fresh optimiser."""
    import jax
    import jax.numpy as jnp
    import optax

    p, state, opt = _jax_state()
    q, topt = interop.train_state_from_numpy(
        [np.asarray(x) for x in p],
        [np.asarray(x) for x in jax.tree.leaves(state)], device="cpu",
        optimizer=train.adam(5e-2))
    _assert_params_equal(q, p)
    scene, arena, target = _fixture()
    step, _ = train.make_train_step(None, ROUNDS, FILM, FILM)
    q, topt, _ = step(q, topt, scene, arena, target)
    g = [x.grad.numpy() for x in q]
    upd, _ = opt.update(type(p)(*map(jnp.asarray, g)), state, p)
    want = optax.apply_updates(p, upd)
    for name, got, ref in zip(p._fields, q, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=2.4e-7, err_msg=name)
    assert int(train.adam_state(topt, q).count) == 3
    fresh, fopt = interop.train_state_from_numpy(
        [np.asarray(x) for x in p], device="cpu")
    assert not fopt.state and fopt.defaults["lr"] == 1e-3
    with pytest.raises(ValueError, match="state leaves"):
        interop.train_state_from_numpy([np.asarray(x) for x in p],
                                       [np.zeros(1)], device="cpu")
