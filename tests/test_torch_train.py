"""The port's differentiable rendering (gravit_tpu_torch/render/train.py,
scene_build.refresh_geometry) against the JAX package's, on the CPU.

The fixture is tests/test_gradients.py's: simple_scene(16, 16) (SimpleApp,
25 instances, 18 triangles, one point light), 3 rounds, a uniform random
target from a numpy seed. One jitted jax.value_and_grad serves every JAX
comparison below (its compile is most of this file's time).

Tolerances, from measurement: the forward is ulp-level (XLA's CPU backend
contracts a*b+c into fused multiply-adds, the port rounds each operation;
the losses agree to 3e-8 in 0.27), the gradients within 1e-5 relative in
the 2-norm and 1e-7 absolute per element (measured: at most 3.3e-7
relative, 3.7e-9 absolute). The finite-difference checks are JAX's own
(test_gradients.py: eps 3e-3, rtol 0.15, the vertices 0.3), run on the
port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import scenes

W = H = 16
ROUNDS = 3


def _target():
    return np.random.default_rng(3).uniform(size=(W * H, 4)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's scene, arena, loss and gradient, and 3 optax.adam(1e-3) steps
    from them: (scene, arena, loss, grads, params after each Adam step)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gravit_tpu.render.tracer import make_arena
    from gravit_tpu.render.train import loss_fn, params_from_scene

    jscene, jcam = scenes.simple_scene(W, H)
    jarena = make_arena(jcam.generate_rays(), jscene.num_lights)
    target = jnp.asarray(_target())
    vg = jax.jit(jax.value_and_grad(loss_fn), static_argnums=(4, 5, 6))
    opt = optax.adam(1e-3)
    q = params_from_scene(jscene)
    state = opt.init(q)
    losses, adam_params, adam_grads = [], [], []
    for _ in range(3):
        loss, g = vg(q, jscene, jarena, target, W, H, ROUNDS)
        upd, state = opt.update(g, state, q)
        q = optax.apply_updates(q, upd)
        losses.append(float(loss))
        adam_grads.append([np.asarray(x) for x in g])
        adam_params.append([np.asarray(x) for x in q])
    return dict(scene=jscene, arena=jarena, loss=losses[0],
                grads=adam_grads[0], adam=adam_params,
                adam_grads=adam_grads)


def port_setup(ref):
    from gravit_tpu_torch.render import train

    scene = tp.port_scene(ref["scene"])
    arena = tp.port_rays(ref["arena"])
    return scene, arena, train.params_from_scene(scene), torch.as_tensor(
        _target())


@pytest.fixture(scope="module")
def port_state():
    """The port's scene, arena, params and target (no JAX gradient)."""
    from gravit_tpu.render.tracer import make_arena

    jscene, jcam = scenes.simple_scene(W, H)
    jarena = make_arena(jcam.generate_rays(), jscene.num_lights)
    return port_setup(dict(scene=jscene, arena=jarena))


# ---------------------------------------------------------------------------
# refresh_geometry

def _perturbed_vertices(jscene):
    v = np.asarray(jscene.vertices)
    return (v + 0.01 * np.random.default_rng(5).standard_normal(v.shape)
            ).astype(np.float32)


def test_refresh_geometry_values():
    """v0 / e1 / e2 bit-equal (gathers and one subtraction), the unit
    geometric and shading normals within 1e-6 (ulp-level: FMA
    contraction in JAX's cross product and norms), at the scene's vertices
    and at perturbed ones."""
    from gravit_tpu.render.scene_build import refresh_geometry as jrefresh
    from gravit_tpu_torch.render.scene_build import refresh_geometry

    jscene, _ = scenes.simple_scene(W, H)
    scene = tp.port_scene(jscene)
    for v in (np.asarray(jscene.vertices), _perturbed_vertices(jscene)):
        ref = jrefresh(jscene, v)
        got = refresh_geometry(scene, torch.as_tensor(v))
        for f in ("tri_v0", "tri_e1", "tri_e2"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)
        for f in ("tri_ng", "tri_ns"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
        assert got.vertices is not scene.vertices


def test_refresh_geometry_vjp():
    """The vertex cotangent of (v0, e1, e2, ng, ns) for one random
    cotangent, against jax.vjp: within 1e-5 relative (2-norm) and 1e-5
    absolute per element."""
    import jax
    import jax.numpy as jnp

    from gravit_tpu.render.scene_build import refresh_geometry as jrefresh
    from gravit_tpu_torch.render.scene_build import refresh_geometry

    jscene, _ = scenes.simple_scene(W, H)
    scene = tp.port_scene(jscene)
    v = _perturbed_vertices(jscene)
    fields = ("tri_v0", "tri_e1", "tri_e2", "tri_ng", "tri_ns")

    def jf(vv):
        s = jrefresh(jscene, vv)
        return tuple(getattr(s, f) for f in fields)

    outs, vjp = jax.vjp(jf, jnp.asarray(v))
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]
    (ref,) = vjp(tuple(jnp.asarray(c) for c in cots))
    vt = torch.as_tensor(v).requires_grad_(True)
    s = refresh_geometry(scene, vt)
    got, = torch.autograd.grad([getattr(s, f) for f in fields], vt,
                               [torch.as_tensor(c) for c in cots])
    ref = np.asarray(ref)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert (np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)) < 1e-5


def test_zero_normal_backward_is_finite():
    """A degenerate triangle (zero-length normal): the port's backward is
    0 there, where JAX's sqrt(sum(x*x)) gives NaN. A deliberate
    difference, kept out of the parity fixtures."""
    from gravit_tpu_torch.render.scene_build import _unit_rows

    x = torch.zeros((2, 3), requires_grad=True)
    y = _unit_rows(x * torch.tensor([[1.0], [0.0]]))
    y.sum().backward()
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the loss, its gradient and the train step against JAX

def test_loss_matches_jax(jax_ref):
    from gravit_tpu_torch.render import train

    scene, arena, p, target = port_setup(jax_ref)
    loss = train.loss_fn(p, scene, arena, target, W, H, ROUNDS)
    assert abs(float(loss) - jax_ref["loss"]) <= 1e-6 * jax_ref["loss"]


@pytest.mark.parametrize("field", ["kd", "light", "vertices"])
def test_grad_matches_jax(jax_ref, field):
    """jax.grad of the loss, leaf by leaf (light: light_pos and
    light_color): within 1e-5 relative in the 2-norm and 1e-7 absolute
    per element; nonzero; finite."""
    from gravit_tpu_torch.render import train

    scene, arena, p, target = port_setup(jax_ref)
    train.loss_fn(p, scene, arena, target, W, H, ROUNDS).backward()
    names = {"kd": ["kd"], "light": ["light_pos", "light_color"],
             "vertices": ["vertices"]}[field]
    for name in names:
        i = train.TrainParams._fields.index(name)
        got, ref = getattr(p, name).grad.numpy(), jax_ref["grads"][i]
        assert np.isfinite(got).all(), name
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7,
                                   err_msg=name)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5, name


def test_adam_steps_match_optax(jax_ref):
    """Three steps of make_train_step's default optimiser (Adam, lr 1e-3,
    optax's betas and eps) against three optax.adam(1e-3) steps.

    Fed JAX's own gradients, torch's Adam gives optax's parameters within
    2.4e-7, 2 ulp at the leaves' largest magnitude (1.0): the two order
    their roundings differently (measured: 1 ulp on 2 of 54 kd entries).
    Through the port's own gradients the parameters' moves from the start
    agree within 1e-2 relative in the 2-norm, and each parameter within
    1e-4, a tenth of lr: Adam divides a gradient entry by its own size
    plus eps (1e-8), so an entry near eps carries its ulp-level difference
    (up to 3.7e-9 against JAX; about 1e-9 between two CPU runs with
    several threads, whose scatter-adds accumulate in no fixed order) into
    a share of its step (measured: 1.6e-3 of the vertices' move, at most
    2.1e-5 on one coordinate after the third step)."""
    from gravit_tpu_torch.render import train

    scene, arena, p, target = port_setup(jax_ref)
    fed = train.TrainParams(*(x.detach().clone().requires_grad_(True)
                              for x in p))
    fed_opt = train.adam(1e-3)(list(fed))
    p0 = train.TrainParams(*(x.detach().numpy().copy() for x in p))
    step, optimizer = train.make_train_step(rounds=ROUNDS, width=W,
                                            height=H)
    opt = optimizer(list(p))
    for k in range(3):
        for x, g in zip(fed, jax_ref["adam_grads"][k]):
            x.grad = torch.as_tensor(g)
        fed_opt.step()
        p, opt, loss = step(p, opt, scene, arena, target)
        for name, got, own, ref in zip(p._fields, fed, p, jax_ref["adam"][k]):
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                       atol=2.4e-7, err_msg=f"{name} {k}")
            np.testing.assert_allclose(own.detach().numpy(), ref, rtol=0,
                                       atol=1e-4, err_msg=f"{name} {k}")
            start = getattr(p0, name)
            move = np.linalg.norm(ref - start)
            assert (np.linalg.norm(own.detach().numpy() - ref)
                    <= 1e-2 * move), f"{name} {k}"
    assert float(loss) < jax_ref["loss"]


# ---------------------------------------------------------------------------
# tests/test_gradients.py's checks, on the port

def _fd_check(f, p, dp, rtol=0.15):
    """Directional derivative of f at p along dp vs central differences
    (test_gradients.py::_fd_check)."""
    eps = 3e-3
    q = [x.detach().clone().requires_grad_(True) for x in p]
    g = torch.autograd.grad(f(q), q, allow_unused=True)
    analytic = sum(float((ga * da).sum()) for ga, da in zip(g, dp)
                   if ga is not None)
    with torch.no_grad():
        plus = [x + eps * d for x, d in zip(p, dp)]
        minus = [x - eps * d for x, d in zip(p, dp)]
        fd = (float(f(plus)) - float(f(minus))) / (2 * eps)
    assert np.isfinite(analytic) and np.isfinite(fd)
    np.testing.assert_allclose(analytic, fd, rtol=rtol, atol=1e-6)
    return analytic


def _direction(p, seeds, scale=1.0):
    """dp: standard normals (numpy seeds) on the named leaves, zeros
    elsewhere."""
    return [torch.as_tensor(scale * np.random.default_rng(seeds[n])
                            .standard_normal(tuple(x.shape))
                            .astype(np.float32))
            if n in seeds else torch.zeros_like(x)
            for n, x in zip(p._fields, p)]


@pytest.mark.parametrize("field", ["kd", "light", "vertices"])
def test_grad_matches_fd(port_state, field):
    """test_gradients.py's test_grad_{kd,light,vertices}_matches_fd on the
    port: kd along a random direction, the light's position and colour
    together, the vertices along a small field (0.05 sigma) that keeps
    the topology (rtol 0.3)."""
    from gravit_tpu_torch.render import train

    scene, arena, p, target = port_state
    seeds, scale, rtol, floor = {
        "kd": ({"kd": 0}, 1.0, 0.15, 1e-8),
        "light": ({"light_pos": 1, "light_color": 2}, 1.0, 0.15, 1e-8),
        "vertices": ({"vertices": 7}, 0.05, 0.3, 1e-10)}[field]

    def f(q):
        return train.loss_fn(train.TrainParams(*q), scene, arena, target,
                             W, H, rounds=ROUNDS)

    g = _fd_check(f, p, _direction(p, seeds, scale), rtol=rtol)
    assert abs(g) > floor


def test_train_step_reduces_loss(port_state):
    """test_gradients.py::test_train_step_reduces_loss on the port: the
    target is the scene's own frame, the start a light 0.3 times as
    bright; 25 Adam steps at lr 5e-2 bring the loss below 0.66 times its
    first value."""
    from gravit_tpu_torch.render import train

    scene, arena, p, _ = port_state
    with torch.no_grad():
        target = train.render_with_params(scene, p, arena, W, H,
                                          rounds=ROUNDS)
    q = p._replace(light_color=(p.light_color.detach() * 0.3)
                   .requires_grad_(True))
    q = train.TrainParams(*(x.detach().clone().requires_grad_(True)
                            for x in q))
    step, optimizer = train.make_train_step(train.adam(5e-2),
                                            rounds=ROUNDS, width=W, height=H)
    opt = optimizer(list(q))
    losses = []
    for _ in range(25):
        q, opt, loss = step(q, opt, scene, arena, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.66, losses


# ---------------------------------------------------------------------------
# the volume gradient paths: the gather march and the plain slice march

VOL_N, VOL_FILM = 12, 8


def _volume_camera(mod):
    return mod.PerspectiveCamera(
        eye=(4.0 * VOL_N,) * 3, focus=((VOL_N - 1) / 2,) * 3,
        up=(0.0, 0.0, 1.0), fov=np.pi / 6, film_width=VOL_FILM,
        film_height=VOL_FILM)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_volume_grad_wrt_samples():
    """test_gradients.py::test_volume_grad_wrt_samples on the port, and
    against jax.grad: the sum of trace_volume(unroll=True, max_rounds=4)'s
    rgb over the wavelet's 12^3 samples at 8^2. Finite, nonzero, the
    directional derivative within rtol 0.1 of central differences (eps
    1e-2), and the gradient within 5e-5 relative (2-norm) of JAX's
    (measured 1.2e-5: FMA contraction, and each sample's gradient is a
    sum over the taps of every ray in another order)."""
    import jax
    import jax.numpy as jnp

    from gravit_tpu.render import tracer as jtracer
    from gravit_tpu.render import volume_scene as jvs
    from gravit_tpu.render import volume_tracer as jvt
    from gravit_tpu.scene import camera as jcamera
    from gravit_tpu.scene.volume import wavelet_volume as jwavelet
    from gravit_tpu_torch.render import tracer, volume_tracer
    from gravit_tpu_torch.render.volume_scene import build_volume_scene
    from gravit_tpu_torch.scene import camera
    from gravit_tpu_torch.scene.volume import wavelet_volume

    eye4 = np.eye(4, dtype=np.float32)
    jscene = jvs.build_volume_scene([jwavelet(VOL_N)], [(0, eye4)])
    jarena = jtracer.make_arena(
        _volume_camera(jcamera).generate_rays(volume=True), 0)

    def jf(samples):
        fb = jvt.trace_volume(jscene.replace(vol_samples=(samples,)),
                              jarena, VOL_FILM, VOL_FILM, max_rounds=4,
                              unroll=True)
        return jnp.sum(fb[:, :3])

    s0 = np.asarray(jscene.vol_samples[0])
    ref = np.asarray(jax.grad(jf)(jnp.asarray(s0)))

    scene = build_volume_scene([wavelet_volume(VOL_N)], [(0, eye4)],
                               device="cpu")
    arena = tracer.make_arena(
        _volume_camera(camera).generate_rays("cpu", volume=True), 0)
    np.testing.assert_array_equal(scene.vol_samples[0].numpy(), s0)

    def f(samples):
        fb = volume_tracer.trace_volume(
            dataclasses.replace(scene, vol_samples=(samples,)), arena,
            VOL_FILM, VOL_FILM, max_rounds=4, unroll=True)
        return fb[:, :3].sum()

    s = torch.as_tensor(s0).requires_grad_(True)
    g, = torch.autograd.grad(f(s), s)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    assert _rel(g, ref) < 5e-5
    d = torch.as_tensor(np.random.default_rng(0).standard_normal(
        s0.shape).astype(np.float32))
    eps = 1e-2
    with torch.no_grad():
        fd = (float(f(s + eps * d)) - float(f(s - eps * d))) / (2 * eps)
    np.testing.assert_allclose(float((torch.as_tensor(g) * d).sum()), fd,
                               rtol=0.1)


def test_slice_march_reference_grads():
    """test_gradients.py::test_slice_march_reference_grads on the port,
    and against jax.grad: the plain slice march's image sum wrt the brick's
    samples AND the colour LUT. Finite, nonzero, each directional
    derivative within rtol 0.1 of central differences (eps 1e-2), and
    the gradients within 5e-5 (samples) and 2e-4 (LUT) relative in the
    2-norm of JAX's (measured 9.5e-6 and 4.8e-5: a LUT entry's gradient
    sums the lerp weights of every plane of every ray that reads it, in
    another order)."""
    import jax
    import jax.numpy as jnp

    from gravit_tpu.ops import slice_march as jsm
    from gravit_tpu.scene import camera as jcamera
    from gravit_tpu.scene.volume import wavelet_volume as jwavelet
    from gravit_tpu_torch.ops import slice_march as sm

    vol = jwavelet(VOL_N)
    rays = _volume_camera(jcamera).generate_rays(volume=True)
    o, d = np.asarray(rays.origin), np.asarray(rays.direction)
    n = o.shape[0]
    axis, flip = jsm.choose_slice_axis(d.mean(0))
    assert (axis, flip) == sm.choose_slice_axis(d.mean(0))
    meta = dict(axis=axis, flip=flip, step=float(vol.step_size()),
                base_step=float(vol.spacing.min()),
                low=float(vol.tf.low), high=float(vol.tf.high),
                origin=tuple(float(x) for x in vol.origin),
                spacing=tuple(float(x) for x in vol.spacing))
    s0 = np.asarray(vol.samples, np.float32)
    c0 = np.asarray(vol.tf.color_lut, np.float32)
    ol = np.asarray(vol.tf.opacity_lut, np.float32)

    def jf(S, cl):
        c, w, _ = jsm.slice_march_reference(
            o, d, jnp.ones((n,), bool), jnp.zeros((n, 3)), jnp.zeros((n,)),
            S, cl, jnp.asarray(ol), **meta)
        return jnp.sum(c * w[:, None])

    ref_s, ref_c = (np.asarray(x) for x in jax.grad(jf, argnums=(0, 1))(
        jnp.asarray(s0), jnp.asarray(c0)))

    def f(S, cl):
        c, w, _ = sm.slice_march_reference(
            torch.as_tensor(o), torch.as_tensor(d),
            torch.ones((n,), dtype=torch.bool), torch.zeros((n, 3)),
            torch.zeros((n,)), S, cl, torch.as_tensor(ol), **meta)
        return (c * w[:, None]).sum()

    S = torch.as_tensor(s0).requires_grad_(True)
    C = torch.as_tensor(c0).requires_grad_(True)
    g_s, g_c = torch.autograd.grad(f(S, C), (S, C))
    for got, ref, tol in ((g_s.numpy(), ref_s, 5e-5),
                          (g_c.numpy(), ref_c, 2e-4)):
        assert np.isfinite(got).all() and np.abs(got).sum() > 0
        assert _rel(got, ref) < tol
    eps = 1e-2
    rng = np.random.default_rng(3)
    dS = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    dC = torch.as_tensor(rng.standard_normal(c0.shape).astype(np.float32))
    with torch.no_grad():
        S0, C0 = S.detach(), C.detach()
        fd_s = (float(f(S0 + eps * dS, C0))
                - float(f(S0 - eps * dS, C0))) / (2 * eps)
        fd_c = (float(f(S0, C0 + eps * dC))
                - float(f(S0, C0 - eps * dC))) / (2 * eps)
    np.testing.assert_allclose(float((g_s * dS).sum()), fd_s, rtol=0.1)
    np.testing.assert_allclose(float((g_c * dC).sum()), fd_c, rtol=0.1)
