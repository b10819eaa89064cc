"""The closest-instance search (gravit_tpu_torch/ops/instance_slab.py) on
the CPU: its plain version against the JAX package's `_next_instance` scan
and against the port's former Python loop, its gradient, the volume
tracer's search against the broadcast it replaces, and the spans that show
which search a frame ran.

Bit-equal throughout: every slab test is a subtraction and a product per
axis followed by min / max and compares, so the JAX loop, the loop and the
(n, I, 3) broadcast compute the same floats, and argmin's first minimum is
the loop's strict-< tie-break. Gradients between the port's two forms are
bit-equal (the same chain of ops); against JAX they are held to 2e-6
relative, since JAX differentiates 1 / d as a quotient and PyTorch as a
reciprocal, which round differently.
"""

import math
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gravit_tpu.render import tracer as jax_tracer  # noqa: E402

from gravit_tpu_torch.core import timing  # noqa: E402
from gravit_tpu_torch.core.rays import FLT_MAX, RAY_EPSILON  # noqa: E402
from gravit_tpu_torch.ops import instance_slab as slab  # noqa: E402
from gravit_tpu_torch.render import tracer  # noqa: E402
from gravit_tpu_torch.render import volume_tracer as vt  # noqa: E402
from gravit_tpu_torch.render.scene_build import build_scene  # noqa: E402
from gravit_tpu_torch.render.volume_scene import build_volume_scene  # noqa: E402
from gravit_tpu_torch.scene.camera import PerspectiveCamera  # noqa: E402
from gravit_tpu_torch.scene.transfer import TransferFunction  # noqa: E402
from gravit_tpu_torch.scene.volume import Volume  # noqa: E402
from portbench.scenes import rt_wavelet  # noqa: E402

torch.set_num_threads(2)
F32 = np.float32
EPS32 = F32(RAY_EPSILON)


def loop_search(lo, hi, origin, direction, t_max, prev):
    """The port's search before closest_box: a Python loop over the boxes
    with a running strict-< minimum, the JAX function's form."""
    inv_dir = slab.inverse_direction(direction)
    n = origin.shape[0]
    best_t = torch.full((n,), FLT_MAX)
    best_i = torch.zeros((n,), dtype=torch.int32)
    for i in range(lo.shape[0]):
        tn = torch.full((n,), -FLT_MAX)
        tf = torch.full((n,), FLT_MAX)
        for ax in range(3):
            a = (lo[i, ax] - origin[:, ax]) * inv_dir[:, ax]
            b = (hi[i, ax] - origin[:, ax]) * inv_dir[:, ax]
            tn = torch.maximum(tn, torch.minimum(a, b))
            tf = torch.minimum(tf, torch.maximum(a, b))
        hit_i = (tf > tn) & (tn > RAY_EPSILON) & (tn < t_max) & (prev != i)
        closer = hit_i & (tn < best_t)
        best_t = torch.where(closer, tn, best_t)
        best_i = torch.where(closer, i, best_i)
    return best_t < FLT_MAX, best_i, best_t


def volume_broadcast(lo, hi, origin, direction, t_max, exclude):
    """The volume tracer's search before closest_box, as it was written."""
    small = torch.abs(direction) < 1e-30
    d_safe = torch.where(small, 1.0, direction)
    inv_dir = torch.where(small, torch.where(direction < 0, -1e30, 1e30),
                          1.0 / d_safe)
    a = (lo[None] - origin[:, None]) * inv_dir[:, None]
    b = (hi[None] - origin[:, None]) * inv_dir[:, None]
    tnear = torch.minimum(a, b).max(dim=-1).values
    tfar = torch.maximum(a, b).min(dim=-1).values
    ids = torch.arange(lo.shape[0])
    hit = ((tfar > tnear) & (tnear > RAY_EPSILON)
           & (tnear < t_max[:, None]) & (ids[None, :] != exclude[:, None]))
    tnear = torch.where(hit, tnear, FLT_MAX)
    nxt = torch.argmin(tnear, dim=1)
    t_entry = torch.gather(tnear, 1, nxt[:, None])[:, 0]
    return t_entry < FLT_MAX, nxt.to(torch.int32), t_entry


def jax_scene(lo, hi):
    return types.SimpleNamespace(inst_bvh=None, num_instances=lo.shape[0],
                                 inst_lo=jnp.asarray(lo),
                                 inst_hi=jnp.asarray(hi))


def jax_search(lo, hi, o, d, t_max, prev):
    out = jax_tracer._next_instance(
        jax_scene(lo, hi), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max), jnp.asarray(prev),
        jnp.ones(o.shape[0], dtype=bool))
    return tuple(np.asarray(a) for a in out)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def assert_same(got, want):
    for name, g, w in zip(("found", "nxt", "t_entry"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def random_case(num: int, n: int, seed: int):
    """`num` boxes, box 1 a copy of box 0 (where there are two), and n rays
    from inside and around them; a third of the lanes with a t_max that
    cuts some boxes off, a random `prev`."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5, 4, (num, 3)).astype(F32)
    hi = (lo + rng.uniform(0.2, 2.0, (num, 3))).astype(F32)
    if num > 1:
        lo[1], hi[1] = lo[0], hi[0]
    o = rng.uniform(-7, 7, (n, 3)).astype(F32)
    # aim half the rays at a box's centre, so that most of them hit
    aim = (lo + hi)[rng.integers(0, num, n)] * F32(0.5)
    d = np.where(rng.random((n, 1)) < 0.5, aim - o,
                 rng.normal(size=(n, 3))).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8, 1:] = 0.0                            # axis-aligned: inv_dir 1e30
    t_max = np.where(rng.random(n) < 0.3, F32(4.0), F32(FLT_MAX)).astype(F32)
    prev = rng.integers(-1, num, n).astype(np.int32)
    return lo, hi, o, d.astype(F32), t_max, prev


@pytest.mark.parametrize("num", [1, 8, 25, 63])
def test_plain_equals_jax_and_the_loop(num):
    lo, hi, o, d, t_max, prev = random_case(num, 2048, seed=num)
    want = jax_search(lo, hi, o, d, t_max, prev)
    got = slab.closest_box(*tensors(lo, hi, o, d, t_max, prev))
    assert_same(got, want)
    assert_same(loop_search(*tensors(lo, hi, o, d, t_max, prev)), want)
    assert got[0].sum() > 300
    # `prev` on the winner: the next closest box, or none
    prev2 = np.where(want[0], want[1], prev).astype(np.int32)
    want2 = jax_search(lo, hi, o, d, t_max, prev2)
    assert_same(slab.closest_box(*tensors(lo, hi, o, d, t_max, prev2)),
                want2)
    assert not np.any(want2[0] & (want2[1] == prev2))
    if num > 1:
        # box 1 is box 0: wherever it would win, box 0 wins first
        assert not np.any(want[0] & (want[1] == 1) & (prev != 0))


def _ulps(x, k):
    x = F32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, F32(np.inf if k > 0 else -np.inf), dtype=F32)
    return x


def edge_case(name: str):
    """(lo, hi, o, d, t_max, prev, expected (found, nxt) or None)."""
    box = lambda *rows: np.array(rows, F32)  # noqa: E731
    if name == "coincident":
        # boxes 0 and 2 are one box, box 3 shares their entry face: every
        # ray enters all three at x = 1; the first index wins
        lo = box([1, -1, -1], [5, -1, -1], [1, -1, -1], [1, -1, -1])
        hi = box([2, 1, 1], [6, 1, 1], [2, 1, 1], [3, 1, 1])
        rng = np.random.default_rng(1)
        yz = rng.uniform(-0.5, 0.5, (64, 2)).astype(F32)
        o = np.concatenate([np.zeros((64, 1), F32), yz], axis=1)
        d = np.concatenate([np.ones((64, 1), F32),
                            F32(0.1) * yz[::-1]], axis=1).astype(F32)
        prev = np.repeat(np.array([-1, 0, 2, 1], np.int32), 16)
        expect = np.repeat([0, 2, 0, 0], 16)
        return lo, hi, o, d, np.full(64, FLT_MAX, F32), prev, (
            np.ones(64, bool), expect)
    if name == "ray_epsilon":
        # the entry distance is lo_x itself (o = 0, d = x): tn at
        # RAY_EPSILON fails, one ulp above passes
        lo = np.array([[_ulps(EPS32, -1), -1, -1], [EPS32, -1, -1],
                       [_ulps(EPS32, 1), -1, -1]], F32)
        hi = box([2, 1, 1], [2, 1, 1], [2, 1, 1])
        o = np.zeros((3, 3), F32)
        d = np.tile(np.array([1, 0, 0], F32), (3, 1))
        prev = np.array([-1, 2, 1], np.int32)
        return lo, hi, o, d, np.full(3, FLT_MAX, F32), prev, (
            np.array([True, False, True]), np.array([2, 0, 2]))
    if name == "t_max":
        lo, hi = box([2, -1, -1]), box([3, 1, 1])
        o = np.zeros((3, 3), F32)
        d = np.tile(np.array([1, 0, 0], F32), (3, 1))
        t_max = np.array([2, _ulps(2, 1), _ulps(2, -1)], F32)
        return lo, hi, o, d, t_max, np.full(3, -1, np.int32), (
            np.array([False, True, False]), np.zeros(3, int))
    if name == "tiny_direction":
        # |d| < 1e-30 on y and z of both signs (and of both zeros); 1e-30
        # itself is not tiny. Origins inside, on and outside the y slab.
        lo, hi = box([1, 0, 0]), box([2, 1, 1])
        dys = np.array([1e-31, -1e-31, 0.0, -0.0, 1e-30, -1e-30], F32)
        oys = np.array([0.5, 0.0, 1.0, 1.5, -0.5], F32)
        d = np.array([[1, dy, -dy] for dy in dys for _ in oys], F32)
        o = np.array([[0, oy, 0.5] for _ in dys for oy in oys], F32)
        n = d.shape[0]
        return lo, hi, o, d, np.full(n, FLT_MAX, F32), np.full(
            n, -1, np.int32), None
    if name == "nan_inf":
        # NaN or infinite origins and directions: no box is hit
        lo, hi = box([1, 0, 0], [3, -1, -1]), box([2, 1, 1], [4, 2, 2])
        nan, inf = F32(np.nan), F32(np.inf)
        o = np.array([[nan, 0.5, 0.5], [0, nan, 0.5], [0, 0.5, nan],
                      [inf, 0.5, 0.5], [-inf, 0.5, 0.5], [0, inf, 0.5],
                      [0, -inf, 0.5], [0, 0.5, 0.5], [0, 0.5, 0.5],
                      [0, 0.5, 0.5]], F32)
        d = np.array([[1, 0.01, 0.01]] * 7 + [[nan, 0, 0], [1, inf, 0],
                                             [inf, 0, 0]], F32)
        n = o.shape[0]
        return lo, hi, o, d, np.full(n, FLT_MAX, F32), np.full(
            n, -1, np.int32), (np.zeros(n, bool), np.zeros(n, int))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["coincident", "ray_epsilon", "t_max",
                                  "tiny_direction", "nan_inf"])
def test_edges_equal_jax_and_the_loop(name):
    lo, hi, o, d, t_max, prev, expect = edge_case(name)
    want = jax_search(lo, hi, o, d, t_max, prev)
    got = slab.closest_box(*tensors(lo, hi, o, d, t_max, prev))
    assert_same(got, want)
    assert_same(loop_search(*tensors(lo, hi, o, d, t_max, prev)), want)
    if expect is not None:
        np.testing.assert_array_equal(want[0], expect[0])
        np.testing.assert_array_equal(want[1], expect[1])
    # a lane that finds nothing reads (False, 0, FLT_MAX)
    miss = ~want[0]
    assert np.all(want[1][miss] == 0) and np.all(want[2][miss] == FLT_MAX)
    if name == "tiny_direction":
        # inside the y slab every ray hits, outside none; on a face the
        # sign of the tiny component decides
        assert 0 < want[0].sum() < want[0].size


def test_empty_wavefront():
    lo, hi, o, d, t_max, prev = random_case(8, 16, seed=2)
    found, nxt, t = slab.closest_box(*tensors(lo, hi, o[:0], d[:0],
                                              t_max[:0], prev[:0]))
    assert found.shape == nxt.shape == t.shape == (0,)


def _grads(search, lo, hi, o, d, t_max, prev, w):
    ot, dt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (o, d))
    lt, ht, tt, pt = tensors(lo, hi, t_max, prev)
    found, _, t = search(lt, ht, ot, dt, tt, pt)
    (torch.where(found, t, 0.0) * torch.from_numpy(w)).sum().backward()
    return t.detach().numpy(), ot.grad.numpy(), dt.grad.numpy()


def _jax_grads(lo, hi, o, d, t_max, prev, w):
    def loss(o, d):
        found, _, t = jax_tracer._next_instance(
            jax_scene(lo, hi), o, d, jnp.asarray(t_max), jnp.asarray(prev),
            jnp.ones(o.shape[0], dtype=bool))
        return (jnp.where(found, t, 0.0) * w).sum()
    go, gd = jax.grad(loss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    return np.asarray(go), np.asarray(gd)


def tie_case():
    """Rays that enter the unit box on its x = 0 / y = 0 edge: the x and y
    entry distances tie, and the gradient splits between them."""
    lo, hi = np.zeros((1, 3), F32), np.ones((1, 3), F32)
    o = np.array([[-1, -1, 0.5], [-2, -2, 0.25], [-0.5, -0.5, 0.75]], F32)
    d = np.array([[1, 1, 0], [2, 2, 0.1], [0.5, 0.5, -0.2]], F32)
    return lo, hi, o, d, np.full(3, FLT_MAX, F32), np.full(3, -1, np.int32)


@pytest.mark.parametrize("case", ["tie", "random"])
def test_t_entry_gradient(case):
    """Where autograd records, t_entry is recomputed from the winner's box
    by the loop's chain: the loop's values and gradients exactly (the tie
    split in half between the axes), JAX's to 2e-6."""
    if case == "tie":
        lo, hi, o, d, t_max, prev = tie_case()
    else:
        lo, hi, o, d, t_max, prev = random_case(25, 512, seed=5)
    w = np.random.default_rng(3).uniform(0.5, 1.5, o.shape[0]).astype(F32)
    t, go, gd = _grads(slab.closest_box, lo, hi, o, d, t_max, prev, w)
    t_l, go_l, gd_l = _grads(loop_search, lo, hi, o, d, t_max, prev, w)
    np.testing.assert_array_equal(t, t_l)
    np.testing.assert_array_equal(go, go_l)
    np.testing.assert_array_equal(gd, gd_l)
    # with no gradient recorded the kernel's t_entry is the same
    np.testing.assert_array_equal(
        t, slab.closest_box(*tensors(lo, hi, o, d, t_max, prev))[2].numpy())
    jo, jd = _jax_grads(lo, hi, o, d, t_max, prev, w)
    np.testing.assert_allclose(go, jo, rtol=2e-6, atol=0)
    np.testing.assert_allclose(gd, jd, rtol=2e-6, atol=0)
    if case == "tie":
        # d t / d o_x = -inv_x / 2 = -w / (2 d_x): half of each axis
        np.testing.assert_array_equal(go[:, 0], go[:, 1])
        np.testing.assert_allclose(go[:, 0], -w / (2 * d[:, 0]), rtol=1e-6)
        assert np.all(go[:, 2] == 0)
    else:
        assert np.count_nonzero(go) > 100


@pytest.mark.parametrize("exclude", ["none", "prev", "winner"])
def test_volume_search_equals_the_broadcast(exclude):
    """_instance_bvh_hit through closest_box, bit-equal to the broadcast it
    replaces, over eight bricks of 2x2x2 with shared faces."""
    corners = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                       axis=-1).reshape(-1, 3).astype(F32) * F32(256) - 256
    lo, hi = corners, corners + F32(256)
    _, _, o, d, t_max, prev = random_case(8, 4096, seed=11)
    o = o * F32(100)
    if exclude == "none":
        prev = np.full_like(prev, -1)
    elif exclude == "winner":
        prev = volume_broadcast(*tensors(lo, hi, o, d, t_max, prev))[1]
        prev = prev.numpy()
    scene = types.SimpleNamespace(**dict(zip(("inst_lo", "inst_hi"),
                                             tensors(lo, hi))))
    ot, dt, tt, pt = tensors(o, d, t_max, prev)
    arena = types.SimpleNamespace(origin=ot, direction=dt, t_max=tt)
    want = volume_broadcast(*tensors(lo, hi), ot, dt, tt, pt)
    assert_same(vt._instance_bvh_hit(scene, arena, pt), want)
    assert want[0].sum() > 500


def test_checks():
    lo, hi, o, d, t_max, prev = tensors(*random_case(8, 32, seed=4))
    with pytest.raises(ValueError, match="impl"):
        slab.closest_box(lo, hi, o, d, t_max, prev, impl="fast")
    with pytest.raises(ValueError, match="CUDA"):
        slab.closest_box_kernel(lo, hi, o, d, t_max, prev)
    with pytest.raises(ValueError, match="exclude"):
        slab.closest_box(lo, hi, o, d, t_max, prev.long())
    with pytest.raises(ValueError, match="origin"):
        slab.closest_box(lo, hi, o[:, :2], d, t_max, prev)


def _small_volume():
    field = rt_wavelet.scene((-8, 7), (8, 8, 8))
    tf = TransferFunction.gray_ramp(field.low, field.high, 0.05)
    volumes = [Volume(samples=b.samples, origin=b.origin,
                      spacing=np.ones(3, np.float32), tf=tf)
               for b in field.bricks]
    scene = build_volume_scene(volumes, [(i, np.eye(4, dtype=np.float32))
                                         for i in range(len(volumes))],
                               device="cpu")
    cam = PerspectiveCamera(eye=(30.0, 20.0, 40.0), focus=(0.0, 0.0, 0.0),
                            up=(0.0, 1.0, 0.0), fov=math.radians(30.0),
                            film_width=16, film_height=16)
    rays = cam.generate_rays("cpu", volume=True)
    return scene, rays


@pytest.mark.parametrize("frame", ["fast_multi", "looped", "tree", "volume"])
def test_engagement_spans(frame):
    """`tracer.instance_slab` counts the searches made by closest_box: one
    in every instance search of a SimpleApp or volume frame, none where the
    scene holds an instance tree."""
    timing.clear()
    if frame == "volume":
        scene, rays = _small_volume()
        with timing.recording() as rec:
            fb = vt.trace_volume(scene, tracer.make_arena(rays, 0), 16, 16,
                                 slice_axes=vt.slice_axes_for(
                                     scene, rays.direction))
        parent = "volume.instance_search"
    else:
        spec = chip_smoke.simple_app(32, 32)
        scene = build_scene(spec.meshes, spec.instances, spec.lights,
                            device="cpu", instance_bvh=frame == "tree")
        rays = spec.camera.generate_rays("cpu")
        with timing.recording() as rec:
            if frame == "fast_multi":
                fb = tracer.trace_image_fast_multi(scene, rays, 32, 32)
            else:
                fb = tracer.trace_image(scene, tracer.make_arena(rays, 1),
                                        32, 32, max_rounds=16)
        parent = "tracer.instance_search"
    spans = rec.spans()
    names = [s.name for s in spans]
    searches = names.count(parent)
    slabs = [s for s in spans if s.name == "tracer.instance_slab"]
    assert searches > 1 and float(fb[:, :3].sum()) > 0
    assert len(slabs) == (0 if frame == "tree" else searches)
    assert all(names[s.parent - rec.since] == parent for s in slabs)
    timing.clear()
