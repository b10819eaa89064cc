"""The port's volume tracers (gravit_tpu_torch/render/volume_tracer.py and
render_volume) against the JAX package's, on the CPU.

Both packages render the same procedural scenes (chip_smoke.make_volume_scene)
from the JAX camera's rays; the JAX package runs its Pallas slice kernel in
interpret mode (or its reference twin where said). The cameras stand a
little off the brick's diagonal (eye = (4.4, 4, 4) n): on the diagonal the
three components of the mean direction are equal up to rounding, and which
axis the slice engine takes would be decided by noise.

Tolerances, and why:
- gates, filter_initial, shuffle_volume, make_arena: exact (comparisons,
  selects and one multiply-add per ray; the deposit sums no duplicate pixel).
- frames (render_volume against trace_volume_fast / trace_volume): float max
  <= 1e-5 on all but the event pixels counted below, and <= 0.1% of bytes
  differ. XLA's CPU backend contracts a*b+c into fused multiply-adds, the
  port rounds each operation (measured: <= 1.5e-6). A pixel whose ray
  saturates or crosses an isosurface one plane earlier on one side is an
  event pixel; they are counted and limited to 0.1% of the film.
- fast path against the wavefront tracer (two discretizations of one
  integral): mean < 2e-3, max < 0.05, the reference's own image tolerance.

Refresh the committed golden frames by hand (JAX only):
    JAX_PLATFORMS=cpu python tests/test_torch_volume_tracer.py --write-golden
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gravit_tpu.core.rays import RayArena as JaxArena  # noqa: E402
from gravit_tpu.render import tracer as jax_tracer  # noqa: E402
from gravit_tpu.render import volume_tracer as jvt  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.render import tracer  # noqa: E402
from gravit_tpu_torch.render import volume_tracer as tvt  # noqa: E402
from gravit_tpu_torch.render.renderer import render_volume  # noqa: E402
from gravit_tpu_torch.render.volume_scene import build_volume_scene  # noqa: E402
from gravit_tpu_torch.scene import image  # noqa: E402
from test_torch_volume_scene import (jax_camera, jax_volume_scene,  # noqa: E402
                                     port_scene_of, ray_leaves)

torch.set_num_threads(2)

EYE = (4.4, 4.0, 4.0)
GOLDEN_SPEC = dict(n=32, width=64, height=64, eye=np.asarray(EYE))
EYE4 = np.eye(4, dtype=np.float32)
D_DOWN = np.tile(np.array([[0.0, 0.0, -1.0]]), (8, 1))


def port_scene(kind="plain", n=16):
    spec = chip_smoke.make_volume_scene(kind, n=n, width=8, height=8)
    return build_volume_scene(spec.volumes, spec.instances, device="cpu")


def oversize(scene):
    """The scene with its brick replaced by one over SLAB_BYTES."""
    return scene.replace(vol_samples=(torch.zeros((160, 160, 160)),))


# ---------------------------------------------------------------------------
# gates (the cases of the reference's tests/test_slice_march.py)


def test_can_slice_march_gates():
    scene = port_scene()
    assert tvt.can_slice_march(scene, D_DOWN) == (True, 2, True)
    # a ray perpendicular to the dominant axis -> the gather march
    d_bad = np.concatenate([D_DOWN, np.array([[1.0, 0.0, 0.0]])])
    assert not tvt.can_slice_march(scene, d_bad)[0]
    # tensors are taken as well as arrays
    assert tvt.can_slice_march(scene, torch.tensor(D_DOWN))[0]
    # features ride the slice engine up to SLAB_BYTES and fall back above
    for featured in (scene.replace(vol_isovalues=((1.0,),)),
                     scene.replace(vol_slices=(((1.0, 0.0, 0.0, -1.0),),)),
                     port_scene("amr")):
        assert tvt.can_slice_march(featured, D_DOWN)[0]
        assert not tvt.can_slice_march(oversize(featured), D_DOWN)[0]
    # an oversize brick without features still marches (as windows)
    assert tvt.can_slice_march(oversize(scene), D_DOWN)[0]
    # two bricks: never the megapass
    assert not tvt.can_slice_march(port_scene("bricks"), D_DOWN)[0]
    assert not tvt.can_slice_march(scene.replace(vol_meta=()), D_DOWN)[0]


def test_features_on_slice_ok_counts_the_subgrids():
    scene = port_scene("amr")
    assert tvt._features_on_slice_ok(scene, 0)
    sub = scene.vol_subgrids[0][0]
    big_sub = (torch.zeros((104, 104, 104)),) + tuple(sub[1:])
    assert not tvt._features_on_slice_ok(
        scene.replace(vol_subgrids=((big_sub,),)), 0)


def test_slice_gate_runs_in_object_space():
    """A 90-degree rotation about y maps world-z rays onto the object
    x-axis: the gate must pick the dominant OBJECT axis, as JAX does."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    spec = chip_smoke.make_volume_scene("plain", n=16, width=8, height=8)
    spec.instances = [(0, m)]
    scene = build_volume_scene(spec.volumes, spec.instances, device="cpu")
    got = tvt.can_slice_march(scene, D_DOWN)
    assert got == jvt.can_slice_march(jax_volume_scene(spec), D_DOWN)
    assert got[0] and got[1] == 0


def test_sign_consistency_gate():
    scene = port_scene()
    d_mixed = np.concatenate([D_DOWN, np.array([[0.0, 0.0, 1.0]])])
    assert tvt.can_slice_march(scene, D_DOWN)[0]
    assert not tvt.can_slice_march(scene, d_mixed)[0]
    assert tvt._slice_gate([EYE4, EYE4], D_DOWN) == (True, 2, True)
    flipped = np.diag([1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    assert not tvt._slice_gate([EYE4, flipped], D_DOWN)[0]


def test_slice_axes_for():
    scene = port_scene("bricks", n=32)
    assert tvt.slice_axes_for(scene, D_DOWN) == ((2, True), (2, True))
    # feature tuples shorter than num_volumes must not raise
    short_sl = scene.replace(vol_slices=(((1.0, 0.0, 0.0, -1.0),),))
    assert all(a is not None for a in tvt.slice_axes_for(short_sl, D_DOWN))
    short_iso = scene.replace(vol_isovalues=((1.0,),))
    assert all(a is not None for a in tvt.slice_axes_for(short_iso, D_DOWN))
    # an oversize featured brick keeps the gather march, its neighbour not
    big = short_iso.replace(vol_samples=(torch.zeros((160, 160, 160)),
                                         scene.vol_samples[1]))
    assert tvt.slice_axes_for(big, D_DOWN) == (None, (2, True))
    d_bad = np.concatenate([D_DOWN, np.array([[1.0, 0.0, 0.0]])])
    assert tvt.slice_axes_for(scene, d_bad) == (None, None)
    assert tvt.slice_axes_for(scene.replace(vol_meta=()), D_DOWN) == ()
    # the stacked per-device form (schedule/volume_domain.py): a leading
    # device axis; a brick is used where ANY device's instance uses it
    stacked = scene.replace(inst_minv=scene.inst_minv[None].expand(2, -1, -1,
                                                                   -1),
                            inst_vol=torch.tensor([[0, -1], [-1, 1]]))
    assert tvt.slice_axes_for(stacked, D_DOWN) == ((2, True), (2, True))
    assert tvt.slice_axes_for(stacked, d_bad) == (None, None)


# ---------------------------------------------------------------------------
# the wavefront's pieces on a seeded arena


def seeded_arena(n_rays=2048, w=16, h=16, seed=41):
    """Rays around the two-brick scene, in every queue state."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-40.0, 70.0, (n_rays, 3))
    d = rng.uniform(0.0, 31.0, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32, 1:] = 0.0                                   # axis-parallel rays
    flags = rng.choice([0, 2, 4, 6, 16], n_rays)
    return dict(
        origin=o.astype(np.float32), direction=d.astype(np.float32),
        color=rng.uniform(0, 1, (n_rays, 3)).astype(np.float32),
        t_max=np.where(rng.uniform(size=n_rays) < 0.1, 30.0,
                       np.finfo(np.float32).max).astype(np.float32),
        t=np.ones(n_rays, np.float32),
        w=rng.uniform(0, 1, n_rays).astype(np.float32),
        id=rng.permutation(w * h * 8)[:n_rays].astype(np.int32) % (w * h),
        depth=flags.astype(np.int32),
        type=rng.choice([1, 1, 1, 2], n_rays).astype(np.int32),
        inst=rng.integers(-1, 2, n_rays).astype(np.int32),
        prev=rng.integers(-1, 2, n_rays).astype(np.int32),
        active=rng.uniform(size=n_rays) < 0.8)


def assert_arenas_equal(tarena, jarena):
    for name, ref in ray_leaves(jarena).items():
        np.testing.assert_array_equal(getattr(tarena, name).numpy(), ref,
                                      err_msg=name)


def test_filter_initial_matches_jax():
    spec = chip_smoke.make_volume_scene("bricks", n=32, width=16, height=16)
    jscene = jax_volume_scene(spec)
    arrays = seeded_arena()
    ja = jvt.filter_initial(
        jscene, JaxArena(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    ta = tvt.filter_initial(port_scene_of(jscene),
                            interop.rays_from_numpy(arrays, "cpu"))
    assert_arenas_equal(ta, ja)
    assert (np.asarray(ja.inst) != arrays["inst"]).sum() > 100


def test_shuffle_volume_matches_jax():
    """Exact but for the deposit, which sums duplicate pixels in another
    order: float max |d| <= 1e-6."""
    spec = chip_smoke.make_volume_scene("bricks", n=32, width=16, height=16)
    jscene = jax_volume_scene(spec)
    arrays = seeded_arena(seed=42)
    fb0 = np.random.default_rng(43).uniform(0, 0.3, (256, 4)).astype(
        np.float32)
    ja, jfb = jvt.shuffle_volume(
        jscene, JaxArena(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(fb0))
    ta, tfb = tvt.shuffle_volume(port_scene_of(jscene),
                                 interop.rays_from_numpy(arrays, "cpu"),
                                 torch.tensor(fb0))
    assert_arenas_equal(ta, ja)
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=1e-6,
                               rtol=0)
    assert (np.asarray(ja.depth) & 16).sum() > 0          # externals appear
    assert not np.array_equal(np.asarray(jfb), fb0)       # something landed
    assert (np.asarray(ja.inst) >= 0).sum() > 0           # and some requeue


def test_make_arena_matches_jax():
    spec = chip_smoke.make_volume_scene("plain", n=16, width=24, height=20)
    jrays = jax_camera(spec.camera).generate_rays(volume=True)
    trays = interop.rays_from_numpy(ray_leaves(jrays), "cpu")
    for lights in (0, 2):
        ja = jax_tracer.make_arena(jrays, lights)
        ta = tracer.make_arena(trays, lights)
        assert ta.capacity == ja.capacity and ta.capacity % 1024 == 0
        assert_arenas_equal(ta, ja)


# ---------------------------------------------------------------------------
# the slice as a whole


def frame_diff(a, b, w, h) -> dict:
    ba, bb = image.to_rgb8(a, w, h), image.to_rgb8(b, w, h)
    d = np.abs(a[:, :3] - b[:, :3]).max(axis=1)
    return dict(byte_frac=float(np.mean(ba != bb)),
                event_frac=float(np.mean(d > 1e-5)),
                float_max=float(d.max()), float_mean=float(d.mean()),
                rest_max=float(d[d <= 1e-5].max()))


def assert_frames_match(got, ref, w, h):
    diff = frame_diff(got, ref, w, h)
    assert diff["event_frac"] <= 1e-3, diff
    assert diff["byte_frac"] <= 1e-3, diff
    assert (ref[:, :3].sum(axis=1) > 0).mean() > 0.1, "nothing was rendered"
    assert np.isfinite(got).all()


def jax_frame(spec, engine: str = "auto"):
    """The JAX package's frame of `spec`: the megapass where its gate
    allows, else the wavefront tracer (engine "march": the gather march
    serves every brick)."""
    scene = jax_volume_scene(spec)
    cam = spec.camera
    rays = jax_camera(cam).generate_rays(volume=True)
    ok, axis, flip = jvt.can_slice_march(scene, rays.direction)
    if ok and engine == "auto":
        return np.asarray(jvt.trace_volume_fast(
            scene, rays, cam.film_width, cam.film_height, axis=axis,
            flip=flip, interpret=True))
    saxes = jvt.slice_axes_for(scene, rays.direction) \
        if engine == "auto" else ()
    return np.asarray(jvt.trace_volume(
        scene, jax_tracer.make_arena(rays, 0), cam.film_width,
        cam.film_height, max_rounds=8, slice_axes=saxes,
        slice_interpret=True))


@pytest.mark.parametrize("kind", ["plain", "iso"])
def test_render_volume_matches_jax_fast_path(kind):
    spec = chip_smoke.make_volume_scene(kind, n=32, width=24, height=24,
                                        eye=EYE)
    got = render_volume(spec.volumes, spec.instances, spec.camera,
                        device="cpu").numpy()
    assert_frames_match(got, jax_frame(spec), 24, 24)
    if kind == "iso":
        plain = chip_smoke.make_volume_scene("plain", n=32, width=24,
                                             height=24, eye=EYE)
        base = render_volume(plain.volumes, plain.instances, plain.camera,
                             device="cpu").numpy()
        assert np.abs(base - got).max() > 0.05         # the surface shows


@pytest.mark.parametrize("engine", ["slice", "march"])
def test_wavefront_matches_jax_on_two_bricks(engine):
    """The two-brick scene through trace_volume: the slice engine under
    march_round (render_volume's choice), and the gather march for both
    bricks (slice_axes=())."""
    spec = chip_smoke.make_volume_scene("bricks", n=32, width=24, height=24,
                                        eye=EYE)
    if engine == "slice":
        got = render_volume(spec.volumes, spec.instances, spec.camera,
                            device="cpu").numpy()
        ref = jax_frame(spec)
    else:
        scene = build_volume_scene(spec.volumes, spec.instances, device="cpu")
        arena = tracer.make_arena(spec.camera.generate_rays("cpu",
                                                            volume=True), 0)
        got = tvt.trace_volume(scene, arena, 24, 24, max_rounds=8).numpy()
        ref = jax_frame(spec, engine="march")
    assert_frames_match(got, ref, 24, 24)


def test_fast_path_agrees_with_the_wavefront_tracer():
    """Port only: the megapass against the gather-march wavefront tracer,
    and the unrolled (gradient) form of the loop against the early-exit
    form, which must not differ at all."""
    spec = chip_smoke.make_volume_scene("plain", n=32, width=24, height=24,
                                        eye=EYE)
    scene = build_volume_scene(spec.volumes, spec.instances, device="cpu")
    rays = spec.camera.generate_rays("cpu", volume=True)
    ok, axis, flip = tvt.can_slice_march(scene, rays.direction)
    assert ok
    fast = tvt.trace_volume_fast(scene, rays, 24, 24, axis=axis, flip=flip)
    auto = tvt.trace_volume_fast(scene, rays, 24, 24)     # axis from the mean
    twin = tvt.trace_volume_fast(scene, rays, 24, 24, impl="plain")
    np.testing.assert_array_equal(auto.numpy(), fast.numpy())
    np.testing.assert_array_equal(twin.numpy(), fast.numpy())
    arena = tracer.make_arena(rays, 0)
    wave = tvt.trace_volume(scene, arena, 24, 24, max_rounds=8)
    err = (fast[:, :3] - wave[:, :3]).abs()
    assert float(err.mean()) < 2e-3 and float(err.max()) < 0.05
    assert int((fast[:, :3].sum(dim=1) > 0).sum()) > 20
    unrolled = tvt.trace_volume(scene, arena, 24, 24, max_rounds=3,
                                unroll=True)
    np.testing.assert_array_equal(unrolled.numpy(), wave.numpy())


def test_trace_volume_fast_refuses_other_scenes():
    scene = port_scene("bricks")
    rays = chip_smoke.make_volume_scene(
        "plain", n=16, width=8, height=8).camera.generate_rays(
            "cpu", volume=True)
    with pytest.raises(ValueError):
        tvt.trace_volume_fast(scene, rays, 8, 8)
    with pytest.raises(ValueError):
        tvt.trace_volume_fast(oversize(port_scene("iso")), rays, 8, 8)
    with pytest.raises(ValueError):
        tvt.trace_volume_fast(port_scene(), rays, 8, 8, impl="triton")


def test_render_volume_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = chip_smoke.make_volume_scene("plain", n=8, width=8, height=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_volume(spec.volumes, spec.instances, spec.camera)


# ---------------------------------------------------------------------------
# golden frames


def golden_spec(kind: str, spec: dict = GOLDEN_SPEC):
    return chip_smoke.make_volume_scene(
        kind, n=int(spec["n"]), width=int(spec["width"]),
        height=int(spec["height"]),
        eye=tuple(float(x) for x in np.asarray(spec["eye"])))


def write_golden(path=chip_smoke.VOLUME_GOLDEN) -> None:
    """Write the JAX package's CPU frames of the five volume scenes (64^2,
    32^3 brick; the slice kernel in interpret mode); chip_smoke.py holds
    the card's frames against them."""
    path.parent.mkdir(parents=True, exist_ok=True)
    frames = {f"fb_{kind}": jax_frame(golden_spec(kind))
              for kind in chip_smoke.VOLUME_KINDS}
    np.savez_compressed(path, **frames, **GOLDEN_SPEC)


@pytest.mark.parametrize("kind", chip_smoke.VOLUME_KINDS)
def test_volume_golden_frames(kind):
    """The port's CPU frame through render_volume against the committed JAX
    frame; for the plain frame JAX must also still produce it bit for
    bit."""
    gold = np.load(chip_smoke.VOLUME_GOLDEN)
    spec = golden_spec(kind, gold)
    w, h = spec.camera.film_width, spec.camera.film_height
    ref = gold[f"fb_{kind}"]
    if kind == "plain":
        np.testing.assert_array_equal(jax_frame(spec), ref)
    got = render_volume(spec.volumes, spec.instances, spec.camera,
                        device="cpu").numpy()
    assert_frames_match(got, ref, w, h)
    d = np.abs(ref - gold["fb_plain"])[:, :3]
    if kind == "bricks":        # the same field, split in two
        assert 0 < d.mean() < 2e-3
    elif kind != "plain":       # the feature shows in the committed frame
        assert d.max() > 0.02


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", chip_smoke.VOLUME_GOLDEN)
