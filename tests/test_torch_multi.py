"""The port's multi-instance and looped surface tracers against the JAX
package's, on the CPU: trace_image_fast_multi, trace_image and
render_surface on the cube row of
tests/test_fast_multi.py (point light; point + ambient; area + point),
SimpleApp (tiled and untiled), a 64-instance scene on the instance tree, a
looped depth-2 scene and a 9-mesh scene on the segment-aligned pack; the
looped tracer's arena pieces (_append_rays, _live_first_sel, the "drop"
scatters) on seeded arenas.

Tolerances against JAX (torch_parity.assert_multi_close): float |d| <= 1e-5
on >= 99.9% of pixels, mean |d| <= 1e-4, <= 0.5% of bytes differing. XLA's
CPU backend contracts a*b+c into fused multiply-adds and the port rounds
each operation, so a bumped origin (t_entry * 0.95) or a shading sum can
move by an ulp and turn a grazing hop (measured on these scenes: float max
2.1e-7 on SimpleApp at 32^2). The arena pieces are integer logic and
copies: equal.

The port's own contract, as the JAX package's (tests/test_fast_multi.py):
fast-multi equals the looped tracer bit for bit with one point light, and
within 3e-7 with equal bytes with two lights or an area light (a pixel's
two shadow rays can retire in different looped rounds, so their deposits
associate differently).

Refresh the committed golden frames by hand (JAX only):
    JAX_PLATFORMS=cpu python tests/test_torch_multi.py --write-golden
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.core.rays import RayArena as JaxArena
from gravit_tpu.render import tracer as jax_tracer

from gravit_tpu_torch import interop
from gravit_tpu_torch.core.math3d import mat4_translate_scale
from gravit_tpu_torch.core import timing
from gravit_tpu_torch.core.timing import count_rays
from gravit_tpu_torch.render import tracer
from gravit_tpu_torch.render.renderer import render_surface
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import ambient_light, point_light

torch.set_num_threads(2)

GOLDEN = chip_smoke.MULTI_GOLDEN
GOLDEN_FILM = 64

CUBE_LIGHTS = {
    "point": [point_light((4.0, 4.0, 0.0), (1.0, 1.0, 1.0))],
    "two": [point_light((4.0, 4.0, 0.0), (1.0, 0.8, 0.6)),
            ambient_light((0.1, 0.1, 0.2))],
    "area": chip_smoke.CUBE_AREA_LIGHTS,
}


def cube_row(lights: str, film: int = 32) -> chip_smoke.SceneSpec:
    return chip_smoke.cube_row(CUBE_LIGHTS[lights], film=film)


def tree_scene(film: int = 32) -> chip_smoke.SceneSpec:
    """tests/test_fast_multi.py::test_fast_multi_instance_tree: 64 cubes,
    the instance tree on."""
    return chip_smoke.SceneSpec(
        meshes=[chip_smoke.cube_mesh()],
        instances=[Instance(0, mat4_translate_scale(
            (0.0, (k // 8) * 0.5 - 1.75, (k % 8) * 0.5 - 1.75),
            (0.2, 0.2, 0.2))) for k in range(64)],
        lights=[point_light((4.0, 4.0, 0.0), (1.0, 1.0, 1.0))],
        camera=PerspectiveCamera(
            eye=(4.5, 0.3, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
            fov=float(55 * np.pi / 180), film_width=film, film_height=film,
            samples=1, max_depth=1, jitter_window=0.5))


SCENES = {
    "cube_point": lambda: cube_row("point"),
    "cube_two": lambda: cube_row("two"),
    "cube_area": lambda: cube_row("area"),
    "simple": lambda: chip_smoke.simple_app(64, 64),
    "tree64": tree_scene,
}


def both(spec, fn, accel=False, **kw):
    """fn(tracer module, scene, rays, W, H, accel) in JAX and in the port,
    on the JAX scene (its instance tree included), its camera rays and, with
    accel, its BVH arrays. Returns (jax fb, port fb) as numpy."""
    W, H = spec.camera.film_width, spec.camera.film_height
    jscene = tp.jax_scene(spec)
    jrays = tp.jax_rays(spec.camera)
    jacc, tacc = tp.bvh_pair(spec.meshes) if accel else (None, None)
    with tp.pallas_interpret():
        jfb = np.asarray(fn(jax_tracer, jscene, jrays, W, H, jacc, **kw))
    tfb = fn(tracer, tp.port_scene(jscene), tp.port_rays(jrays), W, H, tacc,
             **kw)
    return jfb, tfb.numpy()


def fast_multi(mod, scene, rays, W, H, accel, **kw):
    return mod.trace_image_fast_multi(scene, rays, W, H, accel=accel, **kw)


def looped(mod, scene, rays, W, H, accel, **kw):
    return mod.trace_image(scene, mod.make_arena(rays, scene.num_lights), W,
                           H, max_rounds=64, accel=accel, **kw)


def assert_contract(fast, loop, n_lights: int, area: bool) -> None:
    """fast-multi vs looped inside the port (the JAX package's contract)."""
    if n_lights == 1 and not area:
        np.testing.assert_array_equal(fast, loop)
    else:
        assert np.abs(fast[:, :3] - loop[:, :3]).max() <= 3e-7
    w = int(np.sqrt(fast.shape[0]))
    from gravit_tpu_torch.scene import image
    np.testing.assert_array_equal(image.to_rgb8(fast, w, w),
                                  image.to_rgb8(loop, w, w))


@pytest.mark.parametrize("name", list(SCENES))
def test_fast_multi_and_looped_match_jax(name):
    spec = SCENES[name]()
    W, H = spec.camera.film_width, spec.camera.film_height
    jf, tf = both(spec, fast_multi)
    jl, tl = both(spec, looped)
    assert tp.lit(tf) > 0.02
    tp.assert_multi_close(tf, jf, W, H)
    tp.assert_multi_close(tl, jl, W, H)
    assert_contract(tf, tl, len(spec.lights), name == "cube_area")


def test_simple_untiled_and_scatter_deposit_match_jax():
    """Row order instead of film tiles, and the pixel-id scatter deposit
    (dense_deposit=False) instead of the dense one: JAX's frames within
    the multi tolerance, the row-order frame equal to the tiled one."""
    spec = chip_smoke.simple_app(64, 64)
    jf, tf = both(spec, fast_multi, tile_order=False)
    tp.assert_multi_close(tf, jf, 64, 64)
    _, tiled = both(spec, fast_multi)
    np.testing.assert_array_equal(tf, tiled)
    js, ts = both(spec, fast_multi, dense_deposit=False)
    tp.assert_multi_close(ts, js, 64, 64)


@pytest.mark.parametrize("name", ["cube_area", "pack9"])
def test_bvh_frames_match_jax(name):
    """The BVH path: JAX's Pallas kernel in interpret mode, the port's plain
    traversal, the same BVH arrays. cube_area: two meshes, the in-place
    passes; pack9: nine meshes, the segment-aligned pack, both lights."""
    if name == "cube_area":
        spec = cube_row("area")
    else:
        spec = chip_smoke.make_multi_scene(2, 32, 32, bands=6, meshes=9,
                                           grid=(3, 6))
    jf, tf = both(spec, fast_multi, accel=True)
    tp.assert_multi_close(tf, jf, 32, 32)
    assert tp.lit(tf) > 0.02
    jl, tl = both(spec, looped, accel=True)
    tp.assert_multi_close(tl, jl, 32, 32)
    assert_contract(tf, tl, len(spec.lights), True)


def test_looped_depth2_stepped_and_render_surface_match_jax():
    """SimpleApp at depth 2 (Russian roulette bounces across instances):
    trace_image (its rounds recorded as spans), unroll=True and
    render_surface's looped branch."""
    spec = chip_smoke.simple_app(32, 32, max_depth=2)
    jl, tl = both(spec, looped)
    tp.assert_multi_close(tl, jl, 32, 32)
    jscene = tp.jax_scene(spec)
    scene = tp.port_scene(jscene)
    arena = tracer.make_arena(tp.port_rays(tp.jax_rays(spec.camera)), 1)
    with timing.recording() as rec:
        traced = tracer.trace_image(scene, arena, 32, 32)
    assert torch.equal(traced, torch.tensor(tl))
    rounds = [s for s in rec.spans() if s.name == "tracer.round"]
    assert 3 <= len(rounds) < 64 and "tracer.round" in rec.report()
    unrolled = tracer.trace_image(scene, arena, 32, 32, max_rounds=20,
                                  unroll=True)
    assert torch.equal(unrolled, torch.tensor(tl))
    fb = render_surface(spec.meshes, spec.instances, spec.lights,
                        spec.camera, device="cpu").numpy()
    tp.assert_multi_close(fb, jl, 32, 32)
    assert count_rays(arena) == {"active": 1024, "queued": 0,
                                 "capacity": arena.capacity}


def test_render_surface_dispatch():
    """One instance at depth <= 6: the megapass; depth 7: the looped
    tracer (equal to trace_image); several instances at depth 1: fast-multi;
    depth 0 raises."""
    spec = chip_smoke.make_scene(3, bands=6, width=16, height=16)
    cam7 = dataclasses.replace(spec.camera, max_depth=7)
    fb = render_surface(spec.meshes, spec.instances, spec.lights, cam7,
                        device="cpu")
    scene = build_scene(spec.meshes, spec.instances, spec.lights,
                        device="cpu")
    ref = tracer.trace_image(scene, tracer.make_arena(
        cam7.generate_rays("cpu"), 1), 16, 16)
    assert torch.equal(fb, ref) and tp.lit(fb) > 0.3
    simple = chip_smoke.simple_app(32, 32)
    fb = render_surface(simple.meshes, simple.instances, simple.lights,
                        simple.camera, device="cpu")
    sscene = build_scene(simple.meshes, simple.instances, simple.lights,
                         device="cpu")
    assert torch.equal(fb, tracer.trace_image_fast_multi(
        sscene, simple.camera.generate_rays("cpu"), 32, 32))
    with pytest.raises(ValueError):
        tracer.trace_image_fast(sscene, simple.camera.generate_rays("cpu"),
                                32, 32)


# ---- the arena pieces -----------------------------------------------------

def seeded_arena(seed: int, n: int, live_frac: float, num_lights: int = 2):
    """A random arena (numpy fields) and a packed spawn matrix of
    num_lights * n rows, ~60% valid."""
    rng = np.random.default_rng(seed)
    arena = dict(
        origin=rng.normal(size=(n, 3)).astype(np.float32),
        direction=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        t_max=rng.uniform(1, 3, n).astype(np.float32),
        t=rng.uniform(0, 3, n).astype(np.float32),
        w=rng.uniform(0, 1, n).astype(np.float32),
        id=rng.integers(0, n, n).astype(np.int32),
        depth=rng.integers(0, 4, n).astype(np.int32),
        type=rng.integers(0, 3, n).astype(np.int32),
        inst=rng.integers(-1, 25, n).astype(np.int32),
        prev=rng.integers(-1, 25, n).astype(np.int32),
        active=rng.random(n) < live_frac)
    m = num_lights * n
    spawn = rng.uniform(-2, 2, (m, 16)).astype(np.float32)
    spawn[:, 12] = rng.integers(0, n, m)
    spawn[:, 13] = rng.integers(0, 4, m)
    spawn[:, 14] = rng.integers(0, 25, m)
    spawn[:, 15] = rng.random(m) < 0.6
    return arena, spawn


@pytest.mark.parametrize("live_frac", [0.3, 0.9, 1.0])
@pytest.mark.parametrize("pending", [True, False])
def test_append_rays_matches_jax(live_frac, pending):
    """0.3: room for every valid spawn; 0.9: overflow, the spawns that find
    no free lane are dropped; 1.0: every lane live, nothing lands."""
    arena, spawn = seeded_arena(3, 2048, live_frac)
    ja = jax_tracer._append_rays(
        JaxArena(**{k: jnp.asarray(v) for k, v in arena.items()}),
        jnp.asarray(spawn), pending=pending)
    ta = tracer._append_rays(interop.rays_from_numpy(arena, "cpu"),
                             torch.tensor(spawn), pending=pending)
    for f in dataclasses.fields(ta):
        np.testing.assert_array_equal(getattr(ta, f.name).numpy(),
                                      np.asarray(getattr(ja, f.name)), f.name)
    landed = int(ta.active.sum()) - int(arena["active"].sum())
    free, valid = int((~arena["active"]).sum()), int(spawn[:, 15].sum())
    assert landed == min(free, valid)


@pytest.mark.parametrize("live_frac,thresh", [(0.05, 1024), (0.5, 1024),
                                              (1.0, 1024), (0.0, 2048)])
def test_live_first_sel_matches_jax(live_frac, thresh):
    """The compaction index: JAX's, and no lane twice (the tail's results
    go back with index_copy, safe only without repeats)."""
    rng = np.random.default_rng(int(live_frac * 100) + thresh)
    live = rng.random(8192) < live_frac
    ref = np.asarray(jax_tracer._live_first_sel(jnp.asarray(live), thresh))
    got = tracer._live_first_sel(torch.tensor(live), thresh).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.unique(got).size == thresh
    n_live = min(int(live.sum()), thresh)
    assert live[got[:n_live]].all()
    np.testing.assert_array_equal(
        got, np.argsort(~live, kind="stable")[:thresh])


def test_scatter_drop_matches_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(-3, 40, 64)
    idx[idx >= 0] = rng.permutation(64)[:int((idx >= 0).sum())]  # no repeat
    src = np.arange(64, dtype=np.int64)
    ref = np.asarray(jnp.full((50,), 99, jnp.int32).at[
        jnp.where(jnp.asarray(idx) < 0, 50, jnp.asarray(idx))].set(
        jnp.asarray(src, jnp.int32), mode="drop"))
    got = tracer._scatter_drop(50, 99, torch.tensor(np.where(idx < 0, 50, idx)),
                               torch.tensor(src)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_round_extra_takes_per_lane_rounds():
    from gravit_tpu_torch.core.rng import round_extra
    depth = torch.tensor([0, 1, 3, 7], dtype=torch.int32)
    rounds = torch.tensor([0, 5, 2**31 + 7, 63], dtype=torch.int64)
    got = round_extra(rounds, depth)
    for k in range(4):
        assert int(got[k]) == int(round_extra(int(rounds[k]), depth[k:k + 1]))
    ref = (np.asarray(rounds.numpy(), np.uint32) * np.uint32(2654435761)
           + depth.numpy().astype(np.uint32) * np.uint32(40503))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


# ---- golden frames ----------------------------------------------------------

def golden_specs() -> dict:
    f = GOLDEN_FILM
    return {"simple_fast": chip_smoke.simple_app(f, f),
            "simple_looped2": chip_smoke.simple_app(f, f, max_depth=2),
            "cube_area": cube_row("area", film=f),
            "multi": chip_smoke.make_multi_scene(0, f, f)}


def jax_golden_frame(spec) -> np.ndarray:
    """The JAX renderer's single-device branch on the CPU (brute
    intersector): fast-multi at depth 1, the looped tracer otherwise."""
    W, H = spec.camera.film_width, spec.camera.film_height
    scene, rays = tp.jax_scene(spec), tp.jax_rays(spec.camera)
    if spec.camera.max_depth <= 1:
        return np.asarray(jax_tracer.trace_image_fast_multi(scene, rays, W, H))
    return np.asarray(jax_tracer.trace_image(
        scene, jax_tracer.make_arena(rays, scene.num_lights), W, H))


def write_golden(path=GOLDEN) -> None:
    """chip_smoke.py's golden_multi phase holds the card's frames against
    these."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, film=GOLDEN_FILM, **{
        f"fb_{k}": jax_golden_frame(s) for k, s in golden_specs().items()})


@pytest.mark.parametrize("name", ["simple_fast", "simple_looped2",
                                  "cube_area", "multi"])
def test_golden_frames(name):
    """The port's CPU frame through render_surface against the committed
    JAX frame (the many-domain scene takes the BVH: the pack, the
    instance tree, the plain traversal), within the multi tolerance; JAX
    still renders the committed frame bit for bit (but the many-domain
    one, ~20 s of JAX on the CPU)."""
    gold = np.load(GOLDEN)
    spec = golden_specs()[name]
    ref = gold[f"fb_{name}"]
    if name != "multi":
        np.testing.assert_array_equal(jax_golden_frame(spec), ref)
    fb = render_surface(spec.meshes, spec.instances, spec.lights,
                        spec.camera, device="cpu").numpy()
    tp.assert_multi_close(fb, ref, GOLDEN_FILM, GOLDEN_FILM)
    assert tp.lit(fb) > 0.02


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
