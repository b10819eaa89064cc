"""The port's single-instance megapass (gravit_tpu_torch trace_image_fast)
against the JAX package's, on the CPU.

Both packages render the same procedural scene (chip_smoke.make_scene) from
the same camera rays and, on the BVH path, the SAME flat BVH arrays carried
across through interop (the JAX package's native builder orders leaf
triangles differently from the numpy builder). JAX runs its Pallas kernel
in interpret mode.

Tolerances, and why:
- depth 1: equal to_rgb8 bytes, float max |d| <= 1e-5. Not bit-equal:
  XLA's CPU backend contracts a*b+c into fused multiply-adds, the port
  rounds each operation. Measured: max 3.7e-7 on the 514-triangle scene;
  2.0e-6 on the 4,610-triangle golden scene, at a grazing hit on the
  sphere's limb, where the JAX package's own BVH and brute paths already
  differ by 5.5e-7.
- depth >= 2: <= 0.5% of bytes differ and mean |d| <= 1e-4. The cosine
  hemisphere's arccos/sin/cos differ by ulps between XLA and torch
  (measured: 0 bytes differ, float max 2.0e-6).
- samples 2 and the pixel-id scatter deposit: float max |d| <= 1e-6, as
  tests/test_fast_path.py::test_fast_samples4 allows for sums taken in
  another order.

Refresh the committed golden frames by hand (JAX only):
    JAX_PLATFORMS=cpu python tests/test_torch_tracer.py --write-golden
"""

import contextlib
import dataclasses
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gravit_tpu.accel.scene_accel import build_scene_bvh as jax_build_bvh  # noqa: E402
from gravit_tpu.render import tracer as jax_tracer  # noqa: E402
from gravit_tpu.render.scene_build import build_scene as jax_build_scene  # noqa: E402
from gravit_tpu.scene.camera import PerspectiveCamera as JaxCamera  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.render import tracer  # noqa: E402
from gravit_tpu_torch.render.renderer import render_surface  # noqa: E402
from gravit_tpu_torch.render.scene_build import build_scene  # noqa: E402
from gravit_tpu_torch.scene import image  # noqa: E402
from gravit_tpu_torch.scene.light import (ambient_light, area_light,  # noqa: E402
                                          point_light)

torch.set_num_threads(2)

GOLDEN_SPEC = dict(seed=0, bands=48, width=64, height=64)

LIGHT_SETS = {
    "point": [point_light((0.0, 0.1, 0.5), (1.0, 1.0, 1.0))],
    "mixed": [point_light((0.0, 0.1, 0.5), (0.7, 0.7, 0.7)),
              ambient_light((0.1, 0.1, 0.15)),
              area_light((0.05, 0.3, 0.2), (0.9, 0.9, 0.9),
                         (0.0, -1.0, 0.0), 0.1, 0.1)],
}


@contextlib.contextmanager
def pallas_interpret():
    prev = os.environ.get("GRAVIT_PALLAS_INTERPRET")
    os.environ["GRAVIT_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("GRAVIT_PALLAS_INTERPRET", None)
        else:
            os.environ["GRAVIT_PALLAS_INTERPRET"] = prev


def leaves(x) -> dict:
    """The numpy arrays of a JAX dataclass, by field name."""
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if not isinstance(getattr(x, f.name), (int, type(None)))}


def render_both(spec, depth, use_bvh, samples=1, dense=True):
    """(jax_fb, port_fb) as numpy for one scene; the port traces the JAX
    camera rays and, with use_bvh, the JAX package's BVH arrays."""
    W, H = spec.camera.film_width, spec.camera.film_height
    cam = dataclasses.replace(spec.camera, samples=samples, max_depth=depth)
    jrays = JaxCamera(**dataclasses.asdict(cam)).generate_rays()
    jscene = jax_build_scene(spec.meshes, spec.instances, spec.lights)
    jacc = jax_build_bvh(spec.meshes) if use_bvh else None
    with pallas_interpret():
        jfb = np.asarray(jax_tracer.trace_image_fast(
            jscene, jrays, W, H, accel=jacc, dense_deposit=dense,
            samples=samples, max_depth=depth))
    tscene = build_scene(spec.meshes, spec.instances, spec.lights,
                         device="cpu")
    tacc = (interop.bvh_from_numpy(leaves(jacc), jacc.num_meshes, "cpu")
            if use_bvh else None)
    tfb = tracer.trace_image_fast(
        tscene, interop.rays_from_numpy(leaves(jrays), "cpu"), W, H,
        accel=tacc, dense_deposit=dense, samples=samples, max_depth=depth)
    return jfb, tfb.numpy()


def frame_diff(a, b, w, h) -> dict:
    ba, bb = image.to_rgb8(a, w, h), image.to_rgb8(b, w, h)
    d = np.abs(a - b)
    return dict(byte_frac=float(np.mean(ba != bb)), float_max=float(d.max()),
                float_mean=float(d.mean()))


def assert_within(diff: dict, depth: int) -> None:
    if depth == 1:
        assert diff["byte_frac"] == 0.0, diff
        assert diff["float_max"] <= 1e-5, diff
    else:
        assert diff["byte_frac"] <= 5e-3, diff
        assert diff["float_mean"] <= 1e-4, diff


CASES = [
    # depth, bvh, lights, film
    (1, False, "point", 64),
    (1, True, "point", 64),
    (1, True, "mixed", 32),
    (2, False, "point", 32),
    (2, True, "mixed", 64),
    (3, False, "mixed", 32),
]


@pytest.mark.parametrize("depth,use_bvh,lights,film", CASES)
def test_fast_matches_jax(depth, use_bvh, lights, film):
    spec = chip_smoke.make_scene(3, bands=16, width=film, height=film)
    spec.lights = LIGHT_SETS[lights]
    jfb, tfb = render_both(spec, depth, use_bvh)
    assert (jfb[:, :3].sum(axis=1) > 0).mean() > 0.3     # the scene is lit
    assert_within(frame_diff(jfb, tfb, film, film), depth)


@pytest.mark.parametrize("samples,dense", [(2, True), (1, False)])
def test_fast_samples_and_scatter_match_jax(samples, dense):
    spec = chip_smoke.make_scene(4, bands=16, width=32, height=32)
    spec.camera = dataclasses.replace(spec.camera, jitter_window=0.5)
    jfb, tfb = render_both(spec, 1, use_bvh=False, samples=samples,
                           dense=dense)
    np.testing.assert_allclose(tfb, jfb, atol=1e-6, rtol=0)


def test_fast_rejects_other_scenes():
    spec = chip_smoke.make_scene(3, bands=8, width=32, height=32)
    cam = dataclasses.replace(spec.camera, max_depth=0)
    with pytest.raises(NotImplementedError):
        render_surface(spec.meshes, spec.instances, spec.lights, cam,
                       device="cpu")
    with pytest.raises(NotImplementedError):
        render_surface(spec.meshes, spec.instances * 2, spec.lights,
                       spec.camera, device="cpu")


def test_shuffle_retires_and_deposits_like_jax():
    """shuffle(initial=False) on one instance: every pending ray retires
    and pending SHADOW rays with color deposit color*w. Duplicate pixels
    sum in another order: float max |d| <= 1e-6."""
    from gravit_tpu.core.rays import RayArena as JaxArena

    rng_ = np.random.default_rng(8)
    n, w, h = 2048, 16, 16
    color = rng_.uniform(0, 1, (n, 3)).astype(np.float32)
    color[rng_.uniform(size=n) < 0.2] = 0.0
    arrays = dict(
        origin=rng_.normal(size=(n, 3)).astype(np.float32),
        direction=rng_.normal(size=(n, 3)).astype(np.float32),
        color=color, t_max=np.full(n, 3.0, np.float32),
        t=np.ones(n, np.float32),
        w=rng_.uniform(0, 1, n).astype(np.float32),
        id=rng_.integers(0, w * h, n).astype(np.int32),
        depth=np.ones(n, np.int32),
        type=rng_.integers(0, 3, n).astype(np.int32),
        inst=rng_.integers(-1, 1, n).astype(np.int32),
        prev=np.zeros(n, np.int32),
        active=rng_.uniform(size=n) < 0.7)
    spec = chip_smoke.make_scene(5, bands=4)
    jscene = jax_build_scene(spec.meshes, spec.instances, spec.lights)
    fb0 = rng_.uniform(0, 0.5, (w * h, 4)).astype(np.float32)
    ja, jfb = jax_tracer.shuffle(
        jscene, JaxArena(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(fb0), initial=False)
    scene = build_scene(spec.meshes, spec.instances, spec.lights,
                        device="cpu")
    ta, tfb = tracer.shuffle(scene, interop.rays_from_numpy(arrays, "cpu"),
                             torch.tensor(fb0), initial=False)
    np.testing.assert_array_equal(ta.active.numpy(), np.asarray(ja.active))
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=1e-6,
                               rtol=0)
    assert not np.array_equal(np.asarray(jfb), fb0)      # something landed


def test_cosine_hemisphere_like_jax():
    """arccos/sin/cos differ by ulps between XLA and torch: |d| <= 1e-6
    on unit directions (measured: 2.1e-7)."""
    rng_ = np.random.default_rng(9)
    nrm = rng_.normal(size=(4096, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[:64, 1:] = 0.0                          # argmin ties: first index
    nrm[:64, 0] = 1.0
    xi = rng_.uniform(0, 1, (4096, 2)).astype(np.float32)
    ref = np.asarray(jax_tracer._cosine_hemisphere(jnp.asarray(nrm),
                                                   jnp.asarray(xi)))
    got = tracer._cosine_hemisphere(torch.tensor(nrm),
                                    torch.tensor(xi)).numpy()
    assert np.abs(got - ref).max() <= 1e-6


def jax_golden_frame(depth: int) -> np.ndarray:
    spec = chip_smoke.make_scene(GOLDEN_SPEC["seed"],
                                 bands=GOLDEN_SPEC["bands"],
                                 width=GOLDEN_SPEC["width"],
                                 height=GOLDEN_SPEC["height"])
    cam = dataclasses.replace(spec.camera, max_depth=depth)
    scene = jax_build_scene(spec.meshes, spec.instances, spec.lights)
    rays = JaxCamera(**dataclasses.asdict(cam)).generate_rays()
    return np.asarray(jax_tracer.trace_image_fast(
        scene, rays, cam.film_width, cam.film_height, max_depth=depth))


def write_golden(path=chip_smoke.GOLDEN) -> None:
    """Write the JAX package's CPU frames of the procedural scene (64^2,
    depth 1 and 2, brute intersector); chip_smoke.py phase 7 holds the
    card's frames against them."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, fb_depth1=jax_golden_frame(1),
                        fb_depth2=jax_golden_frame(2), **GOLDEN_SPEC)


@pytest.mark.parametrize("depth", [1, 2])
def test_golden_frames(depth):
    """JAX still produces the committed frame bit for bit, and the port's
    CPU frame through render_surface (BVH over 512 triangles, plain
    traversal) is within the tolerances above."""
    gold = np.load(chip_smoke.GOLDEN)
    ref = gold[f"fb_depth{depth}"]
    np.testing.assert_array_equal(jax_golden_frame(depth), ref)
    spec = chip_smoke.make_scene(int(gold["seed"]), bands=int(gold["bands"]),
                                 width=int(gold["width"]),
                                 height=int(gold["height"]))
    assert spec.meshes[0].num_triangles >= 512
    fb = render_surface(spec.meshes, spec.instances, spec.lights,
                        dataclasses.replace(spec.camera, max_depth=depth),
                        device="cpu").numpy()
    assert_within(frame_diff(ref, fb, spec.camera.film_width,
                             spec.camera.film_height), depth)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", chip_smoke.GOLDEN)
