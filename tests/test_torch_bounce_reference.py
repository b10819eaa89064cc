"""The benchmark's plain bounce reference (portbench/reference/
surface_bounce.py) against the port's single-instance megapass at camera
ray depth 2 and 3, against the plain depth-1 reference
(portbench/reference/surface.py) at depth 1, and against the JAX package's
looped tracer at depth 2, on the CPU.

The scenes are the benchmark's frozen bunny stand-in (portbench/scenes/
displaced_sphere.py) at 24 bands (1,154 triangles: the reference tests
them whole) and 50 (5,002: the reference tests each ray on the triangle
blocks its line enters), seen from poses of the benchmark's orbit through
the resident driver, which builds the port's scene and BVH as the cell
does.

Tolerances, and why:
- port against the reference: alpha equal (a pixel's alpha counts its
  deposits, so a bounce taken, lost or hitting elsewhere shows there) and
  rgb within 1e-5. The two shade the same hits in float32 but compute
  the interpolated normal in another association, so the bounce
  directions differ by ulps (measured: rgb sum of |d| over the sum of rgb
  <= 1e-9, alpha equal). A frame rendered at depth 1 fails it: it lacks
  every bounce's deposit (asserted below).
- the reference at depth 1 against surface.py: bit for bit. Nothing
  bounces there, and the per-ray block test finds surface.py's hits.
- the JAX package's looped tracer against the reference: alpha equal and
  rgb within 1e-5, as above; XLA contracts a*b+c into fused multiply-adds
  and its arccos / sin / cos differ from torch's by ulps.
"""

import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch_parity as tp  # noqa: E402
import chip_smoke  # noqa: E402
from gravit_tpu.render import tracer as jax_tracer  # noqa: E402

from gravit_tpu_torch.core import rng  # noqa: E402
from gravit_tpu_torch.render import tracer  # noqa: E402
from portbench import drivers, harness  # noqa: E402
from portbench.reference import surface, surface_bounce as ref  # noqa: E402

torch.set_num_threads(2)

CELL = "bunny_standin.resident_orbit_d2"
RGB_TOL = 1e-5
SEED = 2**31 + 77


def driver(bands: int, depth: int, film: int, seed: int = SEED):
    """The cell's resident driver at a small scene and film, set up on the
    CPU, the program rendering at `depth`."""
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scene_args"] = {"seed": 0, "bands": bands}
    cell.config["depth"] = depth
    cell.traffic = dict(cell.traffic, warmup_frames=1, warmup_seconds=0.0)
    drv = drivers.make(cell, seed, "cpu", (film, film))
    drv.setup()
    return drv


def reference(drv, k: int, depth: int, ar=None):
    prep, params = ref.prepare(drv.scene_data, drv.cfg["lights"], "cpu")
    cam = dataclasses.replace(drv.ref_camera(drv.pose(k)), max_depth=depth)
    return ref.render(prep, params, cam, ar)


def fast(drv, k: int, depth: int, use_bvh: bool):
    from gravit_tpu_torch.scene.camera import PerspectiveCamera

    eye, focus, up = drv.pose(k)
    cam = PerspectiveCamera(eye=eye, focus=focus, up=up, fov=drv.fov,
                            film_width=drv.width, film_height=drv.height,
                            samples=1, max_depth=depth, jitter_window=0.0)
    return tracer.trace_image_fast(
        drv.scene, cam.generate_rays("cpu"), drv.width, drv.height,
        accel=drv.accel if use_bvh else None, max_depth=depth)


def assert_close(fb, want):
    fb, want = torch.as_tensor(fb), torch.as_tensor(want)
    assert torch.equal(fb[:, 3], want[:, 3]), float(
        (fb[:, 3] != want[:, 3]).sum())
    assert float((fb[:, :3] - want[:, :3]).abs().max()) <= RGB_TOL


@pytest.mark.parametrize("depth,use_bvh,bands,film", [
    (2, True, 24, 48), (2, False, 50, 32), (3, True, 50, 32),
    (3, False, 24, 64)])
def test_megapass_matches_the_bounce_reference(depth, use_bvh, bands, film):
    drv = driver(bands, depth, film)
    assert drv.accel is not None
    shallower = driver(bands, depth - 1, film)
    lit = 0
    for k in (0, 3, 5):
        want = reference(drv, k, depth)
        assert_close(fast(drv, k, depth, use_bvh), want)
        if float(want[:, 3].sum()) == 0:     # a pose under the floor
            continue
        lit += 1
        # the tolerance catches a frame rendered one depth less
        with pytest.raises(AssertionError):
            assert_close(fast(shallower, k, depth - 1, use_bvh), want)
    assert lit >= 2


@pytest.mark.parametrize("bands", [24, 50])
def test_depth_one_is_the_plain_reference_bit_for_bit(bands):
    drv = driver(bands, 1, 40)
    prep, params = ref.prepare(drv.scene_data, drv.cfg["lights"], "cpu")
    lit = 0
    for k in (0, 2, 7):
        cam = drv.ref_camera(drv.pose(k))
        want = surface.render(prep, params, cam)
        got = ref.render(prep, params, dataclasses.replace(cam, max_depth=1))
        assert torch.equal(got, want)
        lit += float(want[:, 3].sum()) > 0
    assert lit >= 2


def test_block_culling_finds_the_brute_force_hits(monkeypatch):
    drv = driver(50, 2, 40)
    for k in (0, 5):
        culled = reference(drv, k, 2)
        monkeypatch.setattr(surface, "CULL_MIN", 10**9)
        brute = reference(drv, k, 2)
        monkeypatch.setattr(surface, "CULL_MIN", 4096)
        assert torch.equal(culled, brute)


def test_the_hash_is_the_programs():
    ids = torch.randint(0, 2**31 - 1, (4096,), dtype=torch.int64)
    depth = torch.randint(0, 7, (4096,), dtype=torch.int32)
    for rnd in (0, 1, 5, 63):
        extra = rng.round_extra(rnd, depth)
        want = ref._extra(rnd, depth.numpy())
        assert np.array_equal(extra.numpy(), want.astype(np.int64))
        for salt in (ref.SALT_ROULETTE, ref.SALT_THETA, ref.SALT_PHI, 11):
            got = ref.uniform(ids.numpy(), salt, want)
            if salt == ref.SALT_ROULETTE or salt == 11:
                prog = rng.hash_uniform(ids, salt, extra)
            else:
                prog = rng.hash_uniform2(ids, 992, extra)[
                    :, salt - ref.SALT_THETA]
            assert np.array_equal(got, prog.numpy())


def test_cosine_direction_is_the_programs():
    g = torch.Generator().manual_seed(3)
    n = torch.nn.functional.normalize(torch.randn(2048, 3, generator=g),
                                      dim=1)
    xi = torch.rand(2048, 2, generator=g)
    got = ref.cosine_direction(ref.Arith(), n, xi[:, 0], xi[:, 1])
    want = tracer._cosine_hemisphere(n, xi)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got * n).sum(dim=1).min()) >= -1e-6   # the hemisphere


def test_jax_looped_tracer_matches_the_bounce_reference():
    from portbench.scenes import displaced_sphere

    film, bands = 32, 24
    spec = chip_smoke.make_scene(seed=0, bands=bands, width=film,
                                 height=film, max_depth=2)
    jscene = tp.jax_scene(spec)
    jrays = tp.jax_rays(spec.camera)
    jfb = np.array(jax_tracer.trace_image(
        jscene, jax_tracer.make_arena(jrays, jscene.num_lights), film, film))
    c = spec.camera
    prep, params = ref.prepare(
        displaced_sphere.scene(0, bands),
        [{"kind": "point", "position": [0.0, 0.1, 0.5],
          "color": [1.0, 1.0, 1.0]}], "cpu")
    cam = ref.Camera(c.eye, c.focus, c.up, c.fov, film, film)
    want = ref.render(prep, params, cam)
    assert_close(jfb, want)
    one = surface.render(prep, params, cam)
    assert float(want[:, 3].sum()) > float(one[:, 3].sum())
