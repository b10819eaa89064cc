"""The port's native host builder (gravit_tpu_torch/native/, a copy of
gravit_tpu/native/) against the JAX package's, on the CPU: the flat BVH
arrays of the native binned-SAH build, the OBJ scan, the library's build
place, and render_surface frames in which each package builds its BVH with
its own default (the native builder, whose leaf triangle order is not the
numpy builder's). Nothing here reads files the test does not write.

Tolerances: the BVH arrays and the parsed vertices and faces are equal
(the same C++ source, the same flags). Frames: torch_parity's multi
tolerance (XLA's CPU backend contracts a*b+c into FMAs, the port rounds
each operation); JAX runs its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu import native as jax_native
from gravit_tpu.accel import bvh as jax_bvh
from gravit_tpu.render import tracer as jax_tracer

from gravit_tpu_torch import native
from gravit_tpu_torch.accel import bvh
from gravit_tpu_torch.render.renderer import render_surface
from test_torch_scene import random_mesh

torch.set_num_threads(2)


def test_native_available_and_built_apart():
    """g++ is on this machine; the library lives in the package's _build/
    under a digest of the source and flags, never next to the source."""
    assert native.available(), native.error
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent == pathlib_pkg()
    assert not list((pathlib_pkg() / "native").glob("*.so"))


def pathlib_pkg():
    import pathlib

    return pathlib.Path(native.__file__).resolve().parent.parent


MESHES = {
    "random_small": lambda: random_mesh(3, 37),
    "random": lambda: random_mesh(9, 700),
    "sphere": lambda: chip_smoke.make_scene(1, bands=20).meshes[0],
    "sphere_flat_floor": lambda: chip_smoke.make_scene(4, bands=33).meshes[0],
}


@pytest.mark.parametrize("max_leaf", [8, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_native_bvh_equal_jax(mesh, max_leaf):
    cm = MESHES[mesh]()
    got = bvh.build_bvh(cm.v0, cm.e1, cm.e2, max_leaf)
    ref = jax_bvh.build_bvh(cm.v0, cm.e1, cm.e2, max_leaf, native=True)
    for name in ("bounds", "meta", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    assert got.depth == ref.depth
    raw = native.build_bvh_native(cm.v0, cm.e1, cm.e2, max_leaf)
    np.testing.assert_array_equal(raw[2], got.order)
    assert sorted(got.order.tolist()) == list(range(cm.num_triangles))


def test_numpy_fallback_is_the_numpy_builder():
    """native=False is the numpy builder (JAX's _build_bvh_py): the same
    node table as the native build, another leaf order."""
    cm = MESHES["sphere"]()
    py = bvh.build_bvh(cm.v0, cm.e1, cm.e2, native=False)
    ref = jax_bvh._build_bvh_py(cm.v0, cm.e1, cm.e2)
    for name in ("bounds", "meta", "order"):
        np.testing.assert_array_equal(getattr(py, name), getattr(ref, name))
    nat = bvh.build_bvh(cm.v0, cm.e1, cm.e2)
    np.testing.assert_array_equal(nat.bounds, py.bounds)
    assert not np.array_equal(nat.order, py.order)


OBJ = """# a quad, a triangle with texture/normal indices, a pentagon fan
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1.25
vt 0 0
vn 0 0 1
f 1 2 3 4
f 1/1/1 2/1/1 5/1/1
g other
f 1 2 3 4 5
f -1 -2 -3
"""


def test_parse_obj_native_equal_jax(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ)
    got = native.parse_obj_native(str(path))
    ref = jax_native.parse_obj_native(str(path))
    assert got is not None and ref is not None
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    verts, faces = got
    assert verts.shape == (5, 3) and faces.shape[1] == 3
    assert native.parse_obj_native(str(tmp_path / "missing.obj")) is None


def jax_render_surface(spec):
    """The JAX renderer's single-device branch (renderer.py:200-227) with
    its default BVH (the native builder), the kernel in interpret mode."""
    jscene = tp.jax_scene(spec)
    jrays = tp.jax_rays(spec.camera)
    jacc, _ = tp.bvh_pair(spec.meshes)
    W, H = spec.camera.film_width, spec.camera.film_height
    with tp.pallas_interpret():
        if jscene.num_instances == 1:
            fb = jax_tracer.trace_image_fast(
                jscene, jrays, W, H, accel=jacc,
                max_depth=spec.camera.max_depth)
        elif spec.camera.max_depth <= 1:
            fb = jax_tracer.trace_image_fast_multi(jscene, jrays, W, H,
                                                   accel=jacc)
        else:
            fb = jax_tracer.trace_image(
                jscene, jax_tracer.make_arena(jrays, jscene.num_lights), W,
                H, accel=jacc)
    return np.asarray(fb)


SPECS = {
    "flagship_d2": lambda: chip_smoke.make_scene(0, bands=20, width=32,
                                                 height=32, max_depth=2),
    "many_domain_d1": lambda: chip_smoke.make_multi_scene(
        0, 32, 32, bands=12, meshes=3, grid=(2, 3)),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_render_surface_own_defaults_match_jax(name):
    spec = SPECS[name]()
    assert sum(m.num_triangles for m in spec.meshes) >= 512   # BVH path
    fb = render_surface(spec.meshes, spec.instances, spec.lights,
                        spec.camera, device="cpu")
    W, H = spec.camera.film_width, spec.camera.film_height
    tp.assert_multi_close(fb.numpy(), jax_render_surface(spec), W, H)
    assert tp.lit(fb) > 0.05
