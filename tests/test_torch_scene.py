"""Scene compilation and the numpy BVH builder of the port against the JAX
package, on the CPU: equal arrays, field by field."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gravit_tpu.accel import bvh as jax_bvh  # noqa: E402
from gravit_tpu.accel import scene_accel as jax_scene_accel  # noqa: E402
from gravit_tpu.render.scene_build import build_scene as jax_build_scene  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from gravit_tpu_torch.accel.scene_accel import build_scene_bvh  # noqa: E402
from gravit_tpu_torch.core.math3d import mat4_translate_scale  # noqa: E402
from gravit_tpu_torch.render.scene_build import (  # noqa: E402
    STATIC_FIELDS, TENSOR_FIELDS, Instance, build_scene)
from gravit_tpu_torch.scene.light import (ambient_light, area_light,  # noqa: E402
                                          point_light)
from gravit_tpu_torch.scene.material import Material, MaterialType  # noqa: E402
from gravit_tpu_torch.scene.mesh import Mesh  # noqa: E402

torch.set_num_threads(2)


def random_mesh(seed: int, n_tris: int, colors: bool = False):
    """Independent random triangles; optional vertex colors and per-face
    phong / embree materials."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([
        base, base + rng.normal(scale=0.4, size=(n_tris, 3)),
        base + rng.normal(scale=0.4, size=(n_tris, 3))]).astype(np.float32)
    m = Mesh()
    m.add_vertices(verts)
    m.add_faces(np.stack([np.arange(n_tris) + k * n_tris
                          for k in range(3)], axis=1) + 1)
    if colors:
        m.vertex_colors = list(rng.uniform(0, 1, (3 * n_tris, 3))
                               .astype(np.float32))
        kinds = [Material(), Material(type=int(MaterialType.PHONG), alpha=4.0),
                 Material(type=int(MaterialType.EMBREE_MATERIAL_METAL))]
        m.face_materials = [kinds[i % 3] for i in range(n_tris)]
    return m.finish()


def scene_inputs():
    meshes = [chip_smoke.make_scene(2, bands=10).meshes[0],
              random_mesh(5, 37, colors=True)]
    instances = [Instance(0, np.eye(4, dtype=np.float32)),
                 Instance(1, mat4_translate_scale((0.5, -0.2, 1.0),
                                                  (2.0, 0.5, 1.5)))]
    lights = [point_light((1, 2, 3), (0.5, 0.6, 0.7)),
              ambient_light((0.1, 0.1, 0.1)),
              area_light((0, 2, 0), (1, 1, 1), (0.3, -1.0, 0.1), 0.5, 0.25)]
    return meshes, instances, lights


@pytest.mark.parametrize("pad_tris_to", [None, 1000])
def test_build_scene_field_by_field(pad_tris_to):
    meshes, instances, lights = scene_inputs()
    ref = jax_build_scene(meshes, instances, lights, pad_tris_to=pad_tris_to)
    got = build_scene(meshes, instances, lights, pad_tris_to=pad_tris_to,
                      device="cpu")
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in STATIC_FIELDS:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.has_specular and got.has_embree_materials


def test_interop_carries_the_scene():
    meshes, instances, lights = scene_inputs()
    ref = jax_build_scene(meshes, instances, lights)
    arrays = {n: np.asarray(getattr(ref, n)) for n in TENSOR_FIELDS}
    static = {n: getattr(ref, n) for n in STATIC_FIELDS}
    got = interop.scene_from_numpy(arrays, "cpu", **static)
    own = build_scene(meshes, instances, lights, device="cpu")
    for f in dataclasses.fields(own):
        a, b = getattr(got, f.name), getattr(own, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_instance_bvh_scenes_raise():
    """64 instances (INSTANCE_BVH_THRESHOLD) no longer raise: they build the
    instance tree, equal to the JAX package's, and carry it through
    interop."""
    meshes, _, lights = scene_inputs()
    many = [Instance(k % 2, mat4_translate_scale((0.0, 0.3 * (k // 8),
                                                  0.3 * (k % 8)),
                                                 (0.1, 0.1, 0.1)))
            for k in range(64)]
    scene = build_scene(meshes, many, lights, device="cpu")
    ref = jax_build_scene(meshes, many, lights)
    assert scene.inst_bvh is not None and ref.inst_bvh is not None
    tree = {f.name: np.asarray(getattr(ref.inst_bvh, f.name))
            for f in dataclasses.fields(ref.inst_bvh)}
    for name, a in tree.items():
        np.testing.assert_array_equal(getattr(scene.inst_bvh, name).numpy(),
                                      a, name)
    arrays = {n: np.asarray(getattr(ref, n)) for n in TENSOR_FIELDS}
    static = {n: getattr(ref, n) for n in STATIC_FIELDS}
    got = interop.scene_from_numpy(arrays, "cpu", inst_bvh=tree, **static)
    for name in tree:
        assert torch.equal(getattr(got.inst_bvh, name),
                           getattr(scene.inst_bvh, name)), name


@pytest.mark.parametrize("mesh", ["sphere", "random"])
@pytest.mark.parametrize("max_leaf", [8, 24])
def test_numpy_bvh_builder_equal(mesh, max_leaf):
    cm = (chip_smoke.make_scene(1, bands=20).meshes[0] if mesh == "sphere"
          else random_mesh(9, 400))
    ref = jax_bvh._build_bvh_py(cm.v0, cm.e1, cm.e2, max_leaf)
    got = build_bvh(cm.v0, cm.e1, cm.e2, max_leaf, native=False)
    for name in ("bounds", "meta", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    assert got.depth == ref.depth


def test_build_scene_bvh_equal():
    """Against the JAX bundle, each package with its default builder (the
    native one, whose leaf triangle order is not the numpy builder's)."""
    meshes, _, _ = scene_inputs()
    ref = jax_scene_accel.build_scene_bvh(meshes)
    got = build_scene_bvh(meshes, device="cpu")
    for name in ("bounds", "meta", "tri", "leaf2global", "mesh_root"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.num_meshes == ref.num_meshes == 2
