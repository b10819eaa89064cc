"""Shared helpers of the port's multi-instance parity tests: carrying the
JAX package's scenes, rays and BVH arrays across as numpy, and the frame
tolerances of the multi-instance tracers."""

import contextlib
import dataclasses
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gravit_tpu.accel.scene_accel import build_scene_bvh as jax_build_bvh  # noqa: E402
from gravit_tpu.render.scene_build import build_scene as jax_build_scene  # noqa: E402
from gravit_tpu.scene.camera import PerspectiveCamera as JaxCamera  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.scene import image  # noqa: E402


@contextlib.contextmanager
def pallas_interpret():
    """GRAVIT_PALLAS_INTERPRET=1 for the block, the old value restored."""
    prev = os.environ.get("GRAVIT_PALLAS_INTERPRET")
    os.environ["GRAVIT_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("GRAVIT_PALLAS_INTERPRET", None)
        else:
            os.environ["GRAVIT_PALLAS_INTERPRET"] = prev


def leaves(x, skip=("inst_bvh",)) -> dict:
    """The numpy arrays of a JAX dataclass, by field name."""
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if f.name not in skip
            and not isinstance(getattr(x, f.name),
                               (int, bool, tuple, type(None)))}


def jax_scene(spec, **kw):
    return jax_build_scene(spec.meshes, spec.instances, spec.lights, **kw)


def jax_rays(camera):
    return JaxCamera(**dataclasses.asdict(camera)).generate_rays()


def port_scene(jscene):
    """The JAX scene carried into the port, its instance tree included."""
    static = {k: getattr(jscene, k) for k in (
        "num_instances", "num_lights", "num_meshes", "mesh_tri_offset",
        "mesh_tri_count", "has_embree_materials", "has_specular")}
    tree = None if jscene.inst_bvh is None else leaves(jscene.inst_bvh)
    return interop.scene_from_numpy(leaves(jscene), "cpu", inst_bvh=tree,
                                    **static)


def port_rays(jrays):
    return interop.rays_from_numpy(leaves(jrays), "cpu")


def bvh_pair(meshes):
    """(the JAX package's BVH, the same arrays in the port)."""
    jacc = jax_build_bvh(meshes)
    return jacc, interop.bvh_from_numpy(leaves(jacc), jacc.num_meshes, "cpu")


def frame_diff(a, b, w: int, h: int) -> dict:
    a, b = np.asarray(a), np.asarray(b)
    ba, bb = image.to_rgb8(a, w, h), image.to_rgb8(b, w, h)
    d = np.abs(a[:, :3] - b[:, :3]).max(axis=1)
    return dict(byte_frac=float(np.mean(ba != bb)), float_max=float(d.max()),
                float_mean=float(d.mean()),
                pix_over_1e5=float(np.mean(d > 1e-5)))


def assert_multi_close(a, b, w: int, h: int) -> None:
    """The multi-instance frames' tolerance against the JAX package:
    float |d| <= 1e-5 on at least 99.9% of pixels, mean |d| <= 1e-4, at
    most 0.5% of bytes differing. Not bit-equal: XLA's CPU backend
    contracts a*b+c into fused multiply-adds and the port rounds each
    operation, so a bumped origin (t_entry * 0.95) or a shading sum can
    move by an ulp, and a grazing hop or shadow test can then go the
    other way."""
    diff = frame_diff(a, b, w, h)
    assert diff["pix_over_1e5"] <= 1e-3, diff
    assert diff["float_mean"] <= 1e-4, diff
    assert diff["byte_frac"] <= 5e-3, diff


def lit(fb) -> float:
    return float((np.asarray(fb)[:, :3].sum(axis=1) > 0).mean())


def jax_camera(camera):
    """The JAX package's camera with the port camera's fields."""
    return JaxCamera(**dataclasses.asdict(camera))


def jax_mesh(shape, axes=("domains",)):
    """A JAX device mesh over the first prod(shape) of the 8 virtual CPU
    devices (tests/conftest.py)."""
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def grid_instances(mesh_of, n: int = 5, spacing: float = 0.5,
                   scale: float = 0.4):
    """SimpleApp's n x n instance grid on x = 0 (SimpleApp.cpp:164-186),
    instance k using mesh `mesh_of(k)`."""
    from gravit_tpu_torch.core.math3d import mat4_translate_scale
    from gravit_tpu_torch.render.scene_build import Instance

    half = n // 2
    cells = [(i, j) for i in range(-half, n - half)
             for j in range(-half, n - half)]
    return [Instance(mesh_id=mesh_of(k), m=mat4_translate_scale(
        (0.0, i * spacing, j * spacing), (scale,) * 3))
        for k, (i, j) in enumerate(cells)]
