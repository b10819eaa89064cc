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


def assert_tree_equal(a, b, path="") -> None:
    """Two host objects of the two packages are equal, field for field:
    dataclasses by field, sequences and dicts by item, arrays by value and
    shape (never by dtype name: numpy on both sides)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_tree_equal(getattr(a, f.name), getattr(b, f.name),
                              f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, (path, a, b)


def jax_volumes(volumes) -> list:
    """The JAX package's Volumes with the port Volumes' numpy fields."""
    from test_torch_volume_scene import to_jax_volume

    return [to_jax_volume(v) for v in volumes]


def bricked_wavelet(n: int = 32):
    """The wavelet of n^3 samples split into two x-bricks of n x n x
    (n/2 + 1), the right one padded by its last plane
    (tests/test_volume_domain.py::_bricked_wavelet, chip_smoke's
    bricked_wavelet): (port volumes, the same as the JAX package's)."""
    import chip_smoke

    port = chip_smoke.bricked_wavelet(n)
    return port, jax_volumes(port)


def api_volume_bricks(mod, bricks, eye, focus, film: int,
                      schedule: int) -> None:
    """Drive an api module (the port's or the JAX package's) through
    tests/test_api.py's volume scene: one volume per brick (its samples
    x-fastest, its own TF), an identity instance each, a camera at `eye`
    looking at `focus` (up +z, fov 30, depth 1), a film x film film and a
    volume renderer "vr" with `schedule`. Call mod.gvtInit first."""
    for i, b in enumerate(bricks):
        name = f"b{i}"
        mod.createVolume(name)
        mod._db().find(name)["tf"] = b.tf
        nz, ny, nx = b.samples.shape
        mod.addVolumeSamples(name, b.samples.reshape(-1), [nx, ny, nz],
                             list(b.origin), list(b.spacing), 1.0)
        mod.addInstance(f"i{i}", name,
                        np.eye(4, dtype=np.float32).flatten())
    mod.addCamera("cam", list(eye), list(focus), [0.0, 0.0, 1.0],
                  30 * np.pi / 180, 1, 1, 0.5)
    mod.addFilm("film", film, film, "out")
    mod.addRenderer("vr", int(mod.Adapter.Pvol), schedule, "cam", "film",
                    volume=True)
