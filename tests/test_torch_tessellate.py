"""The port's tessellation (gravit_tpu_torch/scene/tessellate.py, the qhull
replacement of api.cpp:143-170) against the JAX package's: the convex hull
of a cube with an interior point and of points on a sphere, the 2.5-D
Delaunay triangulation of a grid and of a seeded terrain cloud, and the
api's addMeshVertices(tessellate=True) in both dialects. Numpy host code
copied into the port: every triangle list must be equal, in order."""

import numpy as np
import pytest

import torch_parity  # noqa: F401,I001 (puts the repo root on sys.path)
from gravit_tpu import api as japi
from gravit_tpu.scene import tessellate as jtess

from gravit_tpu_torch import api
from gravit_tpu_torch.scene import tessellate as tess


def cube_points():
    return np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)] + [[0.5, 0.5, 0.5]], np.float64)


def sphere_points(n=80, seed=0):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def test_convex_hull_cube_equal_jax():
    pts = cube_points()
    tris = tess.convex_hull(pts)
    assert tris == jtess.convex_hull(pts)
    assert len(tris) == 12 and all(8 not in t for t in tris)
    c = pts[:8].mean(axis=0)
    for a, b, d in tris:       # every normal points outward
        assert np.cross(pts[b] - pts[a], pts[d] - pts[a]) @ (pts[a] - c) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_convex_hull_sphere_equal_jax(seed):
    pts = sphere_points(seed=seed)
    tris = tess.convex_hull(pts)
    assert tris == jtess.convex_hull(pts)
    edges = {}
    for t in tris:
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            k = (min(e), max(e))
            edges[k] = edges.get(k, 0) + 1
    assert all(v == 2 for v in edges.values())     # closed 2-manifold
    assert len({i for t in tris for i in t}) - len(edges) + len(tris) == 2


def test_delaunay_grid_equal_jax():
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(4.0))
    pts = np.stack([xs.ravel(), ys.ravel(), 0.1 * xs.ravel() * ys.ravel()],
                   axis=1)
    tris = tess.delaunay_2_5d(pts)
    assert tris == jtess.delaunay_2_5d(pts)
    assert len(tris) == 18 and {i for t in tris for i in t} == set(range(16))


def test_delaunay_terrain_equal_jax():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 10, (40, 2))
    pts = np.concatenate([xy, np.sin(xy[:, :1]) * 0.3], axis=1)
    assert tess.delaunay_2_5d(pts) == jtess.delaunay_2_5d(pts)


@pytest.mark.parametrize("qhullargs", ["hull", "d Qz", ""])
def test_api_tessellate_equal_jax(qhullargs):
    """"d"-style arguments (and the default "d Qz") triangulate in 2.5-D,
    anything else takes the hull; the faces land in the mesh 0-based."""
    pts = np.concatenate([cube_points()[:8],
                          sphere_points(12, seed=2) * 0.4 + 0.5])
    pts = pts.astype(np.float32)
    faces = []
    for mod in (api, japi):
        mod.gvtInit()
        mod.createMesh("cloud")
        mod.addMeshVertices("cloud", len(pts), pts.ravel(), tessellate=True,
                            qhullargs=qhullargs)
        mod.finishMesh("cloud")
        faces.append(list(mod._db().find("cloud")["ptr"].faces))
    assert faces[0] == faces[1] and len(faces[0]) > 0
    if qhullargs == "hull":
        assert len(faces[0]) == 12      # the cube's hull: the sphere inside
