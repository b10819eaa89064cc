"""The seeded stand-in for the Stanford bunny: a radially displaced UV
sphere over a floor quad, in one mesh. Frozen copy of chip_smoke.py's
displaced_sphere / flagship_geometry (69,938 sphere triangles at 187
bands, plus the floor's 2)."""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import MeshData, SceneData

SPHERE_RADIUS = 0.075
SPHERE_CENTER = (0.0, 0.11, 0.0)


def displaced_sphere(seed: int, bands: int):
    """(vertices, 0-based faces) of a UV sphere of `bands` latitude bands x
    `bands` longitudes (2*bands^2 triangles, poles left open) at
    SPHERE_CENTER, radially displaced by six seeded low-order waves."""
    rng = np.random.default_rng(seed)
    nlat, nlon = bands + 1, bands
    theta = np.pi * (np.arange(nlat) + 0.5) / nlat
    phi = 2.0 * np.pi * np.arange(nlon) / nlon
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    disp = np.zeros_like(th)
    for _ in range(6):
        amp = rng.uniform(0.005, 0.025)
        fa, fb = rng.integers(1, 7, size=2)
        pa, pb = rng.uniform(0.0, 2.0 * np.pi, size=2)
        disp += amp * np.sin(fa * th + pa) * np.cos(fb * ph + pb)
    r = SPHERE_RADIUS * (1.0 + disp)
    verts = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                      r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    verts = (verts + np.asarray(SPHERE_CENTER)).astype(np.float32)

    i, j = np.meshgrid(np.arange(bands), np.arange(nlon), indexing="ij")
    a = i * nlon + j
    b = i * nlon + (j + 1) % nlon
    c = (i + 1) * nlon + j
    d = (i + 1) * nlon + (j + 1) % nlon
    # counter-clockwise seen from outside: cross(e1, e2) points outward
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)])
    return verts, faces


def scene(seed: int = 0, bands: int = 187) -> SceneData:
    """One mesh (the sphere and a floor quad under it, default lambert
    material), one instance with the identity transform."""
    verts, faces = displaced_sphere(seed, bands)
    floor_y = SPHERE_CENTER[1] - 1.2 * SPHERE_RADIUS
    floor = np.asarray([[-0.6, floor_y, -0.8], [0.6, floor_y, -0.8],
                        [0.6, floor_y, 0.25], [-0.6, floor_y, 0.25]],
                       np.float32)
    nv = verts.shape[0]
    faces = np.concatenate([faces, nv + np.asarray([[0, 3, 2], [0, 2, 1]])])
    mesh = MeshData(verts=np.concatenate([verts, floor]),
                    faces=faces.astype(np.int64))
    return SceneData(meshes=[mesh],
                     instances=[(0, np.eye(4, dtype=np.float32))])
