"""GraviT's gvtSimple (apps/render/SimpleApp.cpp:112-186): a 5 x 5 grid of
alternating cones and cubes, scaled by 0.4 at 0.5 spacing in the x = 0
plane. Frozen copy of the geometry in gravit_tpu_torch/examples/
simple_app.py and gravit_tpu_torch/dryrun.py:56-72 (the cone's vertex
list keeps the reference's 0.43013)."""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import MeshData, SceneData, translate_scale

CONE_VERTS = [0.5, 0.0, 0.0, -0.5, 0.5, 0.0, -0.5, 0.25, 0.433013, -0.5,
              -0.25, 0.43013, -0.5, -0.5, 0.0, -0.5, -0.25, -0.433013,
              -0.5, 0.25, -0.433013]
CONE_FACES = [1, 2, 3, 1, 3, 4, 1, 4, 5, 1, 5, 6, 1, 6, 7, 1, 7, 2]
CUBE_VERTS = [-0.5, -0.5, 0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5,
              -0.5, -0.5, -0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5,
              -0.5, 0.5, 0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, 0.5,
              -0.5, -0.5, -0.5, 0.5, 0.5, -0.5, 0.5, -0.5, -0.5, -0.5, 0.5,
              -0.5, -0.5, 0.5, -0.5, 0.5, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5,
              0.5, 0.5, -0.5, -0.5, -0.5, 0.5, -0.5, 0.5, 0.5, -0.5, -0.5,
              -0.5, -0.5, 0.5, -0.5]
CUBE_FACES = [1, 2, 3, 1, 3, 4, 17, 19, 20, 17, 20, 18, 6, 5, 8, 6, 8, 7,
              23, 21, 22, 23, 22, 24, 10, 9, 11, 10, 11, 12, 13, 15, 16,
              13, 16, 14]


def _mesh(verts, faces_1based) -> MeshData:
    return MeshData(verts=np.asarray(verts, np.float32).reshape(-1, 3),
                    faces=np.asarray(faces_1based, np.int64).reshape(-1, 3)
                    - 1, kd=(1.0, 1.0, 1.0), alpha=1.0)


def scene(grid: int = 5, spacing: float = 0.5,
          scale: float = 0.4) -> SceneData:
    """Meshes [cone, cube]; instance k of the grid (row-major over i, j in
    -2..2) uses mesh k % 2 at (0, i*spacing, j*spacing)."""
    half = grid // 2
    instances = []
    k = 0
    for i in range(-half, grid - half):
        for j in range(-half, grid - half):
            instances.append((k % 2, translate_scale(
                (0.0, i * spacing, j * spacing), (scale, scale, scale))))
            k += 1
    return SceneData(meshes=[_mesh(CONE_VERTS, CONE_FACES),
                             _mesh(CUBE_VERTS, CUBE_FACES)],
                     instances=instances)
