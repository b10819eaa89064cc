"""The plain scene description every generator returns and both sides of
the benchmark take: the program through its own builders, the reference
through portbench/reference/."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    verts: np.ndarray          # (V, 3) float32, object space
    faces: np.ndarray          # (T, 3) int64, 0-based vertex ids
    kd: tuple = (0.5, 0.5, 0.5)
    alpha: float = 1.0
    mat_type: int = 0          # 0: lambert


@dataclasses.dataclass
class SceneData:
    meshes: list               # [MeshData]
    instances: list            # [(mesh index, (4, 4) float32 row-major)]

    @property
    def num_triangles(self) -> int:
        return sum(len(m.faces) for m in self.meshes)


def translate_scale(t, s) -> np.ndarray:
    """glm::scale(glm::translate(I, t), s) as a row-major 4x4."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag(np.asarray(s, np.float32))
    m[:3, 3] = np.asarray(t, np.float32)
    return m
