"""Light table: point / ambient / area lights as a fixed SoA bundle.

Counterpart of gravit_tpu/scene/light.py (numpy host side). Reference:
data/scene/Light.{h,cpp}. Falloff is min(1, 1/d) for point and area lights
(Light.cpp:58-62,129-133); area lights sample a rectangle in the (u, w)
frame derived from the light normal (Light.cpp:92-128).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class LightKind(enum.IntEnum):
    POINT = 0
    AMBIENT = 1
    AREA = 2


@dataclasses.dataclass
class Light:
    kind: int
    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    normal: tuple = (0.0, 1.0, 0.0)
    width: float = 0.0
    height: float = 0.0


def point_light(position, color) -> Light:
    return Light(int(LightKind.POINT), tuple(position), tuple(color))


def ambient_light(color) -> Light:
    return Light(int(LightKind.AMBIENT), color=tuple(color))


def area_light(position, color, normal, width, height) -> Light:
    return Light(int(LightKind.AREA), tuple(position), tuple(color),
                 tuple(normal), float(width), float(height))


@dataclasses.dataclass
class LightBundle:
    """SoA host bundle; the light count is static so the per-light shadow
    loop unrolls in Python."""

    kind: np.ndarray      # (L,) int32
    position: np.ndarray  # (L, 3)
    color: np.ndarray     # (L, 3)
    u: np.ndarray         # (L, 3) area-light basis
    w: np.ndarray         # (L, 3)
    width: np.ndarray     # (L,)
    height: np.ndarray    # (L,)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def _area_basis(normal):
    """AreaLight ctor basis (Light.cpp:92-112): u = up x n, w = n x u."""
    v = np.asarray(normal, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    if np.array_equal(v, up):
        return np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])
    u = np.cross(up, v)
    w = np.cross(v, u)
    return u, w


def bundle_lights(lights: Sequence[Light]) -> LightBundle:
    """At least one slot: an empty scene gets one light of kind -1."""
    lights = list(lights or [])
    L = max(1, len(lights))
    kind = np.full((L,), -1, np.int32)
    pos = np.zeros((L, 3), np.float32)
    col = np.zeros((L, 3), np.float32)
    u = np.zeros((L, 3), np.float32)
    w = np.zeros((L, 3), np.float32)
    width = np.zeros((L,), np.float32)
    height = np.zeros((L,), np.float32)
    for i, light in enumerate(lights):
        kind[i] = light.kind
        pos[i] = light.position
        col[i] = light.color
        width[i] = light.width
        height[i] = light.height
        if light.kind == int(LightKind.AREA):
            bu, bw = _area_basis(light.normal)
            u[i], w[i] = bu.astype(np.float32), bw.astype(np.float32)
    return LightBundle(kind, pos, col, u, w, width, height)
