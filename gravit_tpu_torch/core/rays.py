"""Ray actor state as a fixed-capacity SoA arena (a dataclass of tensors).

Counterpart of gravit_tpu/core/rays.py. Every field is an `(N,)` or `(N, 3)`
tensor on one device; dead lanes are masked by `active`, queue membership is
the integer `inst` field. Field semantics mirror actor/Ray.h:68-79:
`depth` is the remaining bounce budget and `w` the contribution.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

RAY_EPSILON = 1e-6  # actor/Ray.cpp:33
FLT_MAX = float(np.finfo(np.float32).max)
NO_INSTANCE = -1


class RayType(enum.IntEnum):
    """Surface ray types (actor/Ray.h:50-55)."""

    PRIMARY = 0
    SHADOW = 1
    SECONDARY = 2


@dataclasses.dataclass
class RayArena:
    """Fixed-capacity wavefront of rays; all tensors share leading dim N."""

    origin: torch.Tensor     # (N, 3) f32
    direction: torch.Tensor  # (N, 3) f32
    color: torch.Tensor      # (N, 3) f32
    t_max: torch.Tensor      # (N,)  f32
    t: torch.Tensor          # (N,)  f32
    w: torch.Tensor          # (N,)  f32
    id: torch.Tensor         # (N,)  i32  pixel index into the framebuffer
    depth: torch.Tensor      # (N,)  i32  bounce budget
    type: torch.Tensor       # (N,)  i32  RayType
    inst: torch.Tensor       # (N,)  i32  target instance, NO_INSTANCE if none
    prev: torch.Tensor       # (N,)  i32  instance the ray just left
    active: torch.Tensor     # (N,)  bool lane carries a live ray

    @property
    def capacity(self) -> int:
        return self.origin.shape[0]

    def replace(self, **changes) -> "RayArena":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "RayArena":
        """Apply `fn` to every field (the jax.tree.map of the reference)."""
        return RayArena(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})

    @classmethod
    def zeros(cls, n: int, device) -> "RayArena":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            origin=torch.zeros((n, 3), **f32),
            direction=torch.zeros((n, 3), **f32),
            color=torch.zeros((n, 3), **f32),
            t_max=torch.full((n,), FLT_MAX, **f32),
            t=torch.full((n,), FLT_MAX, **f32),
            w=torch.zeros((n,), **f32),
            id=torch.zeros((n,), **i32),
            depth=torch.zeros((n,), **i32),
            type=torch.zeros((n,), **i32),
            inst=torch.full((n,), NO_INSTANCE, **i32),
            prev=torch.full((n,), NO_INSTANCE, **i32),
            active=torch.zeros((n,), dtype=torch.bool, device=device),
        )
