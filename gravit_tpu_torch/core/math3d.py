"""Small-vector math, counterpart of gravit_tpu/core/math3d.py.

The 3-vector helpers work on `(..., 3)` tensors and write their sums out
left to right (the order XLA's reduce takes), so results do not depend on a
backend's reduction order. The transform builders are host-side numpy.
Reference semantics: src/gvt/core/Math.h; instance transforms as
SimpleApp.cpp:170-172 and api.cpp:303-306 build them.
"""

from __future__ import annotations

import numpy as np
import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last (size-3) axis of a * b, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def norm3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(a, a))


def mat4_translate_scale(t, s):
    """T @ S composite, matching glm::scale(glm::translate(I, t), s)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag(np.asarray(s, dtype=np.float32))
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def normal_matrix(m):
    """transpose(inverse(mat3(m))) as in reference api.cpp:303-306."""
    m = np.asarray(m, dtype=np.float32)
    return np.transpose(np.linalg.inv(m[:3, :3])).astype(np.float32)


def aabb_intersect(lo, hi, origin, inv_dir, t_limit, update_eps: bool):
    """Slab test of rays against one-or-many AABBs, reference semantics
    (RayPacketIntersection<N>::intersect, actor/RayPacket.h:110-203): hit
    iff `tfar > tnear` AND (when `update_eps`) `tnear > RAY_EPSILON` AND
    `t_limit > tnear`. Arguments broadcast on leading axes, the last is
    xyz. Returns (hit_mask, tnear)."""
    lo_t = (lo - origin) * inv_dir
    hi_t = (hi - origin) * inv_dir
    tnear = torch.minimum(lo_t, hi_t).amax(dim=-1)
    tfar = torch.maximum(lo_t, hi_t).amin(dim=-1)
    hit = tfar > tnear
    if update_eps:
        hit = hit & (tnear > 1e-6)
    return hit & (t_limit > tnear), tnear


def aabb_entry_exit(lo, hi, origin, inv_dir):
    """Entry/exit distances of rays vs AABB (for volume brick clipping)."""
    lo_t = (lo - origin) * inv_dir
    hi_t = (hi - origin) * inv_dir
    return (torch.minimum(lo_t, hi_t).amax(dim=-1),
            torch.maximum(lo_t, hi_t).amin(dim=-1))


def merge_aabbs(los, his):
    """Union of a set of AABBs -> (lo, hi). numpy, host-side."""
    return np.min(np.asarray(los), axis=0), np.max(np.asarray(his), axis=0)


def aabb_surface_area(lo, hi):
    d = np.maximum(np.asarray(hi) - np.asarray(lo), 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])
