"""Ray-triangle intersection (Möller-Trumbore), counterpart of
gravit_tpu/ops/intersect.py: the brute-force wavefront path used when no BVH
is given (`accel=None`), and the oracle the traversal kernel is tested
against.

The wavefront `(N,)` is intersected against triangle tiles `(TT,)` as
`(N, TT)` tensors, reduced tile by tile. Every ray carries a mesh id; a
triangle only competes for rays whose mesh matches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gravit_tpu_torch.core.math3d import cross3, dot3
from gravit_tpu_torch.core.rays import FLT_MAX, RAY_EPSILON


class Hit(NamedTuple):
    t: torch.Tensor      # (N,) f32, FLT_MAX on miss
    prim: torch.Tensor   # (N,) i32, -1 on miss
    u: torch.Tensor      # (N,) f32 barycentric (edge1 axis)
    v: torch.Tensor      # (N,) f32 barycentric (edge2 axis)


def moller_trumbore(o, d, v0, e1, e2, tnear, tfar):
    """Batched Möller-Trumbore. o/d: (..., 3); v0/e1/e2: (..., 3)
    broadcastable. No backface culling (Embree default). Returns
    (hit, t, u, v)."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    det_safe = torch.where(det == 0.0, 1.0, det)
    inv_det = torch.where(det != 0.0, 1.0 / det_safe, 0.0)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tnear) & (t < tfar))
    return hit, t, u, v


def intersect_closest(o, d, ray_mesh, active, tri_v0, tri_e1, tri_e2,
                      tri_mesh, tile: int = 2048) -> Hit:
    """Closest hit of object-space rays against the global triangle soup.

    Semantics match Embree tnear=RAY_EPSILON, tfar=FLT_MAX
    (EmbreeMeshAdapter.cpp:277-278). Within a tile the first index wins a
    tie (argmin); across tiles a later tile must be strictly closer. The
    winner's t, u, v are read with `gather`, whose backward is a
    scatter-add (advanced indexing's backward sorts its indices: 50 ms a
    call at 655,360 x 18 on an H100).
    """
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    live = active & (ray_mesh >= 0)
    for s in range(0, tri_v0.shape[0], tile):
        sl = slice(s, s + tile)
        hit, t, u, v = moller_trumbore(
            o[:, None, :], d[:, None, :], tri_v0[None, sl], tri_e1[None, sl],
            tri_e2[None, sl], RAY_EPSILON, FLT_MAX)
        hit = hit & (tri_mesh[None, sl] == ray_mesh[:, None]) & live[:, None]
        t = torch.where(hit, t, FLT_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)
        t_j = t.gather(1, j)[:, 0]
        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        best_p = torch.where(closer, (j[:, 0] + s).to(torch.int32), best_p)
        best_u = torch.where(closer, u.gather(1, j)[:, 0], best_u)
        best_v = torch.where(closer, v.gather(1, j)[:, 0], best_v)
    return Hit(best_t, best_p, best_u, best_v)


def intersect_any(o, d, ray_mesh, active, tri_v0, tri_e1, tri_e2, tri_mesh,
                  tile: int = 2048) -> torch.Tensor:
    """Any-hit (occlusion) test of object-space rays against the triangle
    soup; returns (N,) bool occluded. Shadow quirk parity: the direction is
    unnormalized and tfar=FLT_MAX (EmbreeMeshAdapter.cpp:277-278 sets it
    even for occlusion), so occluders beyond the light also block."""
    occluded = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    live = active & (ray_mesh >= 0)
    for s in range(0, tri_v0.shape[0], tile):
        sl = slice(s, s + tile)
        hit, _, _, _ = moller_trumbore(
            o[:, None, :], d[:, None, :], tri_v0[None, sl], tri_e1[None, sl],
            tri_e2[None, sl], RAY_EPSILON, FLT_MAX)
        hit = hit & (tri_mesh[None, sl] == ray_mesh[:, None]) & live[:, None]
        occluded = occluded | hit.any(dim=1)
    return occluded
