"""Triangle BVH: host-side builder producing flat arrays for the traversal
kernel. A copy of gravit_tpu/accel/bvh.py: the native C++ builder
(native/gravit_host.cpp) by default, the numpy builder when the native
library cannot be built. The two give the same node table but another leaf
triangle order, so the default matters: it is the JAX package's.

Reference analog: GraviT's only BVH is over *instances* (data/accel/BVH.cpp,
SAH with exhaustive edge splits, leaf=1) — triangle acceleration lived
inside Embree. Here triangles get a binned-SAH BVH flattened into SoA
arrays that the packet-traversal kernel walks: node bounds in one
f32 table, topology/leaf ranges in one i32 table, triangles reordered
leaf-contiguous so a leaf is one dense (v0, e1, e2) slice.

Node layout (flat arrays, root = 0):
  bounds (Nn, 8)  f32: lo.xyz, hi.xyz, pad, pad
  meta   (Nn, 4)  i32: [left|tri_start, right|tri_count, is_leaf, axis]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gravit_tpu_torch import native as native_lib

MAX_LEAF = 8
LEAF_PAD_ROWS = 8   # kernel reads leaf slices 8 rows at a time
SAH_BINS = 16


@dataclasses.dataclass
class FlatBVH:
    bounds: np.ndarray   # (Nn, 8) f32
    meta: np.ndarray     # (Nn, 4) i32
    order: np.ndarray    # (T,) i32: leaf-order position -> original tri id
    depth: int

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              max_leaf: int = MAX_LEAF, native: bool = True) -> FlatBVH:
    if native:
        out = native_lib.build_bvh_native(v0, e1, e2, max_leaf)
        if out is not None:
            bounds, meta, order, depth = out
            return FlatBVH(bounds=bounds, meta=meta, order=order,
                           depth=depth)
    return _build_bvh_py(v0, e1, e2, max_leaf)


def _build_bvh_py(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                  max_leaf: int = MAX_LEAF) -> FlatBVH:
    t = v0.shape[0]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T, 3, 3)
    tri_lo = verts.min(axis=1)
    tri_hi = verts.max(axis=1)
    centroid = (tri_lo + tri_hi) * 0.5

    bounds_list: list = []
    meta_list: list = []
    order = np.empty((t,), np.int64)
    order_pos = 0
    max_depth = 0

    # iterative build with an explicit stack of (tri_idx_array, parent_slot)
    def new_node():
        bounds_list.append(np.zeros(8, np.float32))
        meta_list.append(np.zeros(4, np.int32))
        return len(bounds_list) - 1

    root = new_node()
    stack = [(np.arange(t), root, 0)]
    while stack:
        idx, slot, depth = stack.pop()
        max_depth = max(max_depth, depth)
        lo = tri_lo[idx].min(axis=0)
        hi = tri_hi[idx].max(axis=0)
        bounds_list[slot][:3] = lo
        bounds_list[slot][3:6] = hi

        if len(idx) <= max_leaf or depth >= 60:
            start = order_pos
            order[start:start + len(idx)] = idx
            order_pos += len(idx)
            meta_list[slot][:] = (start, len(idx), 1, 0)
            continue

        c = centroid[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 0:
            # all centroids coincide: split in half arbitrarily
            half = len(idx) // 2
            left_idx, right_idx = idx[:half], idx[half:]
        else:
            # binned SAH
            cmin = c[:, axis].min()
            scale = SAH_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - cmin) * scale).astype(np.int64),
                              SAH_BINS - 1)
            counts = np.bincount(bins, minlength=SAH_BINS)
            bin_lo = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in range(SAH_BINS):
                sel = bins == b
                if counts[b]:
                    bin_lo[b] = tri_lo[idx[sel]].min(axis=0)
                    bin_hi[b] = tri_hi[idx[sel]].max(axis=0)

            def sa(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                            + d[..., 2] * d[..., 0])

            # prefix/suffix sweeps
            lcount = np.cumsum(counts)[:-1]
            rcount = len(idx) - lcount
            llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            cost = sa(llo, lhi) * lcount + sa(rlo, rhi) * rcount
            cost = np.where((lcount == 0) | (rcount == 0), np.inf, cost)
            split_bin = int(np.argmin(cost))
            go_left = bins <= split_bin
            left_idx, right_idx = idx[go_left], idx[~go_left]
            if len(left_idx) == 0 or len(right_idx) == 0:
                half = len(idx) // 2
                left_idx, right_idx = idx[:half], idx[half:]

        lslot = new_node()
        rslot = new_node()
        meta_list[slot][:] = (lslot, rslot, 0, axis)
        # push right first so left pops first (near-first-ish DFS layout)
        stack.append((right_idx, rslot, depth + 1))
        stack.append((left_idx, lslot, depth + 1))

    return FlatBVH(
        bounds=np.stack(bounds_list),
        meta=np.stack(meta_list),
        order=order.astype(np.int32),
        depth=max_depth,
    )


def bvh_intersect_numpy(bvh: FlatBVH, v0, e1, e2, o, d, tnear=1e-6,
                        tfar=np.inf):
    """Scalar reference traversal (testing oracle). o, d: (3,) single ray.
    v0/e1/e2 must already be in LEAF ORDER (i.e. indexed by bvh.order)."""
    inv = np.where(d != 0, 1.0 / d, np.inf)
    best = (np.inf, -1, 0.0, 0.0)
    stack = [0]
    while stack:
        ni = stack.pop()
        lo = bvh.bounds[ni][:3]
        hi = bvh.bounds[ni][3:6]
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        near = np.maximum.reduce(np.minimum(t0, t1))
        far = np.minimum.reduce(np.maximum(t0, t1))
        if not (far >= near and near < best[0] and far > tnear):
            continue
        left, right, is_leaf, _ = bvh.meta[ni]
        if is_leaf:
            for k in range(left, left + right):
                h = _mt_scalar(o, d, v0[k], e1[k], e2[k], tnear, best[0])
                if h is not None:
                    best = (h[0], k, h[1], h[2])
        else:
            stack.append(int(right))
            stack.append(int(left))
    return best


def _mt_scalar(o, d, v0, e1, e2, tnear, tbest):
    p = np.cross(d, e2)
    det = float(e1 @ p)
    if det == 0.0:
        return None
    inv_det = 1.0 / det
    tv = o - v0
    u = float(tv @ p) * inv_det
    if u < 0 or u > 1:
        return None
    q = np.cross(tv, e1)
    v = float(d @ q) * inv_det
    if v < 0 or u + v > 1:
        return None
    t = float(e2 @ q) * inv_det
    if t <= tnear or t >= tbest:
        return None
    return t, u, v
