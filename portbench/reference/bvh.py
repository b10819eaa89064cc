"""The triangle BVH the roofline's work is counted over: a frozen copy
of gravit_tpu_torch/accel/bvh.py's numpy builder (binned SAH, 16 bins,
leaves of at most 8 triangles, the right child pushed first). The
program's default, native builder gives the same node table (another leaf
order), so the count follows the tree the kernel walks; kept here so that
a change to the program cannot move it.

Node layout (flat arrays, root = 0):
  bounds (Nn, 8)  f32: lo.xyz, hi.xyz, pad, pad
  meta   (Nn, 4)  i32: [left|tri_start, right|tri_count, is_leaf, axis]
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_LEAF = 8
SAH_BINS = 16


@dataclasses.dataclass
class FlatBVH:
    bounds: np.ndarray   # (Nn, 8) f32
    meta: np.ndarray     # (Nn, 4) i32
    order: np.ndarray    # (T,) i32: leaf-order position -> original tri id
    depth: int


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
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
