"""Top-level instance BVH, counterpart of gravit_tpu/accel/instance_bvh.py:
log-time domain culling for the shuffle.

Reference: data/accel/BVH.cpp:77-216 builds a SAH tree over instance AABBs
(leaf = 1 instance, traversal cost 0.5, split axis = largest extent) and
BVH.h:61-135 walks it to pick each ray's next domain. The flat search over
every instance box (ops/instance_slab.py::closest_box) is O(N x I); this
tree replaces it from INSTANCE_BVH_THRESHOLD instances on.

  * Host-side binned-SAH build, the port's own numpy copy of the JAX
    package's: the same arrays, node for node.
  * Stackless skip-link flattening: nodes in preorder; a node's hit
    successor is the next node, its miss successor the skip pointer. The
    walk is one int32 pointer per ray, advanced in lock-step.
  * The leaf predicate is the flat search's (tfar > tnear, tnear >
    RAY_EPSILON, tnear < t_max, inst != exclude, lowest index on equal
    tnear), so tree and flat shuffles agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from gravit_tpu_torch.core.rays import FLT_MAX, RAY_EPSILON
from gravit_tpu_torch.core.timing import span
from gravit_tpu_torch.device import resolve_device

SAH_BINS = 16
# the walk tests for live pointers once per this many steps
CHECK_EVERY = 8


@dataclasses.dataclass
class InstanceBVH:
    node_lo: torch.Tensor   # (Nn, 3) f32
    node_hi: torch.Tensor   # (Nn, 3) f32
    inst_id: torch.Tensor   # (Nn,) i32: instance at a leaf, -1 interior
    miss: torch.Tensor      # (Nn,) i32: next node on miss / after a leaf

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]


def build_instance_arrays(lo: np.ndarray, hi: np.ndarray) -> dict:
    """Binned SAH over instance AABBs, flattened in preorder with skip
    links; returns the four arrays as numpy."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    n = lo.shape[0]
    centroid = (lo + hi) * 0.5
    node_lo, node_hi, inst_id, miss = [], [], [], []

    def sa(a, b) -> float:
        return float(np.prod(np.maximum(b - a, 0))) or 1e-30

    def emit(ids: np.ndarray, miss_ptr: int) -> int:
        """Append the subtree over `ids`; returns its root index.
        `miss_ptr` is the node to visit after this subtree."""
        me = len(node_lo)
        node_lo.append(lo[ids].min(axis=0))
        node_hi.append(hi[ids].max(axis=0))
        miss.append(miss_ptr)
        if ids.size == 1:
            inst_id.append(int(ids[0]))
            return me
        inst_id.append(-1)
        c = centroid[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))           # largest extent (BVH.cpp:112)
        if ext[axis] <= 0:
            half = ids.size // 2
            left_ids, right_ids = ids[:half], ids[half:]
        else:
            rel = (c[:, axis] - c[:, axis].min()) / ext[axis]
            bins = np.minimum((rel * SAH_BINS).astype(np.int32),
                              SAH_BINS - 1)
            best_cost, best_split = np.inf, None
            for s in range(1, SAH_BINS):
                lmask = bins < s
                nl = int(lmask.sum())
                if nl == 0 or nl == ids.size:
                    continue
                # SAH cost shape of BVH.cpp:39-40 (leaf 1, traversal 0.5)
                cost = (0.5 + sa(lo[ids[lmask]].min(axis=0),
                                 hi[ids[lmask]].max(axis=0)) * nl
                        + sa(lo[ids[~lmask]].min(axis=0),
                             hi[ids[~lmask]].max(axis=0)) * (ids.size - nl))
                if cost < best_cost:
                    best_cost, best_split = cost, s
            if best_split is None:
                half = ids.size // 2
                order = np.argsort(c[:, axis], kind="stable")
                left_ids, right_ids = ids[order[:half]], ids[order[half:]]
            else:
                lmask = bins < best_split
                left_ids, right_ids = ids[lmask], ids[~lmask]
        # the left child sits at me + 1 and skips to the right child, which
        # skips to this node's own miss pointer
        left_root = emit(left_ids, miss_ptr=-2)
        right_root = emit(right_ids, miss_ptr=miss_ptr)
        for k in range(left_root, right_root):
            if miss[k] == -2:
                miss[k] = right_root
        return me

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        emit(np.arange(n), -1)
    finally:
        sys.setrecursionlimit(old_limit)
    return dict(node_lo=np.stack(node_lo), node_hi=np.stack(node_hi),
                inst_id=np.array(inst_id, np.int32),
                miss=np.array(miss, np.int32))


def build_instance_bvh(lo: np.ndarray, hi: np.ndarray,
                       device=None) -> InstanceBVH:
    """The tree over instance AABBs `lo`, `hi` (I, 3), on `device`."""
    device = resolve_device(device)
    arrays = build_instance_arrays(lo, hi)
    return InstanceBVH(**{k: torch.as_tensor(v, device=device)
                          for k, v in arrays.items()})


def _step(bvh: InstanceBVH, ptr, best_t, best_i, origin, inv_dir, t_max,
          exclude):
    """One lock-step move of every ray's pointer."""
    node = ptr.clamp(min=0).to(torch.int64)
    lo = bvh.node_lo[node]
    hi = bvh.node_hi[node]
    l = (lo - origin) * inv_dir  # noqa: E741
    u = (hi - origin) * inv_dir
    tnear = torch.minimum(l, u).max(dim=-1).values
    tfar = torch.maximum(l, u).min(dim=-1).values
    inst = bvh.inst_id[node]
    is_leaf = inst >= 0
    leaf_ok = (is_leaf & (tfar > tnear) & (tnear > RAY_EPSILON)
               & (tnear < t_max) & (inst != exclude)
               & ((tnear < best_t) | ((tnear == best_t) & (inst < best_i))))
    best_t = torch.where(leaf_ok, tnear, best_t)
    best_i = torch.where(leaf_ok, inst, best_i)
    # descend iff the subtree could still hold a better leaf; an interior
    # tnear can be <= RAY_EPSILON while a leaf inside is not
    descend = (~is_leaf & (tfar >= tnear) & (tfar > RAY_EPSILON)
               & (tnear < t_max) & (tnear <= best_t))
    nxt = torch.where(descend, node.to(torch.int32) + 1, bvh.miss[node])
    return torch.where(ptr < 0, -1, nxt), best_t, best_i


def _any_live(ptr: torch.Tensor) -> bool:
    """Whether a pointer still walks: the walk waits for the card here."""
    live = (ptr >= 0).any()
    with span("tracer.sync"):
        return live.item()


def closest_instance(bvh: InstanceBVH, origin: torch.Tensor,
                     inv_dir: torch.Tensor, t_max: torch.Tensor,
                     exclude: torch.Tensor, active: torch.Tensor,
                     check_every: int = CHECK_EVERY):
    """Per-ray closest instance AABB (BVH::intersect update=true
    semantics). Returns (found, inst, t_entry) equal to the flat search's:
    the smallest tnear wins, the lowest instance id breaks ties, `exclude`
    is skipped; `inst` is -1 where nothing was found.

    The JAX package's while_loop is a host loop that tests for a live
    pointer once every `check_every` steps (one host sync each), so up to
    check_every - 1 steps run after the last pointer ended. Those steps
    are exact no-ops: a finished ray keeps ptr = -1, it reads node 0, and
    node 0 is an interior node whenever the tree exists (build_scene
    builds it only for more than one instance), so neither best_t nor
    best_i can change. A one-box tree (node 0 a leaf) needs
    check_every=1.
    """
    n = origin.shape[0]
    dev = origin.device
    ptr = torch.where(active, 0, -1).to(torch.int32)
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    while _any_live(ptr):
        for _ in range(check_every):
            ptr, best_t, best_i = _step(bvh, ptr, best_t, best_i, origin,
                                        inv_dir, t_max, exclude)
    return best_i >= 0, best_i, best_t
