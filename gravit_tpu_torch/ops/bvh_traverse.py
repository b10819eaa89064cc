"""Packet BVH traversal + Möller-Trumbore leaf tests: the kernel wrapper and
its plain PyTorch version.

Replaces gravit_tpu/ops/pallas_bvh.py::_traverse_kernel in its closest-hit
(K1), any-hit (K2) and table-in-HBM (K3) forms with one CUDA kernel,
`csrc/bvh_traverse.cu`. Its roofline bound on the card is fp32 arithmetic
on node and triangle tests (the tables are read at one address per block,
broadcasts served from L1/L2); this first version is latency-bound, at ~3%
of that bound (PERF.md). The 6 MB VMEM split of the TPU kernel has no
counterpart: the table always lives in global memory.

A block of PACKET=1024 rays traverses the BVH together with one shared
stack: a node is entered iff ANY live lane passes its slab test, the near
child (by the sign of the block's summed direction on the split axis) is
popped first, and every live lane tests every leaf the block enters. Those
packet rules decide which of two equal-t hits wins, so the kernel and the
plain version keep them exactly.

`bvh_intersect` runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. `impl="plain"` runs the plain
version on the card explicitly (for comparisons).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gravit_tpu_torch.core.rays import FLT_MAX
from gravit_tpu_torch.ops import _build

PACKET = 1024         # rays per block (one thread each)
STACK_DEPTH = 96
LEAF_PAD = 8          # leaf triangle rows are tested 8 at a time
BIG = 1e30

# kernel launches since the last reset_launch_counts(); counted where the
# kernel is launched and nowhere else
launches_closest = 0
launches_any_hit = 0


def reset_launch_counts() -> None:
    global launches_closest, launches_any_hit
    launches_closest = 0
    launches_any_hit = 0


class Traversal(NamedTuple):
    """Raw traversal output: misses keep prim == -1 and t == their t_far."""

    t: torch.Tensor            # (N,) f32
    prim: torch.Tensor         # (N,) i32, LEAF order
    u: torch.Tensor            # (N,) f32
    v: torch.Tensor            # (N,) f32
    node_visits: torch.Tensor  # (N//PACKET,) i32 nodes popped per block
    tri_rows: torch.Tensor     # (N//PACKET,) i32 triangle rows tested per
                               # block, each against all PACKET lanes


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    big = torch.where(x < 0, -BIG, BIG).to(x.dtype)
    return torch.where(torch.abs(x) < 1e-30, big, 1.0 / x)


def _check(o, d, valid, block_root, bounds, meta, tri, t_far) -> None:
    n = o.shape[0]
    want = {
        "o": (o, torch.float32, (n, 3)),
        "d": (d, torch.float32, (n, 3)),
        "valid": (valid, torch.int32, (n,)),
        "block_root": (block_root, torch.int32, (n // PACKET,)),
        "t_far": (t_far, torch.float32, (n,)),
        "bounds": (bounds, torch.float32, (bounds.shape[0], 8)),
        "meta": (meta, torch.int32, (bounds.shape[0], 4)),
        "tri": (tri, torch.float32, (tri.shape[0], 12)),
    }
    if n % PACKET:
        raise ValueError(f"ray count {n} is not a multiple of {PACKET}")
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bvh_intersect_plain(o, d, valid, block_root, bounds, meta, tri, t_far,
                       any_hit: bool = False) -> Traversal:
    """The kernel's traversal vectorized over blocks: a per-block stack
    `(nb, STACK_DEPTH)`, a stack pointer and a node-visit count per block,
    and a Python loop until every block is done. Same arithmetic, in the
    same order, as the kernel."""
    _check(o, d, valid, block_root, bounds, meta, tri, t_far)
    n = o.shape[0]
    nb = n // PACKET
    dev = o.device
    f32, i64 = torch.float32, torch.int64
    oc = [o[:, c].reshape(nb, PACKET) for c in range(3)]
    dc = [d[:, c].reshape(nb, PACKET) for c in range(3)]
    inv = [_safe_inv(x) for x in dc]
    live0 = valid.reshape(nb, PACKET) != 0
    dpos = torch.stack([x.sum(dim=1) >= 0.0 for x in dc], dim=1)   # (nb, 3)

    tb = t_far.reshape(nb, PACKET).clone()
    prim = torch.full((nb, PACKET), -1, dtype=torch.int32, device=dev)
    uu = torch.zeros((nb, PACKET), dtype=f32, device=dev)
    vv = torch.zeros((nb, PACKET), dtype=f32, device=dev)

    root = block_root.to(i64)
    stack = torch.zeros((nb, STACK_DEPTH), dtype=i64, device=dev)
    stack[:, 0] = root
    sp = torch.ones((nb,), dtype=i64, device=dev)
    visits = torch.zeros((nb,), dtype=torch.int32, device=dev)
    rows_tested = torch.zeros((nb,), dtype=torch.int32, device=dev)
    meta64 = meta.to(i64)
    cap = 4 * bounds.shape[0] + 64
    kidx = torch.arange(LEAF_PAD, dtype=i64, device=dev)

    while True:
        go = (root >= 0) & (visits < cap) & (sp > 0)
        if any_hit:
            go = go & (live0 & (prim < 0)).any(dim=1)
        act = go.nonzero().squeeze(1)
        if act.numel() == 0:
            break
        visits[act] += 1
        spa = sp[act] - 1
        node = stack[act, spa]
        bnd = bounds[node]
        o_a = [x[act] for x in oc]
        inv_a = [x[act] for x in inv]
        tn = torch.full((act.numel(), PACKET), -BIG, dtype=f32, device=dev)
        tf = torch.full((act.numel(), PACKET), BIG, dtype=f32, device=dev)
        for ax in range(3):
            a = (bnd[:, ax, None] - o_a[ax]) * inv_a[ax]
            b = (bnd[:, ax + 3, None] - o_a[ax]) * inv_a[ax]
            tn = torch.maximum(tn, torch.minimum(a, b))
            tf = torch.minimum(tf, torch.maximum(a, b))
        node_hit = live0[act] & (tf >= tn) & (tn < tb[act]) & (tf > 1e-6)
        enter = node_hit.any(dim=1)
        m = meta64[node]
        is_leaf = m[:, 2] > 0

        inner = enter & ~is_leaf
        if bool(inner.any()):
            ia, s, mi = act[inner], spa[inner], m[inner]
            axis = torch.where(mi[:, 3] == 0, 0,
                               torch.where(mi[:, 3] == 1, 1, 2))
            left_first = dpos[ia, axis]
            stack[ia, s] = torch.where(left_first, mi[:, 1], mi[:, 0])
            stack[ia, s + 1] = torch.where(left_first, mi[:, 0], mi[:, 1])
            spa = torch.where(inner, spa + 2, spa)

        leaf = enter & is_leaf
        if bool(leaf.any()):
            la = act[leaf]
            rows_tested[la] += m[leaf, 1].to(torch.int32)
            tb[la], prim[la], uu[la], vv[la] = _leaf_tests(
                [x[la] for x in oc], [x[la] for x in dc], live0[la],
                m[leaf, 0], m[leaf, 1], tri, kidx,
                tb[la], prim[la], uu[la], vv[la])
        sp[act] = torch.clamp(spa, max=STACK_DEPTH - 2)

    return Traversal(tb.reshape(n), prim.reshape(n), uu.reshape(n),
                     vv.reshape(n), visits, rows_tested)


def _leaf_tests(o, d, live, start, count, tri, kidx, tb, prim, uu, vv):
    """Möller-Trumbore of each block's leaf rows against all its lanes, 8
    rows at a time; ties inside a chunk go to the smallest row, a later
    chunk must be strictly closer."""
    f32 = torch.float32
    rdx, rdy, rdz = (x[:, None, :] for x in d)
    rox, roy, roz = (x[:, None, :] for x in o)
    nchunks = int(((count + LEAF_PAD - 1) // LEAF_PAD).max())
    last_row = tri.shape[0] - 1
    for c in range(nchunks):
        base = start + c * LEAF_PAD                          # (nl,)
        rows = torch.clamp(base[:, None] + kidx, max=last_row)
        r = tri[rows]                                        # (nl, 8, 12)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            r[:, :, k, None] for k in range(9))
        px = rdy * e2z - rdz * e2y
        py = rdz * e2x - rdx * e2z
        pz = rdx * e2y - rdy * e2x
        det = e1x * px + e1y * py + e1z * pz
        idet = torch.where(det != 0.0, 1.0 / det, 0.0)
        tvx = rox - v0x
        tvy = roy - v0y
        tvz = roz - v0z
        u = (tvx * px + tvy * py + tvz * pz) * idet
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (rdx * qx + rdy * qy + rdz * qz) * idet
        t = (e2x * qx + e2y * qy + e2z * qz) * idet
        kvalid = (c * LEAF_PAD + kidx)[None, :] < count[:, None]   # (nl, 8)
        ok = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > 1e-6) & kvalid[:, :, None] & live[:, None, :])
        t_m = torch.where(ok, t, torch.tensor(FLT_MAX, dtype=f32,
                                              device=t.device))
        tmin = t_m.min(dim=1).values                          # (nl, P)
        kmin = torch.where(t_m == tmin[:, None, :], kidx[None, :, None],
                           LEAF_PAD).min(dim=1).values        # (nl, P)
        # + 0 turns -0 into +0, as the TPU kernel's one-hot sum does
        u_sel = torch.gather(u, 1, kmin[:, None, :]).squeeze(1) + 0.0
        v_sel = torch.gather(v, 1, kmin[:, None, :]).squeeze(1) + 0.0
        closer = tmin < tb
        tb = torch.where(closer, tmin, tb)
        prim = torch.where(closer, (base[:, None] + kmin).to(torch.int32),
                           prim)
        uu = torch.where(closer, u_sel, uu)
        vv = torch.where(closer, v_sel, vv)
    return tb, prim, uu, vv


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 6)


def _library() -> ctypes.CDLL:
    lib = _build.load("bvh_traverse")
    lib.bvh_traverse_launch.argtypes = _ARGTYPES
    lib.bvh_traverse_launch.restype = ctypes.c_int
    lib.bvh_traverse_error_string.argtypes = [ctypes.c_int]
    lib.bvh_traverse_error_string.restype = ctypes.c_char_p
    return lib


def bvh_intersect_kernel(o, d, valid, block_root, bounds, meta, tri, t_far,
                        any_hit: bool = False) -> Traversal:
    """Launch `csrc/bvh_traverse.cu` on the current stream; raises if the
    launch is refused. CUDA tensors only."""
    global launches_closest, launches_any_hit
    _check(o, d, valid, block_root, bounds, meta, tri, t_far)
    if o.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {o.device}")
    n = o.shape[0]
    nb = n // PACKET
    lib = _library()
    out = lambda dtype, shape: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=o.device)
    t, u, v = (out(torch.float32, (n,)) for _ in range(3))
    prim = out(torch.int32, (n,))
    stats = out(torch.int32, (nb, 2))
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    with torch.cuda.device(o.device):     # the launch targets this device
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.bvh_traverse_launch(
            ptr(o), ptr(d), ptr(valid), ptr(block_root), ptr(t_far),
            ptr(bounds), ptr(meta), ptr(tri), nb, bounds.shape[0],
            int(any_hit), ptr(t), ptr(prim), ptr(u), ptr(v), ptr(stats),
            ctypes.c_void_p(stream))
    if err:
        msg = lib.bvh_traverse_error_string(err).decode()
        raise RuntimeError(f"bvh_traverse launch failed: {msg} ({err})")
    if nb:
        if any_hit:
            launches_any_hit += 1
        else:
            launches_closest += 1
    return Traversal(t, prim, u, v, stats[:, 0], stats[:, 1])


def bvh_intersect(o, d, valid, block_root, bounds, meta, tri,
                  any_hit: bool = False, t_far=None, impl=None):
    """Closest (or, with any_hit, some) hit of N rays against the flat BVH,
    with the signature and return convention of the JAX package's
    `bvh_intersect`.

    o, d:        (N, 3) f32 object-space rays; N % PACKET == 0, each PACKET
                 block addressing one mesh
    valid:       (N,) i32, nonzero for live rays
    block_root:  (N//PACKET,) i32 root node per block (-1: skip block)
    bounds/meta: (Nn, 8) f32 / (Nn, 4) i32 flat BVH
    tri:         (Tp, 12) f32 leaf-ordered triangles (v0, e1, e2, pad),
                 padded by >= LEAF_PAD rows
    t_far:       (N,) f32 per-ray far bound, FLT_MAX by default
    Returns (t, prim, u, v) with prim in LEAF order; a miss gives prim -1
    and t FLT_MAX. CPU tensors run the plain version, CUDA tensors the
    kernel; impl="plain" runs the plain version on any device.
    """
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if t_far is None:
        t_far = torch.full(o.shape[:1], FLT_MAX, dtype=torch.float32,
                           device=o.device)
    run = (bvh_intersect_plain if impl == "plain" or o.device.type == "cpu"
           else bvh_intersect_kernel)
    r = run(o, d, valid, block_root, bounds, meta, tri, t_far, any_hit)
    miss = r.prim < 0
    return (torch.where(miss, FLT_MAX, r.t), torch.where(miss, -1, r.prim),
            r.u, r.v)
