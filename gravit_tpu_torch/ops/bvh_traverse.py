"""Packet BVH traversal + Möller-Trumbore leaf tests: the kernel wrapper and
its plain PyTorch version.

Replaces gravit_tpu/ops/pallas_bvh.py::_traverse_kernel in its closest-hit
(K1), any-hit (K2) and table-in-HBM (K3) forms with one CUDA source,
`csrc/bvh_traverse.cu`. The 6 MB VMEM split of the TPU kernel has no
counterpart: the table always lives in global memory.

The function. A PACKET of 1024 consecutive rays shares one traversal
ORDER: at every inner node the near child, by the sign of the packet's
summed direction on the node's split axis, is visited first, so the leaves
can be met in one fixed depth-first order per packet. The sum runs in one
fixed order on every device (`packet_direction_signs`, the kernel's): a
packet whose sum lies within rounding of zero, such as two film rows of a
camera centred on the view axis, takes its sign from that order. A ray's answer is the
first closest hit along that order: a later leaf must be strictly closer,
and inside a chunk of LEAF_PAD rows the smallest row wins a tie.

The voting group. Which nodes of that order are entered is decided by a
vote: a node is entered iff ANY live lane of the group passes its slab
test, and every live lane of the group tests every leaf the group enters.
The TPU kernel votes over the whole packet (`group=PACKET`). The CUDA
kernel votes over a warp (`group=GROUP`, 32 consecutive lanes), with the
PACKET's direction signs. That is the same function: a leaf in which a lane
hits nothing closer leaves its answer alone, and a lane can only hit inside
boxes its own slab test passes, so a smaller group that walks the same
order skips only leaves that could not change its lanes' answers.

In float32 that last premise fails on the box's faces: a ray aimed exactly
at a vertex or at the floor's zero-height box can hit a triangle
(Möller-Trumbore) inside a leaf whose box its own slab test rejects by a
rounding, and the packet-wide vote still enters that leaf on a
neighbour's test. So a group narrower than the packet tests CONSERVATIVELY,
in the manner of Ize, "Robust BVH Ray Traversal" (JCGT 2013) and PBRT: the
exit distance is scaled by WIDEN = 1 + 2*gamma(3) before it is compared,
gamma(n) = n*eps / (1 - n*eps), eps = 2^-24, which covers the rounding of
the slab arithmetic. A widened group may in turn enter a leaf no lane of
the packet enters and find a hit there that the packet walk misses
(tests/test_torch_bvh_groups.py and `chip_smoke.py`'s hold_K1_vertices
count such lanes). The packet-wide walk, the JAX function and what every
CPU frame runs, keeps the exact test. What is NOT the same function:
taking the direction signs from the group, or regrouping rays across
packets.

What bounds it on the card: by the roofline, the rays in and the hits out
(the fp32 arithmetic of the node and triangle tests the rays need is
smaller still; tables are read at one address per warp, broadcasts served
from L1/L2). What a launch really waits for is its longest walk, a chain of
dependent steps, so the design lets warps walk independently (no block-wide
barrier, many small blocks per SM) and keeps each step short (see the
source's note; PERF.md has the times). `Traversal` carries the counts a
bound needs (what the lanes' own tests pass) and the card's clock per walk.

`bvh_intersect` runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. `impl="plain"` runs the plain
version (the packet-wide vote) on the card explicitly, for comparisons.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gravit_tpu_torch.core.rays import FLT_MAX
from gravit_tpu_torch.ops import _build

PACKET = 1024         # rays that share one traversal order
GROUP = 32            # the CUDA kernel's voting group: one warp
STACK_DEPTH = 96
LEAF_PAD = 8          # leaf triangle rows are tested 8 at a time
BIG = 1e30
# 1 + 2*gamma(3) rounded to float32, 1 + 3*2^-23 (WIDEN in the CUDA source):
# a group narrower than PACKET scales each slab test's exit distance by it
WIDEN = float.fromhex("0x1.000006p+0")

# kernel launches since the last reset_launch_counts(); counted where the
# kernel is launched and nowhere else
launches_closest = 0
launches_any_hit = 0


def reset_launch_counts() -> None:
    global launches_closest, launches_any_hit
    launches_closest = 0
    launches_any_hit = 0


class Traversal(NamedTuple):
    """Raw traversal output: misses keep prim == -1 and t == their t_far.
    The four counts are per voting group of `group` lanes."""

    t: torch.Tensor            # (N,) f32
    prim: torch.Tensor         # (N,) i32, LEAF order
    u: torch.Tensor            # (N,) f32
    v: torch.Tensor            # (N,) f32
    node_visits: torch.Tensor  # (N//group,) i32 nodes the group popped
    tri_rows: torch.Tensor     # (N//group,) i32 triangle rows the group
                               # tested, each against all its lanes
    lane_node_tests: torch.Tensor  # (N//group,) i32 node tests its live
                               # lanes need on their own: the root, and two
                               # per inner node a lane's own test passed
    lane_tri_rows: torch.Tensor    # (N//group,) i32 rows of the leaves a
                               # lane's own test passed, summed over lanes
    group: int                 # lanes per voting group
    walk_ns: torch.Tensor      # (N//group,) i32 how long the group's walk
                               # took on the card, and
    began_ns: torch.Tensor     # when it began (the card's clock modulo
                               # 2^30 ns); zeros from the plain version


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


def packet_direction_signs(d: torch.Tensor) -> torch.Tensor:
    """(N // PACKET, 3) bool: each packet's summed direction >= 0 per axis,
    added in the kernel's order (block_sum in csrc/bvh_traverse.cu): a
    halving tree over each warp's 32 lanes (lane i + off into lane i, off
    16 down to 1), then the warp sums one after another onto 0. Float
    addition does not associate, and torch.sum's order differs between
    devices, so only a fixed order gives the kernel and this version one
    traversal order on every packet."""
    nb = d.shape[0] // PACKET
    x = d.reshape(nb, PACKET // 32, 32, 3)
    for off in (16, 8, 4, 2, 1):
        x = x[:, :, :off] + x[:, :, off:2 * off]
    s = torch.zeros((nb, 3), dtype=d.dtype, device=d.device)
    for w in range(PACKET // 32):
        s = s + x[:, w, 0]
    return s >= 0.0


def bvh_intersect_plain(o, d, valid, block_root, bounds, meta, tri, t_far,
                       any_hit: bool = False, group: int = PACKET,
                       reads=None) -> Traversal:
    """The traversal vectorized over voting groups of `group` consecutive
    lanes: a stack `(ng, STACK_DEPTH)`, a stack pointer and a visit count
    per group, and a Python loop until every group is done. Same
    arithmetic, in the same order, as the kernel. `group=PACKET` is the
    TPU kernel's walk (one vote per packet, the exact slab test),
    `group=GROUP` the CUDA kernel's (one vote per warp, the slab test
    widened by WIDEN; so is every group below PACKET); both take the near
    child from the PACKET's summed direction, so both visit leaves in one
    order.
    `reads`, if given, is an (Nn,) uint8 tensor of zeros in which the walk
    marks what it read of the tables: it ORs 1 into every node a group
    popped and 2 into every leaf whose rows a group tested."""
    _check(o, d, valid, block_root, bounds, meta, tri, t_far)
    if group < 1 or PACKET % group:
        raise ValueError(f"group must divide {PACKET}, got {group}")
    n = o.shape[0]
    nb = n // PACKET
    ng = n // group
    per_packet = PACKET // group
    dev = o.device
    f32, i64, i32 = torch.float32, torch.int64, torch.int32
    oc = [o[:, c].reshape(ng, group) for c in range(3)]
    dc = [d[:, c].reshape(ng, group) for c in range(3)]
    inv = [_safe_inv(x) for x in dc]
    live0 = valid.reshape(ng, group) != 0
    dpos = packet_direction_signs(d)                              # (nb, 3)
    dpos = dpos.repeat_interleave(per_packet, dim=0)              # (ng, 3)

    tb = t_far.reshape(ng, group).clone()
    prim = torch.full((ng, group), -1, dtype=i32, device=dev)
    uu = torch.zeros((ng, group), dtype=f32, device=dev)
    vv = torch.zeros((ng, group), dtype=f32, device=dev)

    root = block_root.to(i64).repeat_interleave(per_packet)
    # a group with no live lane has nothing to find and leaves at once
    walks = (root >= 0) & live0.any(dim=1)
    stack = torch.zeros((ng, STACK_DEPTH), dtype=i64, device=dev)
    stack[:, 0] = root
    sp = torch.ones((ng,), dtype=i64, device=dev)
    visits = torch.zeros((ng,), dtype=i32, device=dev)
    rows_tested = torch.zeros((ng,), dtype=i32, device=dev)
    own_nodes = (live0 & walks[:, None]).sum(dim=1).to(i32)   # the root test
    own_rows = torch.zeros((ng,), dtype=i32, device=dev)
    meta64 = meta.to(i64)
    cap = 4 * bounds.shape[0] + 64
    kidx = torch.arange(LEAF_PAD, dtype=i64, device=dev)

    while True:
        go = walks & (visits < cap) & (sp > 0)
        if any_hit:
            go = go & (live0 & (prim < 0)).any(dim=1)
        act = go.nonzero().squeeze(1)
        if act.numel() == 0:
            break
        visits[act] += 1
        spa = sp[act] - 1
        node = stack[act, spa]
        if reads is not None:
            reads[node] |= 1
        bnd = bounds[node]
        o_a = [x[act] for x in oc]
        inv_a = [x[act] for x in inv]
        tn = torch.full((act.numel(), group), -BIG, dtype=f32, device=dev)
        tf = torch.full((act.numel(), group), BIG, dtype=f32, device=dev)
        for ax in range(3):
            a = (bnd[:, ax, None] - o_a[ax]) * inv_a[ax]
            b = (bnd[:, ax + 3, None] - o_a[ax]) * inv_a[ax]
            tn = torch.maximum(tn, torch.minimum(a, b))
            tf = torch.minimum(tf, torch.maximum(a, b))
        if group < PACKET:
            tf = tf * WIDEN
        node_hit = live0[act] & (tf >= tn) & (tn < tb[act]) & (tf > 1e-6)
        enter = node_hit.any(dim=1)
        passed = node_hit.sum(dim=1).to(i32)
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
            own_nodes[ia] += 2 * passed[inner]

        leaf = enter & is_leaf
        if bool(leaf.any()):
            la = act[leaf]
            if reads is not None:
                reads[node[leaf]] |= 2
            count = m[leaf, 1].to(i32)
            rows_tested[la] += count
            own_rows[la] += count * passed[leaf]
            tb[la], prim[la], uu[la], vv[la] = _leaf_tests(
                [x[la] for x in oc], [x[la] for x in dc], live0[la],
                m[leaf, 0], m[leaf, 1], tri, kidx,
                tb[la], prim[la], uu[la], vv[la])
        sp[act] = torch.clamp(spa, max=STACK_DEPTH - 2)

    untimed = torch.zeros((ng,), dtype=i32, device=dev)
    return Traversal(tb.reshape(n), prim.reshape(n), uu.reshape(n),
                     vv.reshape(n), visits, rows_tested, own_nodes,
                     own_rows, group, untimed, untimed)


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
             + [ctypes.c_void_p] * 7)


def _library() -> ctypes.CDLL:
    lib = _build.load("bvh_traverse")
    lib.bvh_traverse_launch.argtypes = _ARGTYPES
    lib.bvh_traverse_launch.restype = ctypes.c_int
    lib.bvh_traverse_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.bvh_traverse_occupancy.restype = ctypes.c_int
    lib.bvh_traverse_error_string.argtypes = [ctypes.c_int]
    lib.bvh_traverse_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(lib, err: int, what: str) -> None:
    if err:
        msg = lib.bvh_traverse_error_string(err).decode()
        raise RuntimeError(f"bvh_traverse {what} failed: {msg} ({err})")


def kernel_occupancy() -> dict:
    """How the traversal kernel sits on the current card: threads per
    block, resident blocks per SM (by registers and shared memory, from the
    CUDA runtime) and the number of SMs."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(3)]
    _raise_if(lib, lib.bvh_traverse_occupancy(*map(ctypes.byref, vals)),
              "occupancy query")
    threads, blocks_per_sm, sms = (v.value for v in vals)
    return dict(block_threads=threads, blocks_per_sm=blocks_per_sm, sms=sms)


def bvh_intersect_kernel(o, d, valid, block_root, bounds, meta, tri, t_far,
                        any_hit: bool = False) -> Traversal:
    """Launch `csrc/bvh_traverse.cu` on the current stream (the packets'
    direction signs, then the traversal); raises if the launch is refused.
    CUDA tensors only."""
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
    dpos = out(torch.int32, (nb,))          # scratch: 3 sign bits per packet
    stats = out(torch.int32, (n // GROUP, 6))
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    with torch.cuda.device(o.device):     # the launch targets this device
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.bvh_traverse_launch(
            ptr(o), ptr(d), ptr(valid), ptr(block_root), ptr(t_far),
            ptr(bounds), ptr(meta), ptr(tri), nb, bounds.shape[0],
            int(any_hit), ptr(dpos), ptr(t), ptr(prim), ptr(u), ptr(v),
            ptr(stats), ctypes.c_void_p(stream))
    _raise_if(lib, err, "launch")
    if nb:
        if any_hit:
            launches_any_hit += 1
        else:
            launches_closest += 1
    return Traversal(t, prim, u, v, stats[:, 0], stats[:, 1], stats[:, 2],
                     stats[:, 3], GROUP, stats[:, 4], stats[:, 5])


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
