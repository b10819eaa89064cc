"""Slice-order volume integration: the fast volume engine, its two CUDA
kernels' wrapper and their plain PyTorch version. Counterpart of
gravit_tpu/ops/slice_march.py.

Replaces `_slice_kernel` (K4, whole brick) and `_slice_slab_kernel` (K5,
z-windows of a brick over `slab_bytes`) of the JAX package with two entry
points of `csrc/slice_march.cu`.

The integral is taken OBJECT-ORDER: march plane by plane along the dominant
view axis (planes `step` apart along that axis); at each plane a ray's
sample is the bilinear resample of the z-lerped slice. The TPU kernel writes
that resample as a hat-weight matrix product because its hardware has no
gather; a hat weight is nonzero at two columns only, so here every version
gathers the 2x2 taps and keeps the hat's weights and the order z, x, y.
Sample positions lie on fixed planes instead of a per-ray arc-length ladder,
with per-ray opacity correction a = 1-(1-a_tf)^(arc/base) for the oblique
path length. Images converge to the gather march (ops/volume_march.py) as
the sampling rate rises.

`slice_march_reference` is the plain version: the tests, CPU tensors,
`impl="plain"` and the gradient path use it (every op is differentiable
PyTorch). On CUDA tensors `slice_march` launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from gravit_tpu_torch.core.rays import RAY_BOUNDARY, RAY_OPAQUE
from gravit_tpu_torch.ops import _build
from gravit_tpu_torch.scene.transfer import tf_lookup, tf_span

OPACITY_TERMINATION = 0.99
BIG = 1e30
# minimum |d_axis| (unit d) for the slice formulation to be well-
# conditioned; callers fall back to the gather march below this
MIN_AXIS_COMPONENT = 0.25
# headlight shading constants for implicit surfaces (ops/volume_march.py)
ISO_KA = 0.4
ISO_KD = 0.6
# central-difference half-step for the x/y gradient taps, GRID units
ISO_H = 0.5
# A brick whose permuted grid is larger than this marches as overlapping
# z-windows (K5) and takes no iso/AMR/slice-plane features. The value is the
# reference's dispatch threshold, kept so that the same scenes pick the same
# engine and render the same image; it is not a memory limit of the card.
SLAB_BYTES = 4 * 1024 * 1024
# The kernels' schedule, as csrc/slice_march.cu's TILE_W, TILE_H and BATCH
# fix it: a block is a (width, height) tile of rays of the film when the
# caller names the film's width, else TILE[0]*TILE[1] consecutive rays, with
# PLANE_BATCH threads per ray; it marches in lockstep over batches of
# PLANE_BATCH planes, aligned at k = 0, one plane per thread, and reads the
# brick through L1. A batch's box of grid cells is reduced over the block
# for the diagnostic counts only.
TILE = (8, 4)
PLANE_BATCH = 4

# kernel launches since the last reset_launch_counts(); counted where a
# kernel is launched and nowhere else
launches_slice = 0      # K4, whole brick
launches_slab = 0       # K5, z-windows


def reset_launch_counts() -> None:
    global launches_slice, launches_slab
    launches_slice = 0
    launches_slab = 0


def choose_slice_axis(d_mean) -> tuple[int, bool]:
    """(world_axis, flip) from a mean ray direction (host-side numpy)."""
    d = np.asarray(d_mean, np.float64)
    a = int(np.argmax(np.abs(d)))
    return a, bool(d[a] < 0.0)


# --------------------------------------------------------------------------
# shared geometry: world rays -> grid-coordinate rays for a permuted,
# flip-normalized volume. After this transform the volume is S (nz, nS, nL)
# with the march axis ascending along dim 0, and a ray samples grid
# position g(t) = o' + t*d' (gz along dim0, gy along dim1, gx along dim2).

def _permute_volume(samples, axis: int, flip: bool):
    """samples (nz, ny, nx) with world axes (x,y,z) = dims (2,1,0)."""
    dim_of_world = {0: 2, 1: 1, 2: 0}
    a_dim = dim_of_world[axis]
    rem = [d for d in (0, 1, 2) if d != a_dim]
    S = samples.permute(a_dim, rem[0], rem[1])
    if flip:
        # one gather into a new contiguous brick (torch.flip keeps the
        # permuted strides, and _prepare would copy its output again)
        rev = torch.arange(S.shape[0] - 1, -1, -1, device=S.device)
        S = S.index_select(0, rev)
    world_of_dim = {2: 0, 1: 1, 0: 2}
    return S, world_of_dim[rem[0]], world_of_dim[rem[1]]


def _grid_rays(o_obj, d_obj, origin, spacing, axis: int, flip: bool,
               n_axis: int, w_sub: int, w_lane: int):
    """Affine-map object-space rays into permuted grid coordinates."""
    def gcoord(w):
        return ((o_obj[:, w] - origin[w]) / spacing[w],
                d_obj[:, w] / spacing[w])

    oz, dz = gcoord(axis)
    oy, dy = gcoord(w_sub)
    ox, dx = gcoord(w_lane)
    if flip:
        oz = (n_axis - 1) - oz
        dz = -dz
    return ox, oy, oz, dx, dy, dz


def _arc_correction(d_obj, spacing, axis: int, step: float, base: float):
    """Per-ray opacity-correction exponent: plane-to-plane arc length over
    the base step (d_obj assumed unit, as in march_round)."""
    da = torch.abs(d_obj[:, axis])
    arc = step / torch.clamp(da, min=1e-6)
    return arc / base


def _apply_tf_formula(color_lut, opacity_lut, low, high, s):
    """The apply_tf arithmetic (scene/transfer.py); returns (rgb (..., 3),
    a (...)). low/high may be tensors or floats."""
    rgba = torch.cat([color_lut, opacity_lut[:, None]], dim=1)
    return tf_lookup(rgba, low, tf_span(low, high, s), s)


def np_norm3(v):
    """Static 3-vector norm (host-side)."""
    return (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) ** 0.5


def _sub_affine(sub, origin_a, spacing_a, axis: int, flip: bool,
                nz: int, w_sub: int, w_lane: int):
    """Per-subgrid affine maps from PERMUTED main-grid coords (gx, gy, zg)
    into the subgrid's own grid coords, plus the inside-bounds in subgrid
    coords, all 0-d tensors (AMR subgrid placement is data). The subgrid is
    permuted with the SAME axis but NOT flipped; the z map folds the main
    flip in (zu = c0 + c1*zg).

    Returns (Ss, (Ax, Bx, Ay, By, Az, Bz),
             (lx0, lx1, ly0, ly1, lz0, lz1))."""
    sub_samples, so, ss, slo, shi = sub
    Ss, _, _ = _permute_volume(sub_samples, axis, False)
    c0 = float(nz - 1) if flip else 0.0
    c1 = -1.0 if flip else 1.0

    def amap(w, c0_, c1_):
        A = (origin_a[w] + c0_ * spacing_a[w] - so[w]) / ss[w]
        B = c1_ * spacing_a[w] / ss[w]
        return A, B

    Ax, Bx = amap(w_lane, 0.0, 1.0)
    Ay, By = amap(w_sub, 0.0, 1.0)
    Az, Bz = amap(axis, c0, c1)

    def bounds(w):
        return (slo[w] - so[w]) / ss[w], (shi[w] - so[w]) / ss[w]

    lx0, lx1 = bounds(w_lane)
    ly0, ly1 = bounds(w_sub)
    lz0, lz1 = bounds(axis)
    return (Ss.contiguous(), (Ax, Bx, Ay, By, Az, Bz),
            (lx0, lx1, ly0, ly1, lz0, lz1))


# --------------------------------------------------------------------------
# what the plain version and the kernels share: the permuted brick, the ray
# rows and every per-launch scalar, computed once and by the same ops, so
# both read the same float32 values

@dataclasses.dataclass
class _Plan:
    S: torch.Tensor           # (nz, nS, nL) permuted, flip-normalized brick
    rows: tuple               # ox, oy, oz, dx, dy, dz, corr: (N,) each
    active: torch.Tensor      # (N,) bool
    rgba: torch.Tensor        # (256, 4)
    low: object               # 0-d tensor or float
    high: object
    span: torch.Tensor        # 0-d: max(high - low, 1e-30)
    dzg: float                # plane spacing along the march axis, grid units
    n_planes: int
    # divisors as tensors: on the card PyTorch divides by a Python scalar
    # as a multiply by its reciprocal, by a tensor exactly, and the kernels
    # divide exactly
    dzg_t: torch.Tensor       # 0-d
    sp_t: torch.Tensor        # (3,) spacing of (lane, sublane, march) axes
    iso: list                 # [(value, rgb (3,) tensor)]
    subs: list                # [(Ss, 12 0-d tensors)]
    slices: list              # [(C0 0-d tensor, Cx, Cy, Cz, |n|)]


def _upload(values: list, dev) -> torch.Tensor:
    """values as float32 on dev. A copy to the card from pageable memory
    holds the host until the stream has drained; from page-locked memory it
    joins the stream, and the host goes on."""
    t = torch.tensor(values, dtype=torch.float32)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _prepare(o_obj, d_obj, active, samples, color_lut, opacity_lut, *, axis,
             flip, step, base_step, low, high, origin, spacing, isovalues,
             subgrids, slices) -> _Plan:
    dev = o_obj.device
    f32 = dict(dtype=torch.float32, device=dev)
    spacing = tuple(float(x) for x in spacing)
    S, w_sub, w_lane = _permute_volume(samples, axis, flip)
    nz = S.shape[0]
    dzg = step / spacing[axis]
    n_planes = int(-(-float(nz - 1) // dzg))
    # the host's constants in one upload: spacing, dzg, the spacing of the
    # (lane, sublane, march) axes, and the origin unless it is on the card
    consts = [*spacing, dzg, spacing[w_lane], spacing[w_sub], spacing[axis]]
    if not torch.is_tensor(origin):
        consts += [float(x) for x in origin]
    consts = _upload(consts, dev)
    spacing_a, dzg_t, sp_t = consts[0:3], consts[3], consts[4:7]
    origin_a = (torch.as_tensor(origin, **f32) if torch.is_tensor(origin)
                else consts[7:10])

    ox, oy, oz, dx, dy, dz = _grid_rays(
        o_obj, d_obj, origin_a, spacing_a, axis, flip, nz, w_sub, w_lane)
    corr = _arc_correction(d_obj, spacing_a, axis, step, base_step)
    rgba = torch.cat([color_lut, opacity_lut[:, None]], dim=1)
    span = tf_span(low, high, ox)

    # per-iso surface rgb: the march's apply_tf at the iso value
    iso = [(float(v), tf_lookup(rgba, low, span, torch.tensor(float(v),
                                                              **f32))[0])
           for v in isovalues]
    subs = []
    for sub in subgrids:
        Ss, ab, bb = _sub_affine(sub, origin_a, spacing_a, axis, flip, nz,
                                 w_sub, w_lane)
        subs.append((Ss, ab + bb))
    # per-slice-plane affine coefficients: f(pos(t_k)) = fA + fB * t_k
    slice_rows = []
    c0f = float(nz - 1) if flip else 0.0
    c1f = -1.0 if flip else 1.0
    for (pa, pb, pc, pd) in slices:
        nvec = (float(pa), float(pb), float(pc))
        Cx = nvec[w_lane] * spacing[w_lane]
        Cy = nvec[w_sub] * spacing[w_sub]
        Cz = nvec[axis] * spacing[axis] * c1f
        C0 = (pa * origin_a[0] + pb * origin_a[1] + pc * origin_a[2]
              + float(pd) + nvec[axis] * spacing[axis] * c0f)
        slice_rows.append((C0, Cx, Cy, Cz, float(np_norm3(nvec))))
    return _Plan(S=S.contiguous(), rows=(ox, oy, oz, dx, dy, dz, corr),
                 active=active if active.dtype == torch.bool else active > 0,
                 rgba=rgba.contiguous(), low=low, high=high, span=span,
                 dzg=dzg, n_planes=n_planes, dzg_t=dzg_t, sp_t=sp_t,
                 iso=iso, subs=subs, slices=slice_rows)


class MarchResult(NamedTuple):
    color: torch.Tensor      # (N, 3)
    w: torch.Tensor          # (N,)
    # diagnostics (None from a kernel launch that was not asked for them)
    cross_k: torch.Tensor    # (N,) i32 plane of the first iso / slice-plane
                             # crossing, -1 if none
    pairs: torch.Tensor      # 0-d i64: (ray, plane) pairs sampled while the
                             # ray was inside the brick and unsaturated


def _safe_inv(x):
    return torch.where(torch.abs(x) < 1e-12,
                       torch.where(x < 0, -BIG, BIG).to(x.dtype), 1.0 / x)


def _hat_taps(g, n: int):
    """The two columns where the hat weight max(0, 1-|g - x|) over integer
    x in [0, n-1] can be nonzero, floor(g) and floor(g)+1, with their
    weights (0 for a column outside the grid) and clamped indices."""
    f = torch.floor(g)
    w0 = torch.clamp(1.0 - torch.abs(g - f), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(g - (f + 1.0)), min=0.0)
    w0 = torch.where((f >= 0.0) & (f <= n - 1.0), w0, 0.0)
    w1 = torch.where((f >= -1.0) & (f <= n - 2.0), w1, 0.0)
    i0 = torch.clamp(f, 0.0, n - 1.0).to(torch.int64)
    i1 = torch.clamp(f + 1.0, 0.0, n - 1.0).to(torch.int64)
    return i0, i1, w0, w1


def _bilinear(Sz_flat, nL: int, tx, ty):
    """sum_y Wy[y] * (sum_x Sz[y, x] * Wx[x]) at the hat's nonzero taps:
    x first, then y, as the reference's product and row sum run."""
    x0, x1, wx0, wx1 = tx
    y0, y1, wy0, wy1 = ty
    r0 = Sz_flat[y0 * nL + x0] * wx0 + Sz_flat[y0 * nL + x1] * wx1
    r1 = Sz_flat[y1 * nL + x0] * wx0 + Sz_flat[y1 * nL + x1] * wx1
    return r0 * wy0 + r1 * wy1


def _row(S, i):
    """S[i] for a 0-d index tensor, without a host sync."""
    return S.index_select(0, i.reshape(1))[0]


def _march_plain(plan: _Plan, color, w, off: int, z_hi: int,
                 on_plane=None) -> MarchResult:
    """March every ray through the z-window [off, z_hi] of the brick, all
    planes with per-ray masks: a ray sees exactly the planes with
    t_in <= t_k < t_out in ascending k. The whole brick is the window
    [0, nz-1]. Feature state (iso, slice planes) lives within one call.
    `on_plane(k, row, valid, w, gx, gy, tx, ty)`, if given, sees each plane
    before it is composited: the lower interpolation row in the brick, the
    valid rays, w before the plane, the clamped grid position and the main
    grid's taps."""
    S = plan.S
    nz, nS, nL = S.shape
    ox, oy, oz, dx, dy, dz, corr = plan.rows
    act = plan.active
    n = ox.shape[0]
    dev = ox.device
    dzg32 = np.float32(plan.dzg)

    iz, iy, ix = _safe_inv(dz), _safe_inv(dy), _safe_inv(dx)
    t_in = torch.full_like(ox, -BIG)
    t_out = torch.full_like(ox, BIG)
    for o_, inv_, lo_, hi_ in ((ox, ix, 0.0, float(nL - 1)),
                               (oy, iy, 0.0, float(nS - 1)),
                               (oz, iz, float(off), float(z_hi))):
        a = (lo_ - o_) * inv_
        b = (hi_ - o_) * inv_
        t_in = torch.maximum(t_in, torch.minimum(a, b))
        t_out = torch.minimum(t_out, torch.maximum(a, b))
    t_in = torch.clamp(t_in, min=0.0)

    slice_rows = []
    if plan.slices:
        sp_l, sp_s, sp_a = plan.sp_t
        vn = torch.sqrt(torch.clamp(
            (dx * sp_l) * (dx * sp_l) + (dy * sp_s) * (dy * sp_s)
            + (dz * sp_a) * (dz * sp_a), min=1e-30))
        for C0, Cx, Cy, Cz, nn in plan.slices:
            fA = C0 + Cx * ox + Cy * oy + Cz * oz
            fB = Cx * dx + Cy * dy + Cz * dz
            ndv = torch.abs(fB) / torch.clamp(nn * vn, min=1e-30)
            slice_rows.append((fA, fB, ISO_KA + ISO_KD * ndv))

    zrow = torch.zeros((n,), dtype=torch.float32, device=dev)
    frow = torch.zeros((n,), dtype=torch.bool, device=dev)
    s_prev, have_prev, t_prev = zrow, frow, zrow
    crossed, w_pre, g_x, g_y, g_z = frow, zrow, zrow, zrow, zrow
    rec_rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cross_k = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)

    # only planes inside the window (one plane of margin) can be valid
    k_lo = max(0, int(np.floor(off / plan.dzg - 0.5)) - 1)
    k_hi = min(plan.n_planes, int(np.ceil(z_hi / plan.dzg + 0.5)) + 2)
    for k in range(k_lo, k_hi):
        zg = np.float32(k + 0.5) * dzg32
        l0 = int(np.clip(int(np.floor(zg)) - off, 0, max(z_hi - off - 1, 0)))
        fz = np.clip(zg - np.float32(off) - np.float32(l0),
                     np.float32(0.0), np.float32(1.0))
        omf = np.float32(1.0) - fz
        zg, fz, omf = float(zg), float(fz), float(omf)
        Sz = (S[off + l0] * omf + S[off + l0 + 1] * fz).reshape(-1)
        t_k = (zg - oz) * iz
        gx_raw = ox + t_k * dx
        gy_raw = oy + t_k * dy
        gx = torch.clamp(gx_raw, 0.0, float(nL - 1))
        gy = torch.clamp(gy_raw, 0.0, float(nS - 1))
        tx, ty = _hat_taps(gx, nL), _hat_taps(gy, nS)
        s = _bilinear(Sz, nL, tx, ty)
        # AMR override: finer grids LAST (they win); raw (unclamped)
        # main-grid coords map affinely into each subgrid
        for Ss, (Ax, Bx, Ay, By, Az, Bz,
                 lx0, lx1, ly0, ly1, lz0, lz1) in plan.subs:
            nzs, nSs, nLs = Ss.shape
            gxs = Ax + Bx * gx_raw
            gys = Ay + By * gy_raw
            zs = Az + Bz * zg
            in_sub = ((gxs >= lx0) & (gxs <= lx1)
                      & (gys >= ly0) & (gys <= ly1)
                      & (zs >= lz0) & (zs <= lz1))
            l0s = torch.clamp(torch.floor(zs).to(torch.int64), 0, nzs - 2)
            fzs = torch.clamp(zs - l0s, 0.0, 1.0)
            Szs = (_row(Ss, l0s) * (1.0 - fzs)
                   + _row(Ss, l0s + 1) * fzs).reshape(-1)
            s_sub = _bilinear(
                Szs, nLs,
                _hat_taps(torch.clamp(gxs, 0.0, float(nLs - 1)), nLs),
                _hat_taps(torch.clamp(gys, 0.0, float(nSs - 1)), nSs))
            s = torch.where(in_sub, s_sub, s)
        valid = act & (t_k >= t_in) & (t_k < t_out)
        if on_plane is not None:
            on_plane(k, off + l0, valid, w, gx, gy, tx, ty)
        inside = valid & (w < OPACITY_TERMINATION)
        pairs = pairs + inside.sum()

        if plan.iso:
            # x/y taps on THIS plane (main grid only), the z tap is the
            # backward difference to the previous plane's sample
            sxp = _bilinear(Sz, nL, _hat_taps(gx + ISO_H, nL), ty)
            sxm = _bilinear(Sz, nL, _hat_taps(gx - ISO_H, nL), ty)
            syp = _bilinear(Sz, nL, tx, _hat_taps(gy + ISO_H, nS))
            sym = _bilinear(Sz, nL, tx, _hat_taps(gy - ISO_H, nS))
            for iso, rgb_iso in plan.iso:
                cross = (inside & have_prev & ~crossed
                         & ((s_prev - iso) * (s - iso) <= 0.0)
                         & (s_prev != s))
                w_pre = torch.where(cross, w, w_pre)
                g_x = torch.where(cross, (sxp - sxm) / (2.0 * ISO_H), g_x)
                g_y = torch.where(cross, (syp - sym) / (2.0 * ISO_H), g_y)
                g_z = torch.where(cross, (s - s_prev) / plan.dzg_t, g_z)
                rec_rgb = torch.where(cross[:, None], rgb_iso, rec_rgb)
                cross_k = torch.where(cross, k, cross_k)
                crossed = crossed | cross
                w = torch.where(cross, 1.0, w)
            inside = inside & (w < OPACITY_TERMINATION)

        rgb, a_tf = tf_lookup(plan.rgba, plan.low, plan.span, s)
        # slice-plane crossings: f affine in t, crossing = sign change
        # between consecutive valid planes; deposit the current sample's
        # TF color with the static-normal headlight, w -> 1
        for fA, fB, shade_s in slice_rows:
            fc = fA + fB * t_k
            fp = fA + fB * t_prev
            crs = inside & have_prev & (fp * fc <= 0.0)
            color = torch.where(
                crs[:, None],
                color + (1.0 - w)[:, None] * rgb * shade_s[:, None],
                color)
            cross_k = torch.where(crs, k, cross_k)
            w = torch.where(crs, 1.0, w)
        if slice_rows:
            inside = inside & (w < OPACITY_TERMINATION)
        a = 1.0 - torch.pow(torch.clamp(1.0 - a_tf, min=0.0), corr)
        a = torch.where(inside, a, 0.0)
        color = color + ((1.0 - w) * a)[:, None] * rgb
        w = w + (1.0 - w) * a
        have_prev = have_prev | valid
        s_prev = torch.where(valid, s, s_prev)
        t_prev = torch.where(valid, t_k, t_prev)

    if plan.iso:
        # headlight lambert at the recorded crossing. Spacing cancels in
        # the grid-space dot product (g_obj = g_grid/sp, v_obj =
        # d_grid*sp), so n.v = sum g_grid*d_grid; norms carry the static
        # spacing factors per permuted axis.
        sp_l, sp_s, sp_a = plan.sp_t
        qx, qy, qz = g_x / sp_l, g_y / sp_s, g_z / sp_a
        dot = g_x * dx + g_y * dy + g_z * dz
        gn = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz, min=1e-30))
        vn = torch.sqrt(torch.clamp(
            (dx * sp_l) * (dx * sp_l) + (dy * sp_s) * (dy * sp_s)
            + (dz * sp_a) * (dz * sp_a), min=1e-30))
        ndv = torch.abs(dot) / (gn * vn)
        shade = ISO_KA + ISO_KD * ndv
        color = torch.where(
            crossed[:, None],
            color + (1.0 - w_pre)[:, None] * rec_rgb * shade[:, None],
            color)
    return MarchResult(color, w, cross_k, pairs)


def _windows(nz: int, slab_rows: int) -> list:
    """The z-window ladder of a brick over slab_bytes: window s covers
    absolute rows [s*(slab_rows-1), min(that + slab_rows-1, nz-1)], so
    consecutive windows share one boundary row."""
    step_rows = slab_rows - 1
    n_slabs = -(-(nz - 1) // step_rows)
    return [(s * step_rows, min(s * step_rows + step_rows, nz - 1))
            for s in range(n_slabs)]


def _run_plain(plan: _Plan, color_in, w_in, slab_rows: int,
               on_plane=None) -> MarchResult:
    nz = plan.S.shape[0]
    if nz <= slab_rows:
        return _march_plain(plan, color_in, w_in, 0, nz - 1, on_plane)
    color, w = color_in, w_in
    pairs = 0
    for off, z_hi in _windows(nz, slab_rows):
        color, w, cross_k, p = _march_plain(plan, color, w, off, z_hi,
                                            on_plane)
        pairs = pairs + p
    return MarchResult(color, w, cross_k, pairs)


# --------------------------------------------------------------------------
# the kernels' schedule, mirrored on the host

def _blocks(n: int, film_width) -> torch.Tensor:
    """(blocks, rays per block) ray index of each ray slot of a block (the
    slot's PLANE_BATCH threads march it), -1 for none: a TILE of the film
    in camera lane order (lane = row * width + col), or consecutive rays
    when film_width is None."""
    tw, th = TILE
    threads = tw * th
    t = torch.arange(threads)
    if not film_width:
        blocks = -(-n // threads)
        i = torch.arange(blocks)[:, None] * threads + t
        return torch.where(i < n, i, -1)
    W = int(film_width)
    tiles_x = -(-W // tw)
    blocks = tiles_x * -(-(-(-n // W)) // th)
    b = torch.arange(blocks)[:, None]
    col = (b % tiles_x) * tw + t % tw
    row = (b // tiles_x) * th + t // tw
    i = row * W + col
    return torch.where((col < W) & (i < n), i, -1)


@dataclasses.dataclass
class Schedule:
    """What the kernels' lockstep schedule does on one launch, from the
    plain version's march (see slice_schedule_plain). Batches are indexed
    by m (planes m*batch .. m*batch+batch-1); boxes are rows of the
    permuted brick (z), then y and x cells."""

    ray_of: torch.Tensor     # (blocks, rays per block) i64, -1: none
    busy: torch.Tensor       # (blocks,) bool: a live lane
    executed: torch.Tensor   # (blocks, batches) bool
    box: torch.Tensor        # (blocks, batches, 6) i64: z0 y0 x0 bz by bx
    nbytes: torch.Tensor     # (blocks, batches) i64, 0: no tap

    def counts(self) -> dict:
        """The kernels' diagnostic counts for this launch: busy blocks,
        batches run with a valid tap (all read through L1), the largest
        box in bytes."""
        run = self.executed & (self.nbytes > 0)
        return dict(busy_blocks=int(self.busy.sum()),
                    batches_l1=int(run.sum()),
                    max_box_bytes=int(self.nbytes[run].max()) if bool(
                        run.any()) else 0)


def slice_schedule_plain(plan: _Plan, color_in, w_in, slab_rows: int,
                         film_width=None) -> Schedule:
    """The kernels' schedule on one launch, from the plain version's march
    (the kernels' rules, written over its per-plane masks; K5's windows
    hold disjoint planes in ascending order, so one ladder of batches
    serves them all):
      * rays map to blocks as _blocks() says;
      * a block's live lanes are active, unsaturated and have a valid
        plane; with none the block is idle. Its batches run from m0 =
        (first valid plane of its live lanes) // batch while some lane is
        unsaturated at the batch's start with valid planes at or after it,
        i.e. while some lane's last unsaturated valid plane is >= m*batch;
      * batch m's box covers the taps (rows row and row+1, both hat columns
        in x and y; with iso the +-ISO_H taps too) of the valid planes of
        the lanes unsaturated at the start of batch m-1 (the kernels take
        the taps one batch ahead; for m0, at the start). A lane is
        unsaturated at the start of batch m-1 with a valid plane in batch m
        exactly when its last unsaturated valid plane is >=
        max((m-1)*batch, 0)."""
    S = plan.S
    nS, nL = S.shape[1:]
    dev = S.device
    n = plan.rows[0].shape[0]
    batch = PLANE_BATCH
    ray_of = _blocks(n, film_width)
    nblocks = ray_of.shape[0]
    block_of = torch.full((n,), -1, dtype=torch.int64)
    has = ray_of >= 0
    block_of[ray_of[has]] = torch.arange(nblocks)[:, None].expand_as(
        ray_of)[has]
    block_of = block_of.to(dev)          # every ray has one block
    nb = -(-plan.n_planes // batch) + 1
    i64 = dict(dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max

    # pass 1: each ray's first valid plane and last unsaturated valid plane
    first = torch.full((n,), big, **i64)
    last_in = torch.full((n,), -1, **i64)

    def observe(k, row, valid, w_now, gx, gy, tx, ty):
        first.copy_(torch.where(valid & (first == big), k, first))
        last_in.copy_(torch.where(valid & (w_now < OPACITY_TERMINATION), k,
                                  last_in))

    _run_plain(plan, color_in, w_in, slab_rows, on_plane=observe)

    # pass 2: each (block, batch)'s box over its contributing taps
    ext = torch.stack([torch.full((nblocks, nb), v, **i64)
                       for v in (big, -1) * 3])

    def reduce(k, row, valid, w_now, gx, gy, tx, ty):
        m = k // batch
        lanes = valid & (last_in >= max((m - 1) * batch, 0))
        if not bool(lanes.any()):
            return
        xs, ys = [tx[0], tx[1]], [ty[0], ty[1]]
        if plan.iso:
            for h in (ISO_H, -ISO_H):
                xs += _hat_taps(gx + h, nL)[:2]
                ys += _hat_taps(gy + h, nS)[:2]
        xs, ys = torch.stack(xs), torch.stack(ys)
        rows = torch.full((n,), row, **i64)
        for q, v in enumerate((rows, rows + 1, ys.amin(0), ys.amax(0),
                               xs.amin(0), xs.amax(0))):
            ext[q, :, m] = ext[q, :, m].scatter_reduce(
                0, block_of[lanes], v[lanes], "amin" if q % 2 == 0 else "amax")

    _run_plain(plan, color_in, w_in, slab_rows, on_plane=reduce)

    live0 = last_in >= 0
    kmin = torch.full((nblocks,), big, **i64).scatter_reduce(
        0, block_of[live0], first[live0], "amin")
    busy = kmin < big
    last_blk = torch.full((nblocks,), -1, **i64).scatter_reduce(
        0, block_of, last_in, "amax")
    m = torch.arange(nb, device=dev)
    executed = (busy[:, None] & (m >= (kmin // batch)[:, None])
                & (m * batch <= last_blk[:, None]))
    zmn, zmx, ymn, ymx, xmn, xmx = ext
    box = torch.stack([zmn, ymn, xmn, zmx - zmn + 1, ymx - ymn + 1,
                       xmx - xmn + 1], dim=-1)
    box = torch.where((zmn < big)[..., None], box, 0)
    nbytes = box[..., 3] * box[..., 4] * box[..., 5] * 4
    return Schedule(ray_of=ray_of, busy=busy.cpu(), executed=executed.cpu(),
                    box=box.cpu(), nbytes=nbytes.cpu())


# --------------------------------------------------------------------------
# the kernels

class _MarchArgs(ctypes.Structure):
    """Mirror of `MarchArgs` in csrc/slice_march.cu (natural alignment)."""

    _fields_ = [
        ("ox", ctypes.c_void_p), ("oy", ctypes.c_void_p),
        ("oz", ctypes.c_void_p), ("dx", ctypes.c_void_p),
        ("dy", ctypes.c_void_p), ("dz", ctypes.c_void_p),
        ("corr", ctypes.c_void_p), ("active", ctypes.c_void_p),
        ("color_in", ctypes.c_void_p), ("w_in", ctypes.c_void_p),
        ("S", ctypes.c_void_p), ("tf", ctypes.c_void_p),
        ("params", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("cross_k", ctypes.c_void_p), ("pairs", ctypes.c_void_p),
        ("sched", ctypes.c_void_p), ("block_ns", ctypes.c_void_p),
        ("sub", ctypes.c_void_p), ("sub_shape", ctypes.c_void_p),
        ("color_s0", ctypes.c_longlong), ("color_s1", ctypes.c_longlong),
        ("w_s", ctypes.c_longlong),
        ("n", ctypes.c_int), ("nz", ctypes.c_int), ("nS", ctypes.c_int),
        ("nL", ctypes.c_int), ("n_planes", ctypes.c_int),
        ("slab_rows", ctypes.c_int), ("n_iso", ctypes.c_int),
        ("n_sub", ctypes.c_int), ("n_slices", ctypes.c_int),
        ("film_width", ctypes.c_int), ("dzg", ctypes.c_float),
    ]


# entry points of slice_march_launch
_ENTRY_PLAIN, _ENTRY_FEATURES, _ENTRY_SLAB = 0, 1, 2


@functools.cache
def _library() -> ctypes.CDLL:
    """The built csrc/slice_march.cu with its C interface declared, once
    per process; raises if its argument block does not match _MarchArgs."""
    lib = _build.load("slice_march")
    lib.slice_march_launch.argtypes = [ctypes.POINTER(_MarchArgs),
                                       ctypes.c_int, ctypes.c_void_p]
    lib.slice_march_launch.restype = ctypes.c_int
    lib.slice_march_error_string.argtypes = [ctypes.c_int]
    lib.slice_march_error_string.restype = ctypes.c_char_p
    lib.slice_march_args_size.argtypes = []
    lib.slice_march_args_size.restype = ctypes.c_int
    lib.slice_march_occupancy.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.slice_march_occupancy.restype = ctypes.c_int
    if lib.slice_march_args_size() != ctypes.sizeof(_MarchArgs):
        raise RuntimeError("slice_march: MarchArgs layout mismatch "
                           f"({lib.slice_march_args_size()} vs "
                           f"{ctypes.sizeof(_MarchArgs)})")
    return lib


def kernel_occupancy(entry: int) -> dict:
    """How an entry point sits on the current card: threads and registers
    per thread, shared memory per block, local memory (spills) per thread,
    resident blocks per SM (from the CUDA runtime) and SMs."""
    lib = _library()
    vals = (ctypes.c_int * 6)()
    err = lib.slice_march_occupancy(entry, vals)
    if err:
        msg = lib.slice_march_error_string(err).decode()
        raise RuntimeError(f"slice_march occupancy query: {msg} ({err})")
    return dict(zip(("block_threads", "registers", "smem_bytes",
                     "local_bytes", "blocks_per_sm", "sms"), vals))


def _pack_params(plan: _Plan) -> torch.Tensor:
    """The kernel's scalar table, float32 on the device:
    [low, high, max(high-low, 1e-30), sp_lane, sp_sub, sp_axis], then
    (value, r, g, b) per isovalue, 12 per subgrid (_sub_affine), and
    (C0, Cx, Cy, Cz, |n|) per slice plane."""
    dev = plan.S.device
    f32 = dict(dtype=torch.float32, device=dev)
    parts = [torch.as_tensor(x, **f32).reshape(1)
             for x in (plan.low, plan.high, plan.span)]
    parts.append(plan.sp_t)
    for v, rgb in plan.iso:
        parts += [torch.tensor([v], **f32), rgb]
    for _, coeffs in plan.subs:
        parts.append(torch.stack(coeffs))
    for C0, Cx, Cy, Cz, nn in plan.slices:
        parts += [C0.reshape(1), torch.tensor([Cx, Cy, Cz, nn], **f32)]
    return torch.cat(parts).contiguous()


class _Launch(NamedTuple):
    """One prepared launch: the argument block, the entry point, and the
    tensors the block points into (kept alive with it)."""

    args: _MarchArgs
    entry: int
    out: torch.Tensor        # (4, N)
    cross_k: object          # (N,) i32, or None without diagnostics
    pairs: object            # (1,) i64, or None without diagnostics
    sched: object            # (3,) i64, or None without diagnostics
    inputs: tuple


def _prepare_launch(plan: _Plan, color_in, w_in, slab_rows: int,
                    diag: bool = False, film_width=None) -> _Launch:
    """Check the tensors and fill the argument block of one launch; the
    ray rows, active, color_in and w_in are read in place. CUDA tensors
    only. `film_width` names the film's width when the rays are the film
    in camera lane order (blocks then take tiles of it). `diag` adds the
    diagnostic outputs (each ray's crossing plane, the marched-pair count,
    the schedule's counts), which a frame does not need and does not pay
    for."""
    S = plan.S
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    nz, nS, nL = S.shape
    n = plan.rows[0].shape[0]
    subs = tuple(Ss for Ss, _ in plan.subs)
    for x in (S, plan.rgba, color_in, w_in, *plan.rows, *subs):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"want float32 on {dev}, got {x.dtype} on "
                             f"{x.device}")
    if tuple(color_in.shape) != (n, 3) or tuple(w_in.shape) != (n,):
        raise ValueError("color_in must be (N, 3) and w_in (N,)")
    if film_width is not None and int(film_width) <= 0:
        raise ValueError(f"film_width must be positive, got {film_width}")
    # (N,) rows are contiguous as _prepare makes them; a strided one is
    # copied here
    rows = tuple(r.contiguous() for r in plan.rows)
    active = plan.active.contiguous()
    params = _pack_params(plan)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    cross_k = pairs = sched = sub_ptrs = sub_shape = None
    if diag:
        cross_k = torch.empty((n,), dtype=torch.int32, device=dev)
        pairs = torch.zeros((1,), dtype=torch.int64, device=dev)
        sched = torch.zeros((3,), dtype=torch.int64, device=dev)
    if subs:
        # any number of subgrids: their addresses and shapes in device tables
        sub_ptrs = torch.tensor([Ss.data_ptr() for Ss in subs],
                                dtype=torch.int64, device=dev)
        sub_shape = torch.tensor([list(Ss.shape) for Ss in subs],
                                 dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = _MarchArgs()
    (args.ox, args.oy, args.oz, args.dx, args.dy, args.dz,
     args.corr) = (r.data_ptr() for r in rows)
    args.active = active.data_ptr()
    args.color_in, args.w_in = color_in.data_ptr(), w_in.data_ptr()
    args.color_s0, args.color_s1 = color_in.stride()
    args.w_s = w_in.stride(0)
    args.S, args.tf = S.data_ptr(), plan.rgba.data_ptr()
    args.params, args.out = params.data_ptr(), out.data_ptr()
    args.cross_k, args.pairs, args.sched = ptr(cross_k), ptr(pairs), \
        ptr(sched)
    args.sub, args.sub_shape = ptr(sub_ptrs), ptr(sub_shape)
    args.n, args.nz, args.nS, args.nL = n, nz, nS, nL
    args.n_planes, args.slab_rows = plan.n_planes, slab_rows
    args.n_iso, args.n_sub, args.n_slices = \
        len(plan.iso), len(plan.subs), len(plan.slices)
    args.film_width = int(film_width or 0)
    args.dzg = plan.dzg
    features = bool(plan.iso or plan.subs or plan.slices)
    entry = (_ENTRY_SLAB if nz > slab_rows
             else _ENTRY_FEATURES if features else _ENTRY_PLAIN)
    return _Launch(args, entry, out, cross_k, pairs, sched,
                   (rows, active, color_in, w_in, params, S, plan.rgba, subs,
                    sub_ptrs, sub_shape))


def _launch(launch: _Launch) -> None:
    """Launch K4 or K5 on the current stream; raises if the launch is
    refused. The one place the launch counts grow."""
    global launches_slice, launches_slab
    dev = launch.out.device
    lib = _library()
    with torch.cuda.device(dev):          # the launch targets this device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.slice_march_launch(ctypes.byref(launch.args), launch.entry,
                                     ctypes.c_void_p(stream))
    if err:
        msg = lib.slice_march_error_string(err).decode()
        raise RuntimeError(f"slice_march launch failed: {msg} ({err})")
    if launch.args.n:
        if launch.entry == _ENTRY_SLAB:
            launches_slab += 1
        else:
            launches_slice += 1


class KernelResult(NamedTuple):
    color: torch.Tensor      # (N, 3)
    w: torch.Tensor          # (N,)
    # diagnostics (None unless asked for)
    cross_k: object          # (N,) i32
    pairs: object            # 0-d i64
    sched: object            # {busy_blocks, batches_l1, max_box_bytes}


def _run_kernel(plan: _Plan, color_in, w_in, slab_rows: int,
                film_width=None, diag: bool = False) -> KernelResult:
    """K4 for a brick within slab_rows, else K5 (z-windows)."""
    launch = _prepare_launch(plan, color_in, w_in, slab_rows, diag,
                             film_width)
    _launch(launch)
    out = launch.out
    sched = None
    if diag:
        sched = dict(zip(("busy_blocks", "batches_l1", "max_box_bytes"),
                         launch.sched.tolist()))
    return KernelResult(out[0:3].T, out[3], launch.cross_k,
                        launch.pairs[0] if diag else None, sched)


# --------------------------------------------------------------------------
# the public pair

def _flags(w, active):
    opaque = w >= OPACITY_TERMINATION
    flags = torch.where(opaque, RAY_OPAQUE, RAY_BOUNDARY).to(torch.int32)
    return torch.where(active, flags, 0)


def slice_march_reference(o_obj, d_obj, active, color_in, w_in,
                          samples, color_lut, opacity_lut,
                          *, axis: int, flip: bool, step: float,
                          base_step: float, low, high,
                          origin, spacing: tuple,
                          isovalues: tuple = (), subgrids=(),
                          slices: tuple = ()):
    """The plain PyTorch version of the kernels: identical plane
    discretization, hat-weight bilinear, TF lerp and compositing. The
    validation oracle, the CPU path and the differentiable path.

    isovalues: implicit isosurfaces. Per plane, a sign change of (s - iso)
    between consecutive in-brick samples marks a crossing; the FIRST
    crossing freezes the ray (w -> 1) and records the gradient inputs: x/y
    taps are two more resamples of the same plane at +-ISO_H, the z tap is
    the BACKWARD difference to the previous plane's sample. The headlight
    lambert deposit (ISO_KA + ISO_KD*|n.v|) lands after the ladder.

    slices: tuple of (a, b, c, d) OBJECT-space plane coefficients
    (march_brick semantics): the plane function is AFFINE along each ray,
    f = fA + fB*t, so a crossing between consecutive valid planes is a sign
    test; it deposits the current sample's TF color with the static-normal
    headlight and w -> 1.

    subgrids: AMR nesting, tuple of (samples, origin, spacing, lo, hi)
    coarse -> fine (finer overrides). Each plane's sample is overridden for
    rays whose object position lies inside a subgrid; the subgrid's grid
    coords are an affine map of (gx, gy, zg). Same sample ladder as the
    main grid.
    """
    plan = _prepare(o_obj, d_obj, active, samples, color_lut, opacity_lut,
                    axis=axis, flip=flip, step=step, base_step=base_step,
                    low=low, high=high, origin=origin, spacing=spacing,
                    isovalues=isovalues, subgrids=subgrids, slices=slices)
    r = _march_plain(plan, color_in, w_in, 0, plan.S.shape[0] - 1)
    return r.color, r.w, _flags(r.w, plan.active)


def slice_march(o_obj, d_obj, active, color_in, w_in,
                samples, color_lut, opacity_lut,
                *, axis: int, flip: bool, step: float, base_step: float,
                low, high, origin, spacing: tuple,
                slab_bytes: int = SLAB_BYTES,
                isovalues: tuple = (), subgrids=(), slices: tuple = (),
                impl=None, film_width=None):
    """March N rays through the whole brick.

    o_obj, d_obj: (N, 3) object-space rays, d unit (march_round's frame).
    Returns (color (N,3), w (N,), flags (N,)) with the march_brick flag
    protocol (RAY_OPAQUE / RAY_BOUNDARY).

    A brick whose permuted grid fits `slab_bytes` marches whole (K4).
    Bigger bricks march as z-WINDOWS along the march axis (K5): consecutive
    windows share one interpolation row, are marched front to back with
    color/w carried per ray, and take the plain feature set only. Sample
    positions and weights are identical either way.

    CPU tensors run the plain version, CUDA tensors a kernel;
    impl="plain" runs the plain version on any device. `film_width`: the
    film's width when the rays are the film in camera lane order (lane =
    row * width + col); the kernels then march 2-D tiles of it. It changes
    the schedule only, never the result.
    """
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    plan = _prepare(o_obj, d_obj, active, samples, color_lut, opacity_lut,
                    axis=axis, flip=flip, step=step, base_step=base_step,
                    low=low, high=high, origin=origin, spacing=spacing,
                    isovalues=isovalues, subgrids=subgrids, slices=slices)
    nz, nS, nL = plan.S.shape
    slab_rows = max(2, int(slab_bytes) // (nS * nL * 4))
    if nz > slab_rows:
        for what, given in (("isovalues", isovalues),
                            ("AMR subgrids", subgrids),
                            ("slice planes", slices)):
            if given:
                raise ValueError(
                    f"{what} on the slice engine require a brick within "
                    f"slab_bytes (nz={nz} > slab_rows={slab_rows}); callers "
                    "gate larger bricks to the gather march")
    if impl == "plain" or o_obj.device.type == "cpu":
        r = _run_plain(plan, color_in, w_in, slab_rows)
    else:
        r = _run_kernel(plan, color_in, w_in, slab_rows, film_width)
    return r.color, r.w, _flags(r.w, plan.active)
