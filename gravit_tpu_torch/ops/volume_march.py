"""Ray-marched volume integration (the ospTraceRays/GregSpray equivalent),
counterpart of gravit_tpu/ops/volume_march.py: the gather march.

The reference delegates brick integration to the external GregSpray engine
(adapter/ospray/OSPRayAdapter.cpp:301); rays carry accumulated rgb in
`color`, opacity in `w`, and termination flags in `depth` (ORays.h:10-14).
Here the integrator is explicit: front-to-back compositing of trilinear
samples through a 256-entry piecewise-linear transfer-function LUT, with
step = min(spacing)/sampling_rate and opacity correction for non-unit
steps. Differentiable wrt samples, TF LUTs and ray state (autograd flows
through every op; pass early_exit=False on a gradient path so the step count
does not depend on the data).

The JAX module holds no Pallas kernel, so this one is plain PyTorch on the
card too. It serves the bricks the slice engine's gate refuses.
"""

from __future__ import annotations

import torch

from gravit_tpu_torch.core.math3d import dot3
from gravit_tpu_torch.core.rays import RAY_BOUNDARY, RAY_OPAQUE
from gravit_tpu_torch.core.timing import span
from gravit_tpu_torch.scene.transfer import apply_tf

OPACITY_TERMINATION = 0.99
# early_exit asks the card "is any ray still alive?" once per this many
# chunks: each question is a host sync, a skipped question costs at most
# this many chunks of masked (zero-deposit) work
ALIVE_CHECK_EVERY = 4

# headlight shading constants for implicit surfaces: the reference
# hardcodes Ka=0.4, Kd=0.6 into the OSPRay renderer (OSPRayAdapter.cpp trace)
ISO_KA = 0.4
ISO_KD = 0.6


def corner_table(samples: torch.Tensor) -> torch.Tensor:
    """Per-CELL corner table: C[cell] = the cell's 8 corner values, corner
    order (dz, dy, dx) = 000 001 010 011 100 101 110 111. 8x the volume's
    memory; the reference builds it because row gathers are the fast gather
    on its hardware. `trilinear` takes it optionally and gives the same
    bits either way."""
    t = samples
    return torch.stack([
        t[:-1, :-1, :-1], t[:-1, :-1, 1:], t[:-1, 1:, :-1], t[:-1, 1:, 1:],
        t[1:, :-1, :-1], t[1:, :-1, 1:], t[1:, 1:, :-1], t[1:, 1:, 1:],
    ], dim=-1).reshape(-1, 8)


def trilinear(samples: torch.Tensor, origin, spacing, pos, corners=None):
    """Trilinear interpolation; samples (nz, ny, nx); pos (..., 3) world.

    corners: optional corner_table(samples). Without it the 8 corners are
    gathered from the flat brick directly; the values and the arithmetic
    order (x lerps c00..c11, then y, then z) are the same.
    """
    nz, ny, nx = samples.shape
    f = (pos - origin) / spacing                       # grid coords (x,y,z)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    iz = torch.clamp(torch.floor(fz).to(torch.int64), 0, nz - 2)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    tz = torch.clamp(fz - iz, 0.0, 1.0)

    if corners is not None:
        cell = (iz * (ny - 1) + iy) * (nx - 1) + ix
        c = corners[cell]                              # (..., 8) row gather
        c = [c[..., k] for k in range(8)]
    else:
        flat = samples.reshape(-1)
        base = (iz * ny + iy) * nx + ix
        c = [flat[base + (dz * ny + dy) * nx + dx]
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]

    c00 = c[0] * (1 - tx) + c[1] * tx
    c01 = c[2] * (1 - tx) + c[3] * tx
    c10 = c[4] * (1 - tx) + c[5] * tx
    c11 = c[6] * (1 - tx) + c[7] * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def sample_amr(samples, origin, spacing, pos, subgrids=()):
    """Sample the finest grid containing each position.

    subgrids: tuple of (samples, origin, spacing, lo, hi), ordered coarse ->
    fine (finer levels LAST so they override; Volume.h griddata tree).
    """
    s = trilinear(samples, origin, spacing, pos)
    for sub_samples, sub_origin, sub_spacing, sub_lo, sub_hi in subgrids:
        inside = torch.all((pos >= sub_lo) & (pos <= sub_hi), dim=-1)
        s_fine = trilinear(sub_samples, sub_origin, sub_spacing, pos)
        s = torch.where(inside, s_fine, s)
    return s


def field_gradient(samples, origin, spacing, pos, subgrids=(), h=0.5):
    """Central-difference gradient of the scalar field (isosurface normal),
    normalized. The 6 stencil taps go through one batched sample_amr call,
    stacked as an extra leading axis of pos (any batch rank)."""
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device) * h
    eye_b = eye.reshape((3,) + (1,) * (pos.ndim - 1) + (3,))
    taps = torch.cat([pos[None] + eye_b, pos[None] - eye_b])   # (6, ..., 3)
    s = sample_amr(samples, origin, spacing, taps, subgrids)    # (6, ...)
    g = torch.stack([(s[0] - s[3]) / (2 * h),
                     (s[1] - s[4]) / (2 * h),
                     (s[2] - s[5]) / (2 * h)], dim=-1)
    return g / torch.sqrt(torch.clamp(dot3(g, g), min=1e-30))[..., None]


def march_brick(o, d, active, color_in, w_in,
                samples, origin, spacing, lo, hi,
                color_lut, opacity_lut, vrange,
                step, max_steps: int,
                subgrids=(), isovalues: tuple = (), slices: tuple = (),
                chunk: int = 8, early_exit: bool = True):
    """March active rays through one brick; returns (color, w, exited_flags).

    o, d:   (N, 3) rays in the brick's coordinate frame (d need not be unit;
            t is in units of |d|)
    color_in, w_in: accumulated rgb / opacity carried by the rays
    lo, hi: brick bounds (3,)
    Returns (color, w, depth_flags): flags RAY_OPAQUE if the termination
    threshold was crossed, else RAY_BOUNDARY (exited the brick), matching
    the protocol the shuffle expects (DomainTracer.cpp:255-305).

    `chunk` steps are sampled per loop iteration with one batched field
    sample and one TF lookup; the front-to-back accumulation then runs over
    the chunk step by step, so results equal the step-at-a-time form.
    The reference's while_loop is a host loop here: with early_exit it
    stops once every active ray has left the brick or saturated, asking
    every ALIVE_CHECK_EVERY chunks. Skipped chunks deposit exactly nothing
    (every deposit is masked by `inside`), so the result does not depend on
    when the loop stops.
    """
    small = torch.abs(d) < 1e-30
    d_safe = torch.where(small, 1.0, d)
    inv = torch.where(small, torch.where(d < 0, -1e30, 1e30), 1.0 / d_safe)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_in = torch.clamp(torch.minimum(t0, t1).max(dim=-1).values, min=0.0)
    t_out = torch.maximum(t0, t1).min(dim=-1).values

    base_step = torch.min(spacing)
    correction = step / torch.clamp(base_step, min=1e-30)

    n = o.shape[0]
    view = -d / torch.sqrt(torch.clamp(dot3(d, d), min=1e-30))[..., None]

    def surface_deposit(color, w, pos, base_rgb, inside):
        """Opaque implicit-surface hit: headlight lambert, w -> 1."""
        nrm = field_gradient(samples, origin, spacing, pos, subgrids)
        ndv = torch.abs(dot3(nrm, view))
        shade = ISO_KA + ISO_KD * ndv
        c_surf = base_rgb * shade[:, None]
        color = torch.where(inside[:, None],
                            color + (1.0 - w)[:, None] * c_surf, color)
        w = torch.where(inside, 1.0, w)
        return color, w

    iso_rgb = [apply_tf(color_lut, opacity_lut, vrange,
                        torch.full((n,), float(iso), dtype=torch.float32,
                                   device=o.device))[0]
               for iso in isovalues]
    slice_shade = []
    for pl in slices:
        nrm = torch.tensor([pl[0], pl[1], pl[2]], dtype=torch.float32,
                           device=o.device)
        nrm = nrm / torch.sqrt(torch.clamp(dot3(nrm, nrm), min=1e-30))
        ndv = torch.abs(dot3(nrm[None, :], view))
        slice_shade.append((ISO_KA + ISO_KD * ndv)[:, None])
    karange = torch.arange(chunk, device=o.device)

    def body(ko: int, carry):
        color, w, s_prev, have_prev = carry
        kk = ko * chunk + karange                         # (K,) step indices
        t_blk = t_in[:, None] + step * (kk[None, :] + 0.5)    # (N, K)
        pos_blk = o[:, None, :] + t_blk[..., None] * d[:, None, :]
        s_blk = sample_amr(samples, origin, spacing, pos_blk, subgrids)
        rgb_blk, a_blk = apply_tf(color_lut, opacity_lut, vrange, s_blk)

        for j in range(chunk):
            t = t_blk[:, j]
            pos = pos_blk[:, j]
            s = s_blk[:, j]
            step_ok = ko * chunk + j < max_steps   # padded tail, last chunk
            in_brick = active & (t < t_out) if step_ok \
                else torch.zeros_like(active)
            inside = in_brick & (w < OPACITY_TERMINATION)

            # implicit isosurfaces: sign change of (s - iso) between samples
            for iso, rgb_iso in zip(isovalues, iso_rgb):
                cross = inside & have_prev & \
                    ((s_prev - iso) * (s - iso) <= 0.0) & (s_prev != s)
                color, w = surface_deposit(color, w, pos, rgb_iso, cross)
            # slice planes (a, b, c, dd): crossing of plane function
            for pl, shade in zip(slices, slice_shade):
                a_, b_, c_, dd_ = pl
                f = pos[:, 0] * a_ + pos[:, 1] * b_ + pos[:, 2] * c_ + dd_
                pos_prev = o + (t - step)[:, None] * d
                f_prev = (pos_prev[:, 0] * a_ + pos_prev[:, 1] * b_
                          + pos_prev[:, 2] * c_ + dd_)
                cross = inside & have_prev & (f_prev * f <= 0.0)
                c_surf = rgb_blk[:, j] * shade
                color = torch.where(cross[:, None],
                                    color + (1.0 - w)[:, None] * c_surf,
                                    color)
                w = torch.where(cross, 1.0, w)

            inside = inside & (w < OPACITY_TERMINATION)
            a = 1.0 - torch.pow(torch.clamp(1.0 - a_blk[:, j], min=0.0),
                                correction)
            a = torch.where(inside, a, 0.0)
            color = color + (1.0 - w)[:, None] * a[:, None] * rgb_blk[:, j]
            w = w + (1.0 - w) * a
            have_prev = have_prev | in_brick
            if step_ok:
                s_prev = s
        return color, w, s_prev, have_prev

    n_chunks = (max_steps + chunk - 1) // chunk
    carry = (color_in, w_in,
             torch.zeros((n,), dtype=torch.float32, device=o.device),
             torch.zeros((n,), dtype=torch.bool, device=o.device))
    for ko in range(n_chunks):
        if early_exit and ko % ALIVE_CHECK_EVERY == 0:
            t_next = t_in + step * (ko * chunk + 0.5)
            alive = active & (t_next < t_out) \
                & (carry[1] < OPACITY_TERMINATION)
            with span("tracer.sync"):      # the host waits for the card
                any_alive = bool(alive.any())
            if not any_alive:
                break
        carry = body(ko, carry)
    color, w = carry[0], carry[1]
    opaque = w >= OPACITY_TERMINATION
    flags = torch.where(opaque, RAY_OPAQUE, RAY_BOUNDARY).to(torch.int32)
    return color, w, torch.where(active, flags, 0)
