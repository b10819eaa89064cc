"""The plain reference of a GraviT volume frame: the bricks of one scalar
field, each an identity instance, rendered on one rank under the Image
schedule (VolApp, src/apps/render/VolApp.cpp), written as directly as
PyTorch allows in float32, from the scene generator's bricks and a camera
pose alone:

  camera    gvtPerspectiveCamera (gvtCamera.cpp:233-312): pixel NDC on the
            W-1 / H-1 grid, the jitter offset (s - samples/2) * jitter /
            samples, directions normalised; a volume ray starts with
            opacity w = 0 and colour 0
  queueing  a ray takes the brick box it enters first (the slab test:
            tfar > tnear, tnear > 1e-6, the first box on a tie) and moves
            0.95 of the way to it (DomainTracer.h:158-167); a ray that
            finds no box deposits nothing
  march     in its brick, a ray samples planes one step (the smallest
            spacing over the sampling rate) apart along the dominant axis
            of the film's mean direction, at (k + 1/2) steps from the
            brick's first sample on that axis counted in the direction
            the rays travel, each plane it meets inside the brick, from
            where it stands on, front to back. A sample is the bilinear
            value of the 2x2 taps around the ray's point on the plane (in
            the slice the two grid rows beside the plane give by linear
            interpolation), the point clamped into the brick; the transfer
            function is a piecewise-linear lookup in a 256-entry table over
            [low, high]; the opacity is corrected for the path between
            planes, a = 1 - (1 - a_tf)^(step / |d_axis| / base step);
            colour += (1 - w) a rgb, w += (1 - w) a, until w reaches 0.99
  shuffle   a ray that left its brick below 0.99 takes the next box it
            enters, not the one it left, and moves to (1 + eps) t of it
            (eps: float32's); one that finds none, or reached 0.99, retires
            (DomainTracer.cpp:255-305)
  deposit   a retiring ray adds colour * w in rgb and 1 in alpha to its
            pixel; rgb clamped at 1

Departures from the published description (OSPRay's volume renderer, which
GraviT's Pvol adapter calls):
  - the integral is the slice-order one of the port's volume engine, on
    fixed planes per brick with the per-ray opacity correction above, not
    OSPRay's per-ray ladder of samples one step apart along the ray;
  - the gate: every ray of the film has |d_axis| >= 0.25 of its unit
    direction on the dominant axis, all of one sign; a pose that fails it
    raises (the program marches another engine there);
  - each brick's instance is the identity, so world and brick space are
    one; bricks may not overlap but at their shared layer;
  - the film's rays are marched through a brick in blocks of BLOCK_RAYS,
    their samples taken PLANE_SAMPLES at a time.

`prepare(..., control=...)` makes the controls a check must fail:
"bfloat16" (the bricks' samples rounded to bfloat16), "no_opacity_
correction" (a = a_tf), "no_shared_layer" (every brick cut back to its
bricklet, without the layer it shares with the next).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)
EPS = 1e-6
EPS1 = float(np.float32(1.0) + np.finfo(np.float32).eps)
QUEUE_BUMP = 0.95
OPAQUE = 0.99
MIN_AXIS_COMPONENT = 0.25
BLOCK_RAYS = 1 << 17
PLANE_SAMPLES = 1 << 22       # samples of a block taken at once
CONTROLS = ("bfloat16", "no_opacity_correction", "no_shared_layer")


@dataclasses.dataclass
class Camera:
    eye: tuple
    focus: tuple
    up: tuple
    fov: float                # radians
    width: int
    height: int
    samples: int = 1
    jitter: float = 0.0


@dataclasses.dataclass
class Prepared:
    bricks: list              # per brick (nz, ny, nx) float32 on device
    lo: torch.Tensor          # (B, 3) brick boxes
    hi: torch.Tensor
    rgba: torch.Tensor        # (256, 4) transfer table
    low: torch.Tensor         # 0-d
    span: torch.Tensor        # 0-d, max(high - low, 1e-30)
    step: float               # march step, world units
    base: float               # the step the table's opacity is for
    opacity_correction: bool
    device: torch.device


def gray_ramp(max_opacity: float) -> np.ndarray:
    """(256, 4) rgba: a gray ramp 0..1 in rgb, 0..max_opacity in alpha."""
    ramp = np.linspace(0.0, 1.0, 256, dtype=np.float32)
    alpha = (ramp * max_opacity).astype(np.float32)
    return np.stack([ramp, ramp, ramp, alpha], axis=1)


def prepare(scene, transfer: dict, device, control=None,
            sampling_rate: float = 1.0) -> Prepared:
    """The bricks, their boxes and the transfer table on `device`, from a
    scene generator's VolumeData and the configuration's `transfer`
    ({"ramp": "gray", "max_opacity": a}, over the field's range)."""
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    if transfer.get("ramp") != "gray":
        raise NotImplementedError("the reference takes the gray ramp")
    dev = torch.device(device)
    bricks, lo, hi = [], [], []
    for b in scene.bricks:
        s = b.samples
        if control == "no_shared_layer":
            s = s[:scene.bricklets[2], :scene.bricklets[1],
                  :scene.bricklets[0]]
        t = torch.as_tensor(np.ascontiguousarray(s), dtype=torch.float32,
                            device=dev)
        if control == "bfloat16":
            t = t.to(torch.bfloat16).to(torch.float32)
        bricks.append(t)
        lo.append(np.asarray(b.origin, np.float32))
        hi.append(np.asarray(b.origin, np.float32)
                  + np.asarray(s.shape[::-1], np.float32) - 1.0)
    f32 = dict(dtype=torch.float32, device=dev)
    low = torch.tensor(scene.low, **f32)
    high = torch.tensor(scene.high, **f32)
    step = 1.0 / max(float(sampling_rate), 1e-6)
    return Prepared(
        bricks=bricks, lo=torch.tensor(np.stack(lo), **f32),
        hi=torch.tensor(np.stack(hi), **f32),
        rgba=torch.tensor(gray_ramp(float(transfer["max_opacity"])), **f32),
        low=low, span=torch.clamp(high - low, min=1e-30), step=step,
        base=1.0, opacity_correction=control != "no_opacity_correction",
        device=dev)


def _norm(a):
    return torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                      + a[..., 2] * a[..., 2])


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def camera_rays(cam: Camera, device):
    """(origins, directions, pixel ids) of the whole film, lanes in
    ((j*W + i)*S + k)*S + s order."""
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.tensor(cam.eye, **f32)
    focus = torch.tensor(cam.focus, **f32)
    up = torch.tensor(cam.up, **f32)
    w = (focus - eye) / _norm(focus - eye)
    upn = up / _norm(up)
    u = _cross(w, upn)
    u = u / _norm(u)
    v = _cross(u, w)
    v = v / _norm(v)
    W, H, S = cam.width, cam.height, cam.samples
    vert = torch.tan(torch.tensor(cam.fov, **f32) * 0.5)
    horz = vert * (W / float(H))
    offset = cam.jitter / float(S)
    half = S * 0.5
    j, i, k, s = torch.meshgrid(*(torch.arange(n, **f32)
                                  for n in (H, W, S, S)), indexing="ij")
    x = (i * (2.0 / (W - 1)) - 1.0 + (s - half) * offset) * horz
    y = (j * (2.0 / (H - 1)) - 1.0 + (k - half) * offset) * vert
    d = x[..., None] * u + y[..., None] * v + w
    d = (d / _norm(d)[..., None]).reshape(-1, 3)
    n = d.shape[0]
    pix = (j * W + i).reshape(-1).to(torch.int64)
    return eye.expand(n, 3), d, pix


def march_axis(d: torch.Tensor) -> tuple:
    """(axis, flip): the dominant axis of the film's mean unit direction
    (in double) and whether the rays travel down it; raises where a ray
    has less than MIN_AXIS_COMPONENT on it or travels the other way."""
    dn = d.to(torch.float64)
    dn = dn / torch.clamp(torch.linalg.norm(dn, dim=-1, keepdim=True),
                          min=1e-30)
    mean = dn.mean(dim=0).cpu().numpy()
    axis = int(np.argmax(np.abs(mean)))
    flip = bool(mean[axis] < 0.0)
    da = dn[:, axis]
    if float(da.abs().min()) < MIN_AXIS_COMPONENT or (
            float(da.max()) > 0.0 if flip else float(da.min()) < 0.0):
        raise ValueError(f"the pose fails the slice gate on axis {axis}")
    return axis, flip


def next_box(prep: Prepared, o, d, exclude):
    """(found, box, tnear): the box each ray enters first, not `exclude`."""
    small = torch.abs(d) < 1e-30
    inv = torch.where(small, torch.where(d < 0, -1e30, 1e30),
                      1.0 / torch.where(small, 1.0, d))
    a = (prep.lo[None] - o[:, None]) * inv[:, None]
    b = (prep.hi[None] - o[:, None]) * inv[:, None]
    tnear = torch.minimum(a, b).max(dim=-1).values
    tfar = torch.maximum(a, b).min(dim=-1).values
    ids = torch.arange(prep.lo.shape[0], device=o.device)
    hit = ((tfar > tnear) & (tnear > EPS) & (tnear < FLT_MAX)
           & (ids[None] != exclude[:, None]))
    tnear = torch.where(hit, tnear, FLT_MAX)
    box = torch.argmin(tnear, dim=1)
    t = torch.gather(tnear, 1, box[:, None])[:, 0]
    return t < FLT_MAX, box, t


def _taps(g, n: int):
    """The two grid columns beside g (clamped into [0, n-1]) and their
    linear weights, 0 for a column outside the grid."""
    f = torch.floor(g)
    w0 = torch.clamp(1.0 - torch.abs(g - f), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(g - (f + 1.0)), min=0.0)
    w0 = torch.where((f >= 0.0) & (f <= n - 1.0), w0, 0.0)
    w1 = torch.where((f >= -1.0) & (f <= n - 2.0), w1, 0.0)
    i0 = torch.clamp(f, 0.0, n - 1.0).to(torch.int64)
    i1 = torch.clamp(f + 1.0, 0.0, n - 1.0).to(torch.int64)
    return i0, i1, w0, w1


def march(prep: Prepared, brick: int, o, d, color, w, axis: int,
          flip: bool):
    """(colour, w) of rays (o, d) after the planes of `brick` they meet.
    The samples of PLANE_SAMPLES // rays planes at a time, then the
    planes composited one after another."""
    S = prep.bricks[brick]
    origin = prep.lo[brick]
    nz_, ny_, nx_ = S.shape
    flat = S.reshape(-1)
    size = (nx_, ny_, nz_)                       # per world axis
    stride = (1, nx_, nx_ * ny_)
    # the plane's axis, then the two others: `sub` rows, `lane` columns
    sub, lane = {0: (2, 1), 1: (2, 0), 2: (1, 0)}[axis]
    n_a = size[axis]

    def grid(a):
        return o[:, a] - origin[a], d[:, a]

    oz, dz = grid(axis)
    oy, dy = grid(sub)
    ox, dx = grid(lane)
    if flip:
        oz, dz = (n_a - 1) - oz, -dz
    inv = [torch.where(torch.abs(x) < 1e-12,
                       torch.where(x < 0, -1e30, 1e30), 1.0 / x)
           for x in (dx, dy, dz)]
    t_in = torch.full_like(ox, -1e30)
    t_out = torch.full_like(ox, 1e30)
    for o_, i_, top in ((ox, inv[0], size[lane] - 1.0),
                        (oy, inv[1], size[sub] - 1.0),
                        (oz, inv[2], n_a - 1.0)):
        a = (0.0 - o_) * i_
        b = (top - o_) * i_
        t_in = torch.maximum(t_in, torch.minimum(a, b))
        t_out = torch.minimum(t_out, torch.maximum(a, b))
    t_in = torch.clamp(t_in, min=0.0)
    corr = (prep.step / torch.clamp(torch.abs(d[:, axis]), min=1e-6)) \
        / prep.base
    dzg = np.float32(prep.step)
    n_planes = int(-(-float(n_a - 1) // float(dzg)))
    # plane k: its place on the axis, the grid row below it (counted from
    # the far end when the rays travel down the axis) and the weights of
    # the rows below and above
    zg = np.arange(n_planes, dtype=np.float32) + np.float32(0.5)
    zg = (zg * dzg).astype(np.float32)
    r0 = np.clip(np.floor(zg), 0, n_a - 2).astype(np.int64)
    fz = np.clip(zg - r0.astype(np.float32), np.float32(0.0),
                 np.float32(1.0)).astype(np.float32)
    omf = (np.float32(1.0) - fz).astype(np.float32)
    rows = (n_a - 1 - r0) if flip else r0
    below = rows * stride[axis]
    above = ((n_a - 2 - r0) if flip else r0 + 1) * stride[axis]
    dev = o.device
    chunk = max(1, PLANE_SAMPLES // max(o.shape[0], 1))
    for k0 in range(0, n_planes, chunk):
        ks = slice(k0, min(k0 + chunk, n_planes))

        def col(x, dtype=torch.float32):
            return torch.as_tensor(x[ks], dtype=dtype, device=dev)[None]

        t_k = (col(zg) - oz[:, None]) * inv[2][:, None]
        gx = torch.clamp(ox[:, None] + t_k * dx[:, None], 0.0,
                         size[lane] - 1.0)
        gy = torch.clamp(oy[:, None] + t_k * dy[:, None], 0.0,
                         size[sub] - 1.0)
        x0, x1, wx0, wx1 = _taps(gx, size[lane])
        y0, y1, wy0, wy1 = _taps(gy, size[sub])
        lo_row, hi_row = col(below, torch.int64), col(above, torch.int64)
        w_lo, w_hi = col(omf), col(fz)

        def tap(yy, xx):
            i = yy * stride[sub] + xx * stride[lane]
            return flat[lo_row + i] * w_lo + flat[hi_row + i] * w_hi

        s = ((tap(y0, x0) * wx0 + tap(y0, x1) * wx1) * wy0
             + (tap(y1, x0) * wx0 + tap(y1, x1) * wx1) * wy1)
        met = (t_k >= t_in[:, None]) & (t_k < t_out[:, None])
        x = torch.clamp((s - prep.low) / prep.span, 0.0, 1.0) * 255.0
        i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, 254)
        frac = (x - i0)[..., None]
        v = prep.rgba[i0] * (1 - frac) + prep.rgba[i0 + 1] * frac
        rgb, a_tf = v[..., 0:3], v[..., 3]
        a_all = (1.0 - torch.pow(torch.clamp(1.0 - a_tf, min=0.0),
                                 corr[:, None])
                 if prep.opacity_correction else a_tf)
        for p in range(t_k.shape[1]):
            a = torch.where(met[:, p] & (w < OPAQUE), a_all[:, p], 0.0)
            color = color + ((1.0 - w) * a)[:, None] * rgb[:, p]
            w = w + (1.0 - w) * a
    return color, w


def render(prep: Prepared, cam: Camera) -> torch.Tensor:
    """The (W*H, 4) float32 frame of the bricks from `cam`."""
    dev = prep.device
    o, d, pix = camera_rays(cam, dev)
    axis, flip = march_axis(d)
    n = o.shape[0]
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found, box, t = next_box(prep, o, d, none)
    o = torch.where(found[:, None], o + d * (t * QUEUE_BUMP)[:, None], o)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    w = torch.zeros((n,), dtype=torch.float32, device=dev)
    fb = torch.zeros((cam.width * cam.height, 4), dtype=torch.float32,
                     device=dev)
    queued = found
    while bool(queued.any()):
        for b in range(len(prep.bricks)):
            rays = torch.nonzero(queued & (box == b))[:, 0]
            for i in torch.split(rays, BLOCK_RAYS):
                color[i], w[i] = march(prep, b, o[i], d[i], color[i], w[i],
                                       axis, flip)
        found, nxt, t = next_box(prep, o, d, torch.where(queued, box, none))
        onward = queued & (w < OPAQUE) & found
        o = torch.where(onward[:, None], o + d * (t * EPS1)[:, None], o)
        done = queued & ~onward
        rgba = torch.cat([color * w[:, None], torch.ones_like(w)[:, None]],
                         dim=1)
        fb = fb.index_add(0, pix[done], rgba[done])
        box = torch.where(onward, nxt, box)
        queued = onward
    return torch.cat([torch.clamp(fb[:, :3], max=1.0), fb[:, 3:]], dim=1)
