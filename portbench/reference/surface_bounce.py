"""The plain reference of a GraviT surface frame at a camera ray depth
above 1: surface.py's frame (camera, shuffle, intersection, lambert
shading, shadow rays, deposit; its pieces are imported here, not copied)
and the Russian-roulette diffuse bounce that GraviT's Embree adapter gives
a hit whose ray has depth to spare:

  decay     a SECONDARY ray's hit first scales the ray's weight by
            t > 1 ? 1/t : t (EmbreeMeshAdapter.cpp:570-575)
  shade     every hit as a camera ray's, with the ray's weight w: each
            light's colour clamp(kd * max(n.wi, 0) * w * Li, 0, 1) and a
            shadow ray from (1 - 16e-6) t toward the light
  roulette  the hit bounces iff depth - 1 > 0 and w > 1 - u (:577-588):
            its origin moves to (1 - 16 FLT_EPSILON) t along the ray, its
            direction is cosine-weighted about the shading normal in
            GraviT's unnormalised tangent basis (h is the normal with its
            smallest-|.| component, the first on a tie, set to 1; x = h x
            n, z = x x n; CosWeightedRandomHemisphereDirection2, :289-318),
            w *= dir . n (:596), depth - 1, the ray turns SECONDARY and
            stays queued in its instance for the next round; a hit that
            does not bounce ends there
  deposit   a shadow ray that leaves the scene unoccluded with a non-zero
            colour adds colour * w, and 1 in alpha (TracerBase.h:396-399),
            in the round it leaves: generation 0's shadows before
            generation 1's

Random numbers: a departure from GraviT. GraviT draws u and the
direction's two numbers from a per-thread RandEngine seeded by its TBB
chunk, so its own frames change with the chunking. Here they come from a
counter hash of (pixel, purpose, round, depth), which the program draws as
well, so that the two frames compare pixel by pixel. The hash is written
out below from its definition, on uint32 (NumPy's wrapping products): mix
x = x ^ x>>16, x *= 0x7FEB352D, x ^= x>>15, x *= 0x846CA68B, x ^= x>>16;
h = mix(mix(pixel ^ salt * 0x9E3779B9) ^ extra) with extra = round *
2654435761 + depth * 40503 (the depth the ray has when it hits); u =
(h >> 8) / 2^24. Salts: 991 the roulette, 1985 and 1986 (2 * 992 + 1, + 2)
the direction's theta and phi (11 + light places an area light's sample:
the reference takes point lights only, so it draws none).

Depth: the harness builds a Camera from its eight fields and passes no
depth, so `Camera.max_depth` defaults to DEPTH, the `depth` of the
configuration that names this module (bunny_standin_d2; a test holds the
two equal). At depth 1 nothing bounces and the frame is surface.py's, bit
for bit.

Intersection: bounce rays point every way, so grouping rays by direction
(surface.intersect) prunes little for them. Here each ray meets the
triangles of the blocks whose grown box (surface._boxes) its line enters,
closest hit the smallest t and the first triangle on a tie, as brute force
gives it. In TF32 the boxes grow by TF32_GROW of their size more, well over
what 10-bit products move a hit.

Float32 throughout; no product is a matrix product, so TF32 never engages
unless the control asks for it, and every product goes through `Arith`.
Frames only: the train loss is surface.py's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import surface as S
from portbench.reference.precision import Arith
from portbench.reference.surface import Params, Prepared, prepare  # noqa: F401

DEPTH = 2
FLT_EPS = float(np.finfo(np.float32).eps)
SALT_ROULETTE, SALT_THETA, SALT_PHI = 991, 2 * 992 + 1, 2 * 992 + 2
RAY_BOX_TESTS = 1 << 24      # ray x box slab tests held at once
PAIR_CHUNK = 1 << 18         # (ray, block) pairs whose triangles are tested
TF32_GROW = 1e-2


@dataclasses.dataclass
class Camera(S.Camera):
    max_depth: int = DEPTH


# ---------------------------------------------------------------------------
# the counter hash

def _mix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _extra(rnd: int, depth: np.ndarray) -> np.ndarray:
    return (np.uint32(rnd * 2654435761 % 2**32)
            + depth.astype(np.uint32) * np.uint32(40503))


def uniform(pix: np.ndarray, salt: int, extra: np.ndarray) -> np.ndarray:
    """[0, 1) float32 per ray from its pixel, the purpose's salt and the
    (round, depth) counter."""
    h = _mix(pix.astype(np.uint32) ^ np.uint32(salt * 0x9E3779B9 % 2**32))
    h = _mix(h ^ extra)
    return (h >> np.uint32(8)).astype(np.float32) / np.float32(1 << 24)


# ---------------------------------------------------------------------------
# intersection

def _blocks(wd: S.World, ar: Arith) -> list:
    """Per instance the grown boxes of its blocks of CULL_BLOCK triangles,
    or None (under CULL_MIN triangles: tested whole)."""
    out = []
    for v0, e1, e2 in zip(wd.v0, wd.e1, wd.e2):
        boxes = S._boxes(v0.detach(), e1.detach(), e2.detach())
        if boxes is not None and ar.precision != "float32":
            lo, hi = boxes
            pad = TF32_GROW * (hi - lo).amax(dim=1, keepdim=True)
            boxes = (lo - pad, hi + pad)
        out.append(boxes)
    return out


def _pairs(boxes, o, d):
    """(ray, block) index pairs whose box the ray's line (t >= 0) enters,
    by ray and then by block."""
    lo, hi = boxes
    step = max(1, RAY_BOX_TESTS // lo.shape[0])
    rays, blocks = [], []
    for s in range(0, o.shape[0], step):
        oo, dd = o[s:s + step], d[s:s + step]
        inv = torch.where(torch.abs(dd) < 1e-30,
                          torch.where(dd < 0, -1e30, 1e30), 1.0 / dd)
        a = (lo[None] - oo[:, None]) * inv[:, None]
        b = (hi[None] - oo[:, None]) * inv[:, None]
        tn = torch.minimum(a, b).amax(dim=-1)
        tf = torch.maximum(a, b).amin(dim=-1)
        r, k = ((tf >= tn) & (tf >= 0.0)).nonzero(as_tuple=True)
        rays.append(r + s)
        blocks.append(k)
    return torch.cat(rays), torch.cat(blocks)


def _culled(ar: Arith, boxes, o, d, v0, e1, e2, any_hit: bool):
    """(hit,) or (hit, t, u, v, triangle) of rays against one instance's
    triangles, each ray tested on the blocks its line enters."""
    n, n_tri = o.shape[0], v0.shape[0]
    dev = o.device
    with torch.no_grad():
        pr, pb = _pairs(boxes, o.detach(), d.detach())
    lane = torch.arange(S.CULL_BLOCK, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    got_r, got_t, got_u, got_v, got_k = [], [], [], [], []
    for s in range(0, pr.numel(), PAIR_CHUNK):
        r, b = pr[s:s + PAIR_CHUNK], pb[s:s + PAIR_CHUNK]
        ids = b[:, None] * S.CULL_BLOCK + lane[None]
        real = ids < n_tri
        ids = ids.clamp(max=n_tri - 1)
        h, tt, uu, vv = S._moller_trumbore(ar, o[r][:, None], d[r][:, None],
                                           v0[ids], e1[ids], e2[ids])
        h = h & real
        got = h.any(dim=1)
        if any_hit:
            hit = hit.index_put((r[got],), torch.ones_like(r[got],
                                                           dtype=torch.bool))
            continue
        # the pair's closest: the first triangle of the block on a tie
        k = torch.argmin(torch.where(h, tt, math.inf), dim=1, keepdim=True)
        got_r.append(r[got])
        got_t.append(tt.gather(1, k)[got, 0])
        got_u.append(uu.gather(1, k)[got, 0])
        got_v.append(vv.gather(1, k)[got, 0])
        got_k.append(ids.gather(1, k)[got, 0])
    if any_hit:
        return (hit,)
    t = torch.full((n,), S.FLT_MAX, dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    if not got_r:
        return hit, t, u, v, tri
    r, tt, uu, vv, kk = (torch.cat(x) for x in (got_r, got_t, got_u, got_v,
                                                 got_k))
    # a ray's closest over its blocks: the smallest t, then the smallest
    # triangle index among the pairs at that t
    t_min = torch.full((n,), math.inf, device=dev).scatter_reduce(
        0, r, tt.detach(), "amin")
    at = tt == t_min[r]
    k_min = torch.full((n,), n_tri, dtype=torch.int64, device=dev)
    k_min = k_min.scatter_reduce(0, r[at], kk[at], "amin")
    win = at & (kk == k_min[r])
    rw = (r[win],)
    return (hit.index_put(rw, torch.ones_like(rw[0], dtype=torch.bool)),
            t.index_put(rw, tt[win]), u.index_put(rw, uu[win]),
            v.index_put(rw, vv[win]), tri.index_put(rw, kk[win]))


def intersect(wd: S.World, blocks: list, inst, o, d, ar: Arith,
              any_hit: bool):
    """surface.intersect's answers (closest hit, or with any_hit the hit
    alone, of each ray against its own instance; rays with inst < 0 get
    none), with each ray tested on the blocks its line enters."""
    n = o.shape[0]
    dev = o.device
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = torch.full((n,), S.FLT_MAX, dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    for i in torch.unique(inst[inst >= 0]).tolist():
        rows = (inst == i).nonzero()[:, 0]
        v0, e1, e2 = wd.v0[i], wd.e1[i], wd.e2[i]
        if blocks[i] is not None:
            res = _culled(ar, blocks[i], o[rows], d[rows], v0, e1, e2,
                          any_hit)
        else:
            step = max(1, S.RAY_CHUNK_PAIRS // v0.shape[0])
            parts = [S._closest(ar, o[rows[s:s + step]], d[rows[s:s + step]],
                                v0, e1, e2, None, any_hit)
                     for s in range(0, rows.numel(), step)]
            res = tuple(torch.cat(x) for x in zip(*parts))
        hit = hit.index_put((rows,), res[0])
        if not any_hit:
            t = t.index_put((rows,), res[1])
            u = u.index_put((rows,), res[2])
            v = v.index_put((rows,), res[3])
            tri = tri.index_put((rows,), res[4])
    if any_hit:
        return (hit,)
    return hit, torch.where(hit, t, S.FLT_MAX), u, v, tri


# ---------------------------------------------------------------------------
# the bounce

def shading_normal(wd: S.World, ar: Arith, inst, d, u, v, tri):
    """The normal surface._shade shades with: the corners' normals
    interpolated (1: u, 2: v, 0: 1 - u - v), unit, turned to face the ray
    by the flat normal."""
    corners = S._gather_tri(wd, "n", inst, tri)
    b0 = 1.0 - u - v
    n = (ar.mul(corners[:, 1], u[:, None]) + ar.mul(corners[:, 2], v[:, None])
         + ar.mul(corners[:, 0], b0[:, None]))
    n = S._unit(ar, n)
    ng = S._unit(ar, S._gather_tri(wd, "ng", inst, tri))
    flip = ar.dot(-d, ng) <= 0.0
    return torch.where(flip[:, None], -n, n)


def cosine_direction(ar: Arith, n, xi1, xi2):
    """CosWeightedRandomHemisphereDirection2 about the unit normal n."""
    theta = torch.arccos(torch.sqrt(1.0 - xi1))
    phi = 2.0 * math.pi * xi2
    xs = ar.mul(torch.sin(theta), torch.cos(phi))
    ys = torch.cos(theta)
    zs = ar.mul(torch.sin(theta), torch.sin(phi))
    k = torch.argmin(torch.abs(n), dim=1)            # the first on a tie
    h = torch.where(torch.arange(3, device=n.device)[None] == k[:, None],
                    1.0, n)
    x = ar.cross(h, n)
    z = ar.cross(x, n)
    dv = (ar.mul(x, xs[:, None]) + ar.mul(n, ys[:, None])
          + ar.mul(z, zs[:, None]))
    return S._unit(ar, dv)


def render(prep: Prepared, p: Params, cam: Camera, ar: Arith = None,
           max_rounds: int = 64, rays=None) -> torch.Tensor:
    """The (W*H, 4) framebuffer of one frame at `cam.max_depth` (a
    surface.Camera renders at DEPTH). `rays` (origins, directions, pixel
    ids) replaces the camera's."""
    ar = ar or Arith()
    dev = prep.device
    wd = S.world(prep, p, ar)
    blocks = _blocks(wd, ar)
    o, d, pix = rays if rays is not None else S.camera_rays(cam, dev, ar)
    n = o.shape[0]
    pix_np = pix.cpu().numpy()
    w = torch.full((n,), 1.0 / float(cam.samples * cam.samples),
                   dtype=torch.float32, device=dev)
    depth = np.full(n, getattr(cam, "max_depth", DEPTH), np.int64)
    secondary = torch.zeros((n,), dtype=torch.bool, device=dev)
    fb = torch.zeros((cam.width * cam.height, 4), dtype=torch.float32,
                     device=dev)
    big = torch.full((n,), S.FLT_MAX, device=dev)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found, box, tn = S.next_box(prep, o, d, big, none, ar)
    o = torch.where(found[:, None], o + ar.mul(d, (0.95 * tn)[:, None]), o)
    path_inst = torch.where(found, box, -1)     # -1: left the scene or ended
    path_prev = none
    sh = None            # shadow rays in flight
    for rnd in range(max_rounds):
        live = path_inst >= 0
        if not bool(live.any()) and sh is None:
            break
        hit, t, u, v, tri = intersect(wd, blocks, path_inst, o, d, ar,
                                      any_hit=False)
        if sh is not None:
            (occ,) = intersect(wd, blocks, sh["inst"], sh["o"], sh["d"], ar,
                               any_hit=True)
            sh = S._keep(sh, ~occ)
        spawned = []
        bounced = torch.zeros((n,), dtype=torch.bool, device=dev)
        if bool(hit.any()):
            rows = hit.nonzero()[:, 0]
            ri, ro, rd, rt = path_inst[rows], o[rows], d[rows], t[rows]
            decay = torch.where(rt > 1.0, 1.0 / rt, rt)
            rw = torch.where(secondary[rows], ar.mul(w[rows], decay),
                             w[rows])
            for c, valid, so, sd in S._shade(wd, p, ar, ri, ro, rd, rw, rt,
                                             u[rows], v[rows], tri[rows]):
                (occ,) = intersect(wd, blocks, ri, so, sd, ar, any_hit=True)
                keep = valid & ~occ & (ar.dot(c, c) > 0.0)
                spawned.append(dict(
                    o=so[keep], d=sd[keep], c=ar.mul(c[keep], rw[keep, None]),
                    pix=pix[rows][keep], inst=ri[keep]))
            # the roulette, on the hash of (pixel, round, depth at the hit)
            rows_np = rows.cpu().numpy()
            extra = _extra(rnd, depth[rows_np])

            def draw(salt, at=slice(None)):
                return torch.as_tensor(
                    uniform(pix_np[rows_np][at], salt, extra[at]), device=dev)

            spare = torch.as_tensor(depth[rows_np] - 1 > 0, device=dev)
            goes = spare & (rw > 1.0 - draw(SALT_ROULETTE))
            if bool(goes.any()):
                sel = goes.nonzero()[:, 0]
                sel_np = sel.cpu().numpy()
                nrm = shading_normal(wd, ar, ri[sel], rd[sel], u[rows][sel],
                                     v[rows][sel], tri[rows][sel])
                new_d = cosine_direction(ar, nrm, draw(SALT_THETA, sel_np),
                                         draw(SALT_PHI, sel_np))
                t_sec = ((1.0 - 16.0 * FLT_EPS) * rt[sel])[:, None]
                lanes = rows[sel]
                yes = torch.ones_like(lanes, dtype=torch.bool)
                o = o.index_put((lanes,), ro[sel] + ar.mul(rd[sel], t_sec))
                d = d.index_put((lanes,), new_d)
                w = w.index_put((lanes,), ar.mul(rw[sel],
                                                 ar.dot(new_d, nrm)))
                secondary = secondary.index_put((lanes,), yes)
                bounced = bounced.index_put((lanes,), yes)
                depth[rows_np[sel_np]] -= 1
        # shuffle: escaped path rays hop on, bounced ones stay queued in
        # their instance, every other hit is done
        esc = live & ~hit
        prev = torch.where(esc, path_inst, path_prev)
        f2, b2, tn2 = S.next_box(prep, o, d, big, prev, ar)
        go = esc & f2
        o = torch.where(go[:, None], o + ar.mul(d, (0.95 * tn2)[:, None]), o)
        path_inst = torch.where(go, b2, torch.where(bounced, path_inst, -1))
        path_prev = prev
        # shuffle: every shadow ray left its box (or was just spawned)
        pend = [sh] if sh is not None else []
        pend += [dict(s, prev=s["inst"]) for s in spawned]
        if not pend:
            sh = None
            continue
        s = {k: torch.cat([q[k] for q in pend]) for k in pend[0]}
        m = s["o"].shape[0]
        f3, b3, tn3 = S.next_box(prep, s["o"], s["d"],
                                 torch.full((m,), S.SHADOW_T_MAX, device=dev),
                                 s["prev"], ar)
        out = ~f3
        if bool(out.any()):
            rgba = torch.cat([s["c"][out], torch.ones((int(out.sum()), 1),
                                                      device=dev)], dim=1)
            fb = fb.index_add(0, s["pix"][out], rgba)
        s["o"] = torch.where(f3[:, None],
                             s["o"] + ar.mul(s["d"], (0.95 * tn3)[:, None]),
                             s["o"])
        s["prev"] = s["inst"]
        s["inst"] = torch.where(f3, b3, -1)
        sh = S._keep(s, f3) if bool(f3.any()) else None
    return torch.cat([torch.clamp(fb[:, :3], max=1.0), fb[:, 3:]], dim=1)
