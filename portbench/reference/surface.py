"""The plain reference of a GraviT surface frame and of its training loss.

It follows the semantics of GraviT's Image-schedule tracer on the inputs
the benchmark makes (the scene generator's meshes, the configuration's
lights, a camera pose), written as directly as PyTorch allows and with no
acceleration structure:

  camera    gvtPerspectiveCamera (gvtCamera.cpp:233-312): pixel NDC on
            the W-1 / H-1 grid, the jitter offset (s - samples/2) *
            jitter / samples, directions normalised
  shuffle   a ray without an instance takes the instance box it enters
            first (TracerBase.h:325-414, BVH.h:61-135): tfar > tnear,
            tnear > 1e-6, tnear < t_max, not the box it just left, the
            first box on a tie; its origin moves 0.95 of the way to the
            box. A shadow ray that finds no box retires and deposits.
  intersect Möller-Trumbore against the triangles of the ray's instance
            (t > 1e-6, no culling), brute force; closest hit for camera
            rays, any hit for shadow rays (EmbreeMeshAdapter.cpp:277-385);
            the first triangle wins a tie. Boxes around blocks of
            triangles only skip what no ray of a group can reach.
  shade     lambert (Material.cpp:50-57) under each point light with
            falloff min(1, 1/d) (Light.cpp:58-62): colour clamp(kd *
            max(n.wi, 0) * w * Li, 0, 1); the shading normal interpolated
            from generateNormals' vertex normals (Mesh.cpp:116-155),
            turned to face the ray by the flat normal; one shadow ray a
            light from (1 - 16e-6) t toward the light, unnormalised, with
            t_max 3.0 (glm's length() of a vec3)
  deposit   colour * w and 1 in alpha per unoccluded shadow ray that left
            the scene (TracerBase.h:396-399); rgb clamped at 1
Rounds: each round intersects every ray queued in a box, shades and
spawns, then shuffles; `max_rounds` cuts a frame as the looped tracer's
unrolled rounds do (the train step's 4). Depth 1 only: nothing bounces.

Every product goes through `Arith`, so the same code is the control in
TF32. Builds are out of place, so autograd gives the loss's gradients.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.precision import Arith

FLT_MAX = float(np.finfo(np.float32).max)
EPS = 1e-6
SHADOW_T_MAX = 3.0
RAY_CHUNK_PAIRS = 1 << 26     # ray x triangle pairs held at once
# brute force skips what no ray of a group can reach: rays in groups of
# RAY_GROUP with nearby directions, triangles in boxes of CULL_BLOCK
# consecutive ones, a box skipped when no ray of the group meets it (boxes
# grown by CULL_GROW of their size, far more than float32 rounding moves a
# hit); instances under CULL_MIN triangles, and the TF32 control, are
# tested whole
RAY_GROUP = 1024
CULL_BLOCK = 64
CULL_MIN = 4096
CULL_GROW = 1e-3


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
class Params:
    """What a fit may change: object-space vertices of the meshes one
    after another, kd per triangle in the same order, the lights."""

    vertices: torch.Tensor    # (V, 3)
    kd: torch.Tensor          # (T, 3)
    light_pos: torch.Tensor   # (L, 3)
    light_color: torch.Tensor  # (L, 3)

    def leaves(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Prepared:
    """The scene's fixed part: kept faces, instances and their boxes."""

    faces: list               # per mesh (T_m, 3) int64 kept faces
    vert_off: list            # per mesh offset into Params.vertices
    vert_count: list          # per mesh vertex count
    tri_off: list             # per mesh offset into Params.kd
    inst_mesh: list           # per instance its mesh
    inst_m: list              # per instance (3, 3) float32 tensors
    inst_t: list              # per instance (3,) translations
    inst_n: list              # per instance (3, 3) normal matrices
    lo: torch.Tensor          # (I, 3) instance boxes
    hi: torch.Tensor
    device: torch.device


def kept_faces(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Faces with three distinct vertex positions (Mesh.cpp:103-110 drops
    the rest)."""
    v = verts[faces]
    same = (np.all(v[:, 0] == v[:, 1], axis=1)
            | np.all(v[:, 1] == v[:, 2], axis=1)
            | np.all(v[:, 2] == v[:, 0], axis=1))
    return faces[~same]


def prepare(scene, lights: list, device) -> tuple:
    """(Prepared, Params at the scene's own values) from a scene
    generator's SceneData and the configuration's lights."""
    dev = torch.device(device)
    faces, vert_off, tri_off, verts, kds = [], [], [], [], []
    nv = nt = 0
    for m in scene.meshes:
        f = kept_faces(np.asarray(m.verts, np.float32), np.asarray(m.faces))
        if int(m.mat_type) != 0:
            raise NotImplementedError("the reference shades lambert only")
        faces.append(torch.as_tensor(f, dtype=torch.int64, device=dev))
        vert_off.append(nv)
        tri_off.append(nt)
        verts.append(np.asarray(m.verts, np.float32))
        kds.append(np.tile(np.asarray(m.kd, np.float32), (len(f), 1)))
        nv += len(m.verts)
        nt += len(f)
    inst_mesh, inst_m, inst_t, inst_n, lo, hi = [], [], [], [], [], []
    for mesh_id, mat in scene.instances:
        mat = np.asarray(mat, np.float64)
        m3, t = mat[:3, :3], mat[:3, 3]
        v = np.asarray(scene.meshes[mesh_id].verts, np.float64)
        # the box: the mesh's two bounding corners transformed (api.cpp:
        # 307-312), not all eight
        c0, c1 = m3 @ v.min(axis=0) + t, m3 @ v.max(axis=0) + t
        lo.append(np.minimum(c0, c1))
        hi.append(np.maximum(c0, c1))
        inst_mesh.append(mesh_id)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                         device=dev)
        inst_m.append(as_t(m3))
        inst_t.append(as_t(t))
        inst_n.append(as_t(np.linalg.inv(m3).T))
    for li in lights:
        if li["kind"] != "point":
            raise NotImplementedError("the reference takes point lights")
    f32 = dict(dtype=torch.float32, device=dev)
    params = Params(
        vertices=torch.as_tensor(np.concatenate(verts), **f32),
        kd=torch.as_tensor(np.concatenate(kds), **f32),
        light_pos=torch.tensor([li["position"] for li in lights], **f32),
        light_color=torch.tensor([li["color"] for li in lights], **f32))
    prep = Prepared(faces, vert_off, [len(m.verts) for m in scene.meshes],
                    tri_off, inst_mesh, inst_m, inst_t, inst_n,
                    torch.tensor(np.stack(lo), **f32),
                    torch.tensor(np.stack(hi), **f32), dev)
    return prep, params


@dataclasses.dataclass
class World:
    """Per instance: its triangles in world space (v0, e1, e2), the
    corner normals and the flat normal (both through the normal matrix,
    not normalised), kd."""

    v0: list
    e1: list
    e2: list
    n: list                   # (T, 3, 3) corners 0, 1, 2
    ng: list
    kd: list
    boxes: list               # (lo, hi) of CULL_BLOCK triangles, or None


def _unit(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    return x / ar.norm(x)[..., None]


def world(prep: Prepared, p: Params, ar: Arith) -> World:
    """Triangles and normals of every instance from the parameters."""
    per_mesh = []
    for m, f in enumerate(prep.faces):
        v = p.vertices[prep.vert_off[m]:prep.vert_off[m]
                       + prep.vert_count[m]]
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = b - a, c - a
        fn = _unit(ar, ar.cross(e1, e2))
        vn = torch.zeros_like(v)
        for k in range(3):
            vn = vn.index_add(0, f[:, k], fn)
        vn = _unit(ar, vn)
        corners = torch.stack([vn[f[:, 0]], vn[f[:, 1]], vn[f[:, 2]]], 1)
        t0 = prep.tri_off[m]
        per_mesh.append((a, e1, e2, corners, ar.cross(e1, e2),
                         p.kd[t0:t0 + f.shape[0]]))
    out = World([], [], [], [], [], [], [])
    for i, mesh_id in enumerate(prep.inst_mesh):
        a, e1, e2, corners, ng, kd = per_mesh[mesh_id]
        m3, t, n3 = prep.inst_m[i], prep.inst_t[i], prep.inst_n[i]
        out.v0.append(ar.transform(m3, a) + t)
        out.e1.append(ar.transform(m3, e1))
        out.e2.append(ar.transform(m3, e2))
        out.n.append(ar.transform(n3, corners))
        out.ng.append(ar.transform(n3, ng))
        out.kd.append(kd)
        out.boxes.append(_boxes(out.v0[-1], out.e1[-1], out.e2[-1])
                         if ar.precision == "float32" else None)
    return out


def _boxes(v0, e1, e2):
    """Grown boxes around blocks of CULL_BLOCK consecutive triangles (the
    last block padded with its first triangle), or None for few."""
    t = v0.shape[0]
    if t < CULL_MIN:
        return None
    with torch.no_grad():
        pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
        lo, hi = pts.amin(dim=1), pts.amax(dim=1)
        pad = -t % CULL_BLOCK
        if pad:
            lo = torch.cat([lo, lo[-1:].expand(pad, 3)])
            hi = torch.cat([hi, hi[-1:].expand(pad, 3)])
        lo = lo.reshape(-1, CULL_BLOCK, 3).amin(dim=1)
        hi = hi.reshape(-1, CULL_BLOCK, 3).amax(dim=1)
        grow = CULL_GROW * (hi - lo).amax(dim=1, keepdim=True) + 1e-6
        return lo - grow, hi + grow


def _direction_order(d):
    """Rays ordered by their direction's cell on a 256 x 256 grid of
    angles, so that a group of consecutive rays points one way."""
    theta = torch.atan2(d[:, 1], d[:, 0])
    phi = torch.asin(torch.clamp(d[:, 2], -1.0, 1.0))
    a = ((theta + math.pi) * (255.99 / (2 * math.pi))).to(torch.int64)
    b = ((phi + 0.5 * math.pi) * (255.99 / math.pi)).to(torch.int64)
    return torch.argsort(b * 256 + a, stable=True)


def _candidates(boxes, o, d, n_tri):
    """Triangle indices (ascending) whose box some ray of the group
    meets."""
    lo, hi = boxes
    with torch.no_grad():
        inv = torch.where(torch.abs(d) < 1e-30,
                          torch.where(d < 0, -1e30, 1e30), 1.0 / d)
        a = (lo[None] - o[:, None]) * inv[:, None]
        b = (hi[None] - o[:, None]) * inv[:, None]
        tn = torch.minimum(a, b).amax(dim=-1)
        tf = torch.maximum(a, b).amin(dim=-1)
        blocks = ((tf >= tn) & (tf >= 0.0)).any(dim=0).nonzero()[:, 0]
        tri = (blocks[:, None] * CULL_BLOCK
               + torch.arange(CULL_BLOCK, device=o.device)[None]).reshape(-1)
        return tri[tri < n_tri]


def camera_rays(cam: Camera, device, ar: Arith):
    """(origins, directions, pixel ids) of the whole film, lanes in
    ((j*W + i)*S + k)*S + s order."""
    dev = torch.device(device)
    f64 = np.float64
    eye, focus, up = (np.asarray(x, f64) for x in (cam.eye, cam.focus,
                                                    cam.up))
    f32 = dict(dtype=torch.float32, device=dev)
    e = torch.tensor(eye, **f32)
    w = torch.tensor(focus, **f32) - e
    w = w / ar.norm(w)
    upv = torch.tensor(up, **f32)
    upv = upv / ar.norm(upv)
    u = ar.cross(w, upv)
    u = u / ar.norm(u)
    v = ar.cross(u, w)
    v = v / ar.norm(v)
    W, H, S = cam.width, cam.height, cam.samples
    vert = math.tan(cam.fov * 0.5)
    horz = vert * (W / float(H))
    offset = cam.jitter / float(S)
    half = S * 0.5
    j, i, k, s = torch.meshgrid(*(torch.arange(n, **f32)
                                  for n in (H, W, S, S)), indexing="ij")
    x = ar.mul(i * (2.0 / (W - 1)) - 1.0 + ar.mul(s - half, offset), horz)
    y = ar.mul(j * (2.0 / (H - 1)) - 1.0 + ar.mul(k - half, offset), vert)
    d = (ar.mul(x[..., None], u) + ar.mul(y[..., None], v) + w)
    d = (d / ar.norm(d)[..., None]).reshape(-1, 3)
    n = d.shape[0]
    pix = (j * W + i).reshape(-1).to(torch.int64)
    return e.expand(n, 3), d, pix


def next_box(prep: Prepared, o, d, t_max, prev, ar: Arith):
    """(found, box, tnear): the box each ray enters first, by the
    shuffle's rule."""
    small = torch.abs(d) < 1e-30
    inv = torch.where(small, torch.where(d < 0, -1e30, 1e30),
                      1.0 / torch.where(small, 1.0, d))
    a = ar.mul(prep.lo[None] - o[:, None], inv[:, None])
    b = ar.mul(prep.hi[None] - o[:, None], inv[:, None])
    tn = torch.minimum(a, b).amax(dim=-1)
    tf = torch.maximum(a, b).amin(dim=-1)
    boxes = torch.arange(prep.lo.shape[0], device=o.device)
    ok = ((tf > tn) & (tn > EPS) & (tn < t_max[:, None])
          & (prev[:, None] != boxes[None]))
    tn_ok = torch.where(ok, tn, math.inf)
    best = torch.argmin(tn_ok, dim=1)           # the first on a tie
    found = ok.any(dim=1)
    return found, best, tn_ok.gather(1, best[:, None])[:, 0]


def _moller_trumbore(ar: Arith, o, d, v0, e1, e2):
    pvec = ar.cross(d, e2)
    det = ar.dot(e1, pvec)
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0),
                          0.0)
    tvec = o - v0
    u = ar.mul(ar.dot(tvec, pvec), inv_det)
    qvec = ar.cross(tvec, e1)
    v = ar.mul(ar.dot(d, qvec), inv_det)
    t = ar.mul(ar.dot(e2, qvec), inv_det)
    hit = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > EPS))
    return hit, t, u, v


def intersect(wd: World, inst, o, d, ar: Arith, any_hit: bool):
    """Per ray of instance `inst[k]` (>= 0): (hit, t, u, v, triangle) of
    its closest hit, or with any_hit (hit,) alone, against the triangles
    of its own instance. Rays with inst < 0 get no hit."""
    n = o.shape[0]
    dev = o.device
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    parts = []
    for i in torch.unique(inst[inst >= 0]).tolist():
        rows = (inst == i).nonzero()[:, 0]
        v0, e1, e2, boxes = wd.v0[i], wd.e1[i], wd.e2[i], wd.boxes[i]
        if boxes is None:
            groups = [(rows, None)]
        else:
            rows = rows[_direction_order(d[rows])]
            groups = [(rows[s:s + RAY_GROUP], _candidates(
                boxes, o[rows[s:s + RAY_GROUP]], d[rows[s:s + RAY_GROUP]],
                v0.shape[0])) for s in range(0, rows.numel(), RAY_GROUP)]
        for r_all, cand in groups:
            if cand is not None and cand.numel() == 0:
                continue
            tv = (v0, e1, e2) if cand is None else (v0[cand], e1[cand],
                                                    e2[cand])
            ids = cand
            step = max(1, RAY_CHUNK_PAIRS // max(1, tv[0].shape[0]))
            for s in range(0, r_all.numel(), step):
                r = r_all[s:s + step]
                parts.append((r,) + _closest(ar, o[r], d[r], *tv, ids,
                                             any_hit))
    if parts:
        r = torch.cat([q[0] for q in parts])
        hit = hit.index_put((r,), torch.cat([q[1] for q in parts]))
        if not any_hit:
            t = t.index_put((r,), torch.cat([q[2] for q in parts]))
            u = u.index_put((r,), torch.cat([q[3] for q in parts]))
            v = v.index_put((r,), torch.cat([q[4] for q in parts]))
            tri = tri.index_put((r,), torch.cat([q[5] for q in parts]))
    if any_hit:
        return (hit,)
    t = torch.where(hit, t, FLT_MAX)
    return hit, t, u, v, tri


def _closest(ar: Arith, o, d, v0, e1, e2, ids, any_hit: bool):
    """(hit,) or (hit, t, u, v, triangle) of rays (R, 3) against the
    triangles (T, 3), numbered by `ids` (None: 0..T-1), T held in pieces
    of RAY_CHUNK_PAIRS / R; the first triangle wins a tie."""
    n = o.shape[0]
    step = max(1, RAY_CHUNK_PAIRS // max(1, n))
    best = None
    for s in range(0, v0.shape[0], step):
        h, tt, uu, vv = _moller_trumbore(
            ar, o[:, None], d[:, None], v0[None, s:s + step],
            e1[None, s:s + step], e2[None, s:s + step])
        if any_hit:
            got = h.any(dim=1)
            best = got if best is None else best | got
            continue
        tm = torch.where(h, tt, math.inf)
        k = torch.argmin(tm, dim=1, keepdim=True)
        cur = (h.any(dim=1), tt.gather(1, k)[:, 0], uu.gather(1, k)[:, 0],
               vv.gather(1, k)[:, 0], k[:, 0] + s)
        if best is None:
            best = cur
        else:
            closer = cur[0] & (~best[0] | (cur[1] < best[1]))
            best = tuple(torch.where(closer, c, b) for c, b in zip(cur, best))
            best = (best[0] | cur[0],) + best[1:]
    if any_hit:
        return (best,)
    hit_, t_, u_, v_, k_ = best
    if ids is not None:
        k_ = ids[k_]
    return hit_, t_, u_, v_, k_


def _gather_tri(wd: World, field: str, inst, tri):
    """field[inst[k]][tri[k]] per ray (rays with inst < 0 read zeros)."""
    tabs = getattr(wd, field)
    out = None
    for i in torch.unique(inst[inst >= 0]).tolist():
        sel = inst == i
        vals = tabs[i][tri.clamp(0, tabs[i].shape[0] - 1)]
        m = sel.view((-1,) + (1,) * (vals.dim() - 1))
        out = torch.where(m, vals, 0.0 if out is None else out)
    if out is None:
        out = torch.zeros((inst.shape[0],) + tuple(tabs[0].shape[1:]),
                          dtype=torch.float32, device=inst.device)
    return out


def _shade(wd: World, p: Params, ar: Arith, inst, o, d, w, t, u, v, tri):
    """Per light: (colour, valid, shadow origin, shadow direction) of the
    hits."""
    hp = o + ar.mul(d, t[:, None])
    corners = _gather_tri(wd, "n", inst, tri)
    b0 = 1.0 - u - v
    n = (ar.mul(corners[:, 1], u[:, None]) + ar.mul(corners[:, 2], v[:, None])
         + ar.mul(corners[:, 0], b0[:, None]))
    n = _unit(ar, n)
    ng = _unit(ar, _gather_tri(wd, "ng", inst, tri))
    flip = ar.dot(-d, ng) <= 0.0
    n = torch.where(flip[:, None], -n, n)
    kd = _gather_tri(wd, "kd", inst, tri)
    so = o + ar.mul(d, ((1.0 - 16.0 * EPS) * t)[:, None])
    out = []
    for li in range(p.light_pos.shape[0]):
        lp = p.light_pos[li]
        wi = lp - hp
        dist = ar.norm(wi)
        wi = wi / dist[:, None]
        ndotl = torch.clamp(ar.dot(n, wi), min=0.0)
        fall = torch.clamp(1.0 / torch.clamp(dist, min=1e-30), max=1.0)
        lc = ar.mul(p.light_color[li], fall[:, None])
        c = torch.clamp(ar.mul(ar.mul(kd, ar.mul(ndotl, w)[:, None]), lc),
                        0.0, 1.0)
        valid = (ndotl > 0.0) & (lc != 0.0).any(dim=1)
        out.append((c, valid, so, lp - so))
    return out


def render(prep: Prepared, p: Params, cam: Camera, ar: Arith = None,
           max_rounds: int = 64, rays=None) -> torch.Tensor:
    """The (W*H, 4) framebuffer of one frame. `rays` (origins,
    directions, pixel ids) replaces the camera's."""
    ar = ar or Arith()
    dev = prep.device
    wd = world(prep, p, ar)
    o, d, pix = rays if rays is not None else camera_rays(cam, dev, ar)
    n = o.shape[0]
    w_ray = 1.0 / float(cam.samples * cam.samples)
    fb = torch.zeros((cam.width * cam.height, 4), dtype=torch.float32,
                     device=dev)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found, box, tn = next_box(prep, o, d, torch.full((n,), FLT_MAX,
                                                     device=dev), none, ar)
    o = torch.where(found[:, None], o + ar.mul(d, (0.95 * tn)[:, None]), o)
    cam_inst = torch.where(found, box, -1)      # -1: left the scene
    cam_prev = none
    # shadow rays in flight: origin, direction, colour * w, pixel, inst
    sh = None
    for _ in range(max_rounds):
        live_cam = cam_inst >= 0
        if not bool(live_cam.any()) and sh is None:
            break
        # camera rays against their instance
        hit, t, u, v, tri = intersect(wd, cam_inst, o, d, ar, any_hit=False)
        # shadow rays queued in a box against theirs: a hit kills them
        if sh is not None:
            (occ,) = intersect(wd, sh["inst"], sh["o"], sh["d"], ar,
                               any_hit=True)
            sh = _keep(sh, ~occ)
        # shade the camera hits, spawn, test the spawns in their instance
        w = torch.full((n,), w_ray, dtype=torch.float32, device=dev)
        spawned = []
        if bool(hit.any()):
            rows = hit.nonzero()[:, 0]
            for c, valid, so, sd in _shade(
                    wd, p, ar, cam_inst[rows], o[rows], d[rows], w[rows],
                    t[rows], u[rows], v[rows], tri[rows]):
                (occ,) = intersect(wd, cam_inst[rows], so, sd, ar,
                                   any_hit=True)
                keep = valid & ~occ
                spawned.append(dict(
                    o=so[keep], d=sd[keep], c=ar.mul(c[keep], w_ray),
                    pix=pix[rows][keep], inst=cam_inst[rows][keep]))
        # shuffle: escaped camera rays hop on, hits are done
        esc = live_cam & ~hit
        prev = torch.where(esc, cam_inst, cam_prev)
        f2, b2, tn2 = next_box(prep, o, d, torch.full((n,), FLT_MAX,
                                                      device=dev), prev, ar)
        go = esc & f2
        o = torch.where(go[:, None], o + ar.mul(d, (0.95 * tn2)[:, None]), o)
        cam_inst = torch.where(go, b2, -1)
        cam_prev = prev
        # shuffle: every shadow ray left its box (or was just spawned)
        pend = [sh] if sh is not None else []
        pend += [dict(s, prev=s["inst"]) for s in spawned]
        if not pend:
            sh = None
            continue
        s = {k: torch.cat([q[k] for q in pend]) for k in pend[0]}
        m = s["o"].shape[0]
        f3, b3, tn3 = next_box(prep, s["o"], s["d"],
                               torch.full((m,), SHADOW_T_MAX, device=dev),
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
        sh = _keep(s, f3) if bool(f3.any()) else None
    return torch.cat([torch.clamp(fb[:, :3], max=1.0), fb[:, 3:]], dim=1)


def _keep(s: dict, mask) -> dict:
    return {k: x[mask] for k, x in s.items()}


def loss(prep: Prepared, p: Params, cam: Camera, target: torch.Tensor,
         rounds: int, ar: Arith = None) -> torch.Tensor:
    """The train step's loss: mean over pixels and rgb of the squared
    difference of the frame (cut at `rounds` rounds) from `target`."""
    fb = render(prep, p, cam, ar, max_rounds=rounds)
    return torch.mean((fb[:, :3] - target[:, :3]) ** 2)


class Adam:
    """Adam as optax.adam and torch.optim.Adam (eps added to the root of
    the bias-corrected second moment), written out."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, leaves: dict, grads: dict) -> dict:
        if self.mu is None:
            self.mu = {k: torch.zeros_like(x) for k, x in leaves.items()}
            self.nu = {k: torch.zeros_like(x) for k, x in leaves.items()}
        self.count += 1
        out = {}
        for k, x in leaves.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            mhat = self.mu[k] / (1.0 - self.b1 ** self.count)
            vhat = self.nu[k] / (1.0 - self.b2 ** self.count)
            out[k] = x - self.lr * mhat / (torch.sqrt(vhat) + self.eps)
        return out
