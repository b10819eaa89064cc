"""The work a frame's rays need in the traversal kernels (K1 closest hit,
K2 any hit), counted over the frozen builder's BVH (reference/bvh.py),
for `bvh_traverse_roofline`.

Each ray walks the tree on its own, front to back: at an inner node the
child on the side its direction points to first (the left one when the
direction's component on the node's axis is >= 0); a node is entered when
its slab test passes (tfar >= tnear, tnear < the closest hit so far, tfar
> 1e-6); a closest-hit ray walks until its stack is empty, an any-hit ray
stops at its first hit. It counts, as the kernel's own-lane counters do,
node tests (the root, and two for each inner node it enters) and triangle
rows (every row of each leaf it enters).

Work: 28 fp32 operations a node test and 51 a triangle row; bytes: each
ray read once (origin, direction, valid, t_far: 32 B) and its answer
written once (t, prim, u, v: 16 B), each node the walks tested read once
(bounds and meta: 48 B), each triangle row of a leaf they entered read
once (48 B).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import surface as S
from portbench.reference.bvh import build_bvh

OPS_NODE, OPS_ROW = 28, 51
RAY_IN, RAY_OUT, NODE_BYTES, ROW_BYTES = 32, 16, 48, 48
BIG = 1e30
STACK = 128


def _safe_inv(x):
    return torch.where(torch.abs(x) < 1e-30,
                       torch.where(x < 0, -BIG, BIG), 1.0 / x)


def walk(bounds, meta, tri, o, d, any_hit: bool) -> dict:
    """Walk every ray; `tri` (T, 9) holds v0, e1, e2 in leaf order.
    Returns per-ray node tests and rows, and masks of the nodes tested and
    of the rows tested."""
    dev = o.device
    n = o.shape[0]
    i64 = torch.int64
    inv = _safe_inv(d)
    stack = torch.zeros((n, STACK), dtype=i64, device=dev)
    sp = torch.ones((n,), dtype=i64, device=dev)
    tb = torch.full((n,), S.FLT_MAX, dtype=torch.float32, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    node_tests = torch.ones((n,), dtype=i64, device=dev)
    rows = torch.zeros((n,), dtype=i64, device=dev)
    node_seen = torch.zeros((bounds.shape[0],), dtype=torch.bool, device=dev)
    row_seen = torch.zeros((tri.shape[0],), dtype=torch.bool, device=dev)
    meta = meta.to(i64)
    k8 = torch.arange(8, device=dev)
    while True:
        go = sp > 0
        if any_hit:
            go = go & ~hit
        act = go.nonzero()[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        node_seen[node] = True
        b = bounds[node]
        oa, ia = o[act], inv[act]
        lo = (b[:, 0:3] - oa) * ia
        hi = (b[:, 3:6] - oa) * ia
        tn = torch.minimum(lo, hi).amax(dim=1)
        tf = torch.maximum(lo, hi).amin(dim=1)
        enter = (tf >= tn) & (tn < tb[act]) & (tf > 1e-6)
        m = meta[node]
        leaf = m[:, 2] > 0
        inner = enter & ~leaf
        if bool(inner.any()):
            a, mi = act[inner], m[inner]
            left_first = torch.gather(d[a], 1, mi[:, 3:4])[:, 0] >= 0
            s = sp[a]
            stack[a, s] = torch.where(left_first, mi[:, 1], mi[:, 0])
            stack[a, s + 1] = torch.where(left_first, mi[:, 0], mi[:, 1])
            sp[a] = s + 2
            node_tests[a] += 2
        lf = enter & leaf
        if bool(lf.any()):
            a, ml = act[lf], m[lf]
            cnt = ml[:, 1]
            rows[a] += cnt
            r = ml[:, 0:1] + k8[None]                         # (nl, 8)
            ok = k8[None] < cnt[:, None]
            row_seen[r[ok]] = True
            t = tri[r.clamp(max=tri.shape[0] - 1)]            # (nl, 8, 9)
            h, tt, _, _ = S._moller_trumbore(
                S.Arith(), o[a][:, None], d[a][:, None], t[..., 0:3],
                t[..., 3:6], t[..., 6:9])
            h = h & ok
            tt = torch.where(h, tt, S.FLT_MAX)
            best = tt.amin(dim=1)
            closer = best < tb[a]
            tb[a] = torch.where(closer, best, tb[a])
            hit[a] = hit[a] | h.any(dim=1)
    return dict(node_tests=node_tests, rows=rows, node_seen=node_seen,
                row_seen=row_seen, hit=hit)


def frame_rays(prep, params, cam) -> tuple:
    """(K1 rays, K2 rays) of a one-instance depth-1 frame, each (o, d):
    the camera rays that enter the instance's box, from where the shuffle
    moves them, and the shadow rays their hits spawn (before the
    occlusion test)."""
    ar = S.Arith()
    dev = prep.device
    wd = S.world(prep, params, ar)
    o, d, _ = S.camera_rays(cam, dev, ar)
    n = o.shape[0]
    found, box, tn = S.next_box(prep, o, d, torch.full((n,), S.FLT_MAX,
                                                       device=dev),
                                torch.full((n,), -1, device=dev), ar)
    o = o + d * (0.95 * tn)[:, None]
    o, d, box = o[found], d[found], box[found]
    hit, t, u, v, tri = S.intersect(wd, box, o, d, ar, any_hit=False)
    w = torch.full((int(hit.sum()),), 1.0 / cam.samples ** 2, device=dev)
    shadows = [(so[valid], sd[valid]) for _, valid, so, sd in S._shade(
        wd, params, ar, box[hit], o[hit], d[hit], w, t[hit], u[hit], v[hit],
        tri[hit])]
    k2 = (torch.cat([s[0] for s in shadows]), torch.cat([s[1]
                                                         for s in shadows]))
    return (o, d), k2


def frame_work(scene, lights: list, cams: list, device) -> list:
    """Per camera pose, the operations and bytes the K1 and K2 launches of
    its frame need, for a scene of one instance (None for more)."""
    if len(scene.instances) != 1:
        return None
    prep, params = S.prepare(scene, lights, device)
    mesh_id, mat = scene.instances[0]
    f = prep.faces[mesh_id].cpu().numpy()
    verts = np.asarray(scene.meshes[mesh_id].verts, np.float64)
    m = np.asarray(mat, np.float64)
    wv = (verts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    v0 = wv[f[:, 0]]
    e1, e2 = wv[f[:, 1]] - v0, wv[f[:, 2]] - v0
    bvh = build_bvh(v0, e1, e2)
    f32 = dict(dtype=torch.float32, device=device)
    bounds = torch.as_tensor(bvh.bounds, **f32)
    meta = torch.as_tensor(bvh.meta, device=device)
    tri = torch.as_tensor(np.concatenate([v0, e1, e2], 1)[bvh.order], **f32)
    works = []
    for cam in cams:
        k1, k2 = frame_rays(prep, params, cam)
        out = dict(nodes=int(bvh.bounds.shape[0]), triangles=int(len(f)))
        ops = nbytes = 0
        for name, (o, d), any_hit in (("k1", k1, False), ("k2", k2, True)):
            wk = walk(bounds, meta, tri, o.contiguous(), d.contiguous(),
                      any_hit)
            node_tests = int(wk["node_tests"].sum())
            rows = int(wk["rows"].sum())
            b = (o.shape[0] * (RAY_IN + RAY_OUT)
                 + int(wk["node_seen"].sum()) * NODE_BYTES
                 + int(wk["row_seen"].sum()) * ROW_BYTES)
            out[name] = dict(rays=int(o.shape[0]), node_tests=node_tests,
                             rows=rows, bytes=b)
            ops += OPS_NODE * node_tests + OPS_ROW * rows
            nbytes += b
        out.update(ops=ops, bytes=nbytes)
        works.append(out)
    return works
