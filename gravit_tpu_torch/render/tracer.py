"""The surface tracers, counterpart of gravit_tpu/render/tracer.py.

GraviT keeps one ray queue per instance and moves rays between queues with
the instance-BVH "shuffle". Here the queues are one fixed-capacity RayArena
whose `inst` field names each ray's queue. Three tracers share the pieces:
  trace_image_fast        one instance, depth 1..6: a megapass of
                          max_depth + 1 traversal dispatches
  trace_image_fast_multi  any instance count, depth 1: closest-hit hop
                          loop, one dense shade, any-hit hop loop
  trace_image             the looped wavefront (any scene, any depth):
                          rounds of intersect, shade + spawn, shuffle
Result-equivalence map (reference -> here):
  EmbreeMeshAdapter::trace closest-hit   -> _intersect_bvh / intersect_closest
  traceShadowRays rtcOccluded            -> the any-hit passes
  generateShadowRays + Shade             -> _process_surface_hits
  TracerBase::shuffleRays                -> shuffle()
  image->localAdd                        -> scene.image.local_add

Loops whose length depends on the data (the hop loops, the wavefront
rounds, the instance-tree walk) are host loops that read their condition
from the card once per round. 3x3 transforms are written as
broadcast-multiply + left-to-right sums, never as matmuls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from gravit_tpu_torch.accel.instance_bvh import closest_instance
from gravit_tpu_torch.core.math3d import cross3, dot3
from gravit_tpu_torch.core.rays import FLT_MAX, RayArena, RayType
from gravit_tpu_torch.core.rng import hash_uniform, hash_uniform2, round_extra
from gravit_tpu_torch.ops.bvh_traverse import PACKET, bvh_intersect
from gravit_tpu_torch.ops.intersect import Hit, intersect_closest
from gravit_tpu_torch.render.scene_build import SceneData
from gravit_tpu_torch.scene import image as image_lib
from gravit_tpu_torch.scene.light import LightKind
from gravit_tpu_torch.scene.material import shade_full

RAY_EPSILON = 1e-6
MAX_FAST_DEPTH = 6   # the renderer's cap on the static generation unroll
# mesh-count crossover between the in-place per-(mesh, shadow) passes and
# the segment-aligned pack inside _intersect_bvh (tests pin both paths by
# overriding it)
INPLACE_MESH_LIMIT = 8


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(|x|^2, tiny)) over the last (size-3) axis, kept as (..., 1)."""
    return torch.sqrt(torch.clamp(dot3(x, x), min=1e-30))[..., None]


def _choose_tile(num_tris: int) -> int:
    return max(128, min(256, -(-num_tris // 128) * 128))


def _gather_inst(scene: SceneData, inst: torch.Tensor):
    """Per-ray instance data (mesh id, minv, normi); `inst` is clipped to
    [0, I-1] for the gather."""
    n = inst.shape[0]
    if scene.num_instances == 1:
        return (scene.inst_mesh[0].expand(n),
                scene.inst_minv[0].expand(n, 4, 4),
                scene.inst_normi[0].expand(n, 3, 3))
    safe = inst.clamp(0, scene.num_instances - 1).to(torch.int64)
    return scene.inst_mesh[safe], scene.inst_minv[safe], scene.inst_normi[safe]


def _transform(m3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 times (N, 3) as broadcast-multiply + left-to-right sum
    (the reference's "nij,nj->ni"), never a matmul."""
    return dot3(m3, x[:, None, :])


def _to_object(minv: torch.Tensor, origin, direction):
    o = _transform(minv[:, :3, :3], origin) + minv[:, :3, 3]
    return o, _transform(minv[:, :3, :3], direction)


def to_object_space(scene: SceneData, arena: RayArena):
    """World->object ray transform per lane (the rtcSetTransform analog).
    The direction is NOT renormalized so `t` has one scale in both spaces."""
    mesh_id, minv, _ = _gather_inst(scene, arena.inst)
    o, d = _to_object(minv, arena.origin, arena.direction)
    mesh_id = torch.where(arena.inst >= 0, mesh_id, -1)
    return o, d, mesh_id


def shuffle(scene: SceneData, arena: RayArena, fb: torch.Tensor,
            initial: bool = True):
    """Assign each unqueued ray its next instance, or retire it
    (TracerBase::shuffleRays, TracerBase.h:325-414, non-volume path).

    A candidate instance hits iff tfar > tnear, tnear > RAY_EPSILON and
    tnear < t_max, excluding `prev`; on a hit the origin is bumped by
    0.95*tnear (TracerBase.h:394). Retired SHADOW rays with nonzero color
    deposit color*w (TracerBase.h:396-399). With one instance and
    initial=False every pending ray just left that instance, so all of
    them retire directly. initial=True sees an all-PRIMARY wavefront, so
    its retired-shadow deposit is skipped (a guaranteed no-op).
    """
    pending = arena.active & (arena.inst < 0)
    is_shadow = arena.type == int(RayType.SHADOW)

    def deposit_retired(fb, retire):
        dep = retire & is_shadow & (dot3(arena.color, arena.color) > 0.0)
        return image_lib.local_add(fb, arena.id, arena.color * arena.w[:, None],
                                   torch.ones_like(arena.w), dep)

    if scene.num_instances == 1 and not initial:
        fb = deposit_retired(fb, pending)
        return arena.replace(active=arena.active & ~pending), fb

    found, nxt, t_entry = _next_instance(
        scene, arena.origin, arena.direction, arena.t_max, arena.prev,
        pending)
    requeue = pending & found
    new_origin = torch.where(
        requeue[:, None],
        arena.origin + arena.direction * (t_entry * 0.95)[:, None],
        arena.origin)
    retire = pending & ~found
    if not initial:
        fb = deposit_retired(fb, retire)
    return arena.replace(origin=new_origin,
                         inst=torch.where(requeue, nxt, arena.inst),
                         active=arena.active & ~retire), fb


def _next_instance(scene: SceneData, origin, direction, t_max, prev,
                   pending):
    """BVH::intersect leaf semantics (BVH.h:61-135, `update=true` slab):
    the closest instance AABB with tfar > tnear, tnear > RAY_EPSILON,
    tnear < t_max, excluding `prev`. Scenes with an instance tree walk it
    (accel/instance_bvh.py) and recompute the winner's t_entry from
    inst_lo / inst_hi; the rest scan the instances with a running strict-<
    minimum. Both give the same answers. Returns (found, next_inst,
    t_entry)."""
    small = torch.abs(direction) < 1e-30
    d_safe = torch.where(small, 1.0, direction)
    inv_dir = torch.where(small, torch.where(direction < 0, -1e30, 1e30),
                          1.0 / d_safe)
    if scene.inst_bvh is not None:
        found, nxt, _ = closest_instance(scene.inst_bvh, origin, inv_dir,
                                         t_max, prev, pending)
        safe = nxt.clamp(0, scene.num_instances - 1).to(torch.int64)
        l1 = (scene.inst_lo[safe] - origin) * inv_dir
        u1 = (scene.inst_hi[safe] - origin) * inv_dir
        t_entry = torch.where(found, torch.minimum(l1, u1).max(dim=-1).values,
                              FLT_MAX)
        return found, nxt, t_entry
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i in range(scene.num_instances):
        tn = torch.full((n,), -FLT_MAX, dtype=torch.float32, device=dev)
        tf = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
        for ax in range(3):
            a = (scene.inst_lo[i, ax] - origin[:, ax]) * inv_dir[:, ax]
            b = (scene.inst_hi[i, ax] - origin[:, ax]) * inv_dir[:, ax]
            tn = torch.maximum(tn, torch.minimum(a, b))
            tf = torch.minimum(tf, torch.maximum(a, b))
        hit_i = (tf > tn) & (tn > RAY_EPSILON) & (tn < t_max) & (prev != i)
        closer = hit_i & (tn < best_t)
        best_t = torch.where(closer, tn, best_t)
        best_i = torch.where(closer, i, best_i)
    return best_t < FLT_MAX, best_i, best_t


def _cosine_hemisphere(normal: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """CosWeightedRandomHemisphereDirection2 (EmbreeMeshAdapter.cpp:289-318),
    including the reference's unnormalized tangent basis."""
    xi1, xi2 = xi[:, 0], xi[:, 1]
    theta = torch.arccos(torch.sqrt(1.0 - xi1))
    phi = 2.0 * math.pi * xi2
    xs = torch.sin(theta) * torch.cos(phi)
    ys = torch.cos(theta)
    zs = torch.sin(theta) * torch.sin(phi)
    y = normal
    k = torch.argmin(torch.abs(normal), dim=-1)     # first index on ties
    onehot = (torch.arange(3, device=normal.device) == k[:, None]).to(
        normal.dtype)
    # h = y with its smallest-|.| component replaced by (about) 1.0
    h = y + onehot * (1.0 - torch.gather(y, 1, k[:, None]))
    x = cross3(h, y)
    z = cross3(x, y)
    d = x * xs[:, None] + y * ys[:, None] + z * zs[:, None]
    return d / _safe_norm(d)


def _empty_hit(n: int, dev) -> Hit:
    return Hit(t=torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev),
               prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
               u=torch.zeros((n,), dtype=torch.float32, device=dev),
               v=torch.zeros((n,), dtype=torch.float32, device=dev))


def _merge_hit(best: Hit, sel: torch.Tensor, t, prim, u, v) -> Hit:
    return Hit(t=torch.where(sel, t, best.t),
               prim=torch.where(sel, prim, best.prim),
               u=torch.where(sel, u, best.u), v=torch.where(sel, v, best.v))


def _intersect_bvh(scene: SceneData, accel, o_obj, d_obj, ray_mesh, queued,
                   is_shadow=None, impl=None) -> Hit:
    """Hit query through the packet-BVH kernel (one dispatch = one
    bvh_intersect launch; a block whose root is -1 is skipped).

    `is_shadow` (None: all closest hit) marks lanes that need only
    occlusion (rtcOccluded, EmbreeMeshAdapter.cpp:364-385): they go through
    the any-hit pass, where only prim >= 0 is meaningful. `is_shadow=True`
    says every lane is a shadow lane: the in-place passes then make no
    closest launch (it would skip every block; the results are the same).
    Two layouts, each mirroring the JAX package lane for lane (a packet's
    traversal order comes from the sum of its 1024 lanes' directions,
    padding included, so the packets must hold the same lanes):
      M == 1 or                  the arena's own layout: one pass over the
      M <= INPLACE_MESH_LIMIT    whole arena per (mesh, shadow) pair, the
                                 closest pass first, merged into `best`
                                 (one mesh: the JAX package's M == 1
                                 branch, which takes every queued lane)
      otherwise                  the segment-aligned pack: lanes ordered by
                                 (mesh, shadow) into a padded arena of
                                 n + 2*M*PACKET lanes whose segments start
                                 on a packet boundary, then one closest and
                                 (given is_shadow) one any-hit dispatch
    Other passes whose blocks are all skipped still launch: they are the
    JAX package's dispatches too. `impl="plain"` runs the traversal's plain
    version (comparisons only).
    """
    n = o_obj.shape[0]
    dev = o_obj.device
    M = accel.num_meshes
    nb = n // PACKET

    def run(o, d, valid, block_root, any_hit):
        t, prim, u, v = bvh_intersect(
            o.contiguous(), d.contiguous(), valid.to(torch.int32),
            block_root.to(torch.int32), accel.bounds, accel.meta, accel.tri,
            any_hit=any_hit, impl=impl)
        gprim = torch.where(prim >= 0,
                            accel.leaf2global[prim.clamp(min=0)], -1)
        return t, gprim, u, v

    if M == 1 or M <= INPLACE_MESH_LIMIT:
        best = _empty_hit(n, dev)
        if is_shadow is None or is_shadow is True:
            shadow_sets = ((None, is_shadow is True),)
        else:
            shadow_sets = ((~is_shadow, False), (is_shadow, True))
        for mesh_id in range(M):
            mesh_sel = queued if M == 1 else queued & (ray_mesh == mesh_id)
            for sh_mask, any_hit in shadow_sets:
                sel = mesh_sel if sh_mask is None else mesh_sel & sh_mask
                has = sel.reshape(nb, PACKET).any(dim=1)
                block_root = torch.where(has, accel.mesh_root[mesh_id], -1)
                best = _merge_hit(best, sel, *run(o_obj, d_obj, sel,
                                                  block_root, any_hit))
        return best

    # ---- the segment-aligned pack ----------------------------------------
    i64 = torch.int64
    if is_shadow is True:
        is_shadow = torch.ones_like(queued)
    S = 2 * M                         # segments: (mesh, shadow) pairs
    shadow_key = (torch.zeros((n,), dtype=i64, device=dev)
                  if is_shadow is None else is_shadow.to(i64))
    key = torch.where(queued, ray_mesh.to(i64) * 2 + shadow_key, S)
    n_pad = n + S * PACKET            # worst-case alignment waste
    lanes = torch.arange(n, dtype=i64, device=dev)
    zero1 = torch.zeros((1,), dtype=i64, device=dev)
    # the stable sort keeps lane order within a segment, as the JAX
    # package's one-hot prefix ranks (its branch for S + 1 <= 16) do
    perm = torch.sort(key, stable=True).indices   # sorted pos -> lane
    key_s = key[perm]
    # per-segment counts by scatter-add (bincount would read its size back
    # to the host)
    cnt = torch.zeros((S + 1,), dtype=i64, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    padded_cnt = (cnt[:S] + PACKET - 1) // PACKET * PACKET
    off_pad = torch.cat([zero1, torch.cumsum(padded_cnt, dim=0)])
    off_raw = torch.cat([zero1, torch.cumsum(cnt[:S], dim=0)])
    # sorted position i of segment s lands at off_pad[s] + (i - off_raw[s]);
    # the dead bucket packs after the last segment
    dest_sorted = lanes + (off_pad - off_raw)[key_s]
    pos_of_pad = _scatter_drop(n_pad, n, dest_sorted, lanes)
    lane_of_pad = torch.where(pos_of_pad < n,
                              perm[pos_of_pad.clamp(0, n - 1)], n)
    dest = torch.empty_like(dest_sorted).scatter_(0, perm, dest_sorted)
    packed = torch.cat([o_obj, d_obj, queued.to(torch.float32)[:, None]],
                       dim=1)
    packed1 = torch.cat([packed, torch.zeros((1, 7), dtype=torch.float32,
                                             device=dev)])
    arena_p = packed1[lane_of_pad]
    o_p, d_p = arena_p[:, 0:3], arena_p[:, 3:6]
    queued_p = arena_p[:, 6] > 0.5

    # segments are PACKET-aligned: each block belongs to one segment (or to
    # the dead / padding tail)
    nbp = n_pad // PACKET
    block_start = torch.arange(nbp, dtype=i64, device=dev) * PACKET
    blk_seg = (torch.searchsorted(off_pad, block_start, right=True) - 1
               ).clamp(0, S)
    blk_live = (blk_seg < S) & queued_p.reshape(nbp, PACKET).any(dim=1)
    blk_mesh = (blk_seg // 2).clamp(0, M - 1)
    blk_shadow = (blk_seg % 2) == 1
    blk_root = accel.mesh_root[blk_mesh]
    root_closest = torch.where(blk_live & ~blk_shadow, blk_root, -1)
    t, prim, u, v = run(o_p, d_p, queued_p, root_closest, False)
    if is_shadow is not None:
        root_any = torch.where(blk_live & blk_shadow, blk_root, -1)
        t2, prim2, u2, v2 = run(o_p, d_p, queued_p, root_any, True)
        lane_shadow = blk_shadow[:, None].expand(nbp, PACKET).reshape(-1)
        t = torch.where(lane_shadow, t2, t)
        prim = torch.where(lane_shadow, prim2, prim)
        u = torch.where(lane_shadow, u2, u)
        v = torch.where(lane_shadow, v2, v)
    # back to arena order: dest[arena lane] = padded lane
    ht, hprim, hu, hv = t[dest], prim[dest], u[dest], v[dest]
    miss = ~queued | (ht >= FLT_MAX)
    return Hit(t=torch.where(miss, FLT_MAX, ht),
               prim=torch.where(miss, -1, hprim), u=hu, v=hv)


def _scatter_drop(size: int, fill, index, src) -> torch.Tensor:
    """full((size,) + src.shape[1:], fill).at[index].set(src, mode="drop")
    for int64 index >= 0: scatter rows into a buffer one row longer, every
    index past the end sent to that last row, which is thrown away.
    Indices below `size` must not repeat (on the card the winner of a
    repeated index is undefined)."""
    rest = tuple(src.shape[1:])
    buf = torch.full((size + 1,) + rest, fill, dtype=src.dtype,
                     device=src.device)
    idx = index.clamp(max=size).reshape((-1,) + (1,) * len(rest))
    return buf.scatter_(0, idx.expand_as(src), src)[:size]


def _pack_shade_table(scene: SceneData) -> torch.Tensor:
    """Every per-triangle shading attribute in one (T, K) matrix, so hit
    shading costs one row gather."""
    T = scene.num_triangles
    f32 = torch.float32
    cols = [
        scene.tri_ns.reshape(T, 9), scene.tri_vcol.reshape(T, 9),
        scene.tri_kd, scene.tri_ks, scene.tri_e1, scene.tri_e2,
        scene.tri_alpha[:, None],
        scene.tri_mat_type.to(f32)[:, None],
        scene.tri_has_vcol.to(f32)[:, None],
    ]
    if scene.has_embree_materials:
        cols += [scene.tri_eta, scene.tri_k, scene.tri_rough[:, None],
                 scene.tri_hsc, scene.tri_bs[:, None],
                 scene.tri_hsf[:, None]]
    return torch.cat(cols, dim=1)


def _unpack_shade_row(scene: SceneData, row: torch.Tensor):
    """Inverse of _pack_shade_table for a gathered (N, K) row block."""
    n = row.shape[0]
    embree = None
    if scene.has_embree_materials:
        embree = (row[:, 33:36], row[:, 36:39], row[:, 39],
                  row[:, 40:43], row[:, 43], row[:, 44])
    return (row[:, 0:9].reshape(n, 3, 3), row[:, 9:18].reshape(n, 3, 3),
            row[:, 18:21], row[:, 21:24], row[:, 24:27], row[:, 27:30],
            row[:, 30], row[:, 31].to(torch.int32), row[:, 32] > 0.5, embree)


def _normals_columns(ns, normi, u1, v1, tri_e1, tri_e2, direction):
    """Shading normal, flipped to face the ray by the flat normal: the
    single-instance column form (sums over the 3-axis written as
    per-component columns)."""
    w1 = 1.0 - u1 - v1
    ni_c = [ns[:, 1, c] * u1 + ns[:, 2, c] * v1 + ns[:, 0, c] * w1
            for c in range(3)]
    nsh = [normi[:, i, 0] * ni_c[0] + normi[:, i, 1] * ni_c[1]
           + normi[:, i, 2] * ni_c[2] for i in range(3)]
    nsh_n = torch.sqrt(torch.clamp(
        nsh[0] * nsh[0] + nsh[1] * nsh[1] + nsh[2] * nsh[2], min=1e-30))
    nsh = [c / nsh_n for c in nsh]
    e1c = [tri_e1[:, c] for c in range(3)]
    e2c = [tri_e2[:, c] for c in range(3)]
    # -Ng = cross(e1, e2), the outward CCW normal (cpp:506-508)
    ngc = [e1c[1] * e2c[2] - e1c[2] * e2c[1],
           e1c[2] * e2c[0] - e1c[0] * e2c[2],
           e1c[0] * e2c[1] - e1c[1] * e2c[0]]
    nfl = [normi[:, i, 0] * ngc[0] + normi[:, i, 1] * ngc[1]
           + normi[:, i, 2] * ngc[2] for i in range(3)]
    nfl_n = torch.sqrt(torch.clamp(
        nfl[0] * nfl[0] + nfl[1] * nfl[1] + nfl[2] * nfl[2], min=1e-30))
    nfl = [c / nfl_n for c in nfl]
    # backface flip uses the FLAT normal (cpp:531-533)
    dir_c = [direction[:, c] for c in range(3)]
    flip = ((-dir_c[0]) * nfl[0] + (-dir_c[1]) * nfl[1]
            + (-dir_c[2]) * nfl[2]) <= 0.0
    return torch.stack([torch.where(flip, -c, c) for c in nsh], dim=1)


def _normals_einsum(ns, normi, u_, v_, tri_e1, tri_e2, direction):
    """The same normal in the multi-instance einsum form ("nij,nj->ni"
    transforms and (N, 3) norms): another association of the same sums."""
    n_interp = ns[:, 1] * u_ + ns[:, 2] * v_ + ns[:, 0] * (1.0 - u_ - v_)
    n_shade = _transform(normi, n_interp)
    n_shade = n_shade / _safe_norm(n_shade)
    n_flat = _transform(normi, cross3(tri_e1, tri_e2))
    n_flat = n_flat / _safe_norm(n_flat)
    flip = dot3(-direction, n_flat) <= 0.0
    return torch.where(flip[:, None], -n_shade, n_shade)


def _process_surface_hits(scene: SceneData, arena: RayArena, hit: Hit,
                          mask: torch.Tensor, round_idx,
                          no_bounce: bool = False):
    """Hit shading (EmbreeMeshAdapter.cpp:484-607).

    One instance takes the column form, more instances the einsum form,
    as the JAX package picks them by the instance count (the forms differ
    by association only). `round_idx` is an int (the wavefront round) or a
    per-lane tensor (fast-multi's freeze rounds). Returns (arena, spawn):
    `spawn` stacks one packed (N, 16) row block per light [origin 0:3 |
    dir 3:6 | color 6:9 | t 9 | t_max 10 | w 11 | id 12 | depth 13 | inst 14
    | valid 15]. no_bounce=True removes the Russian-roulette block (a
    depth-1 generation never bounces).
    """
    n = arena.capacity
    dev = arena.origin.device
    prim = torch.clamp(hit.prim, 0, scene.num_triangles - 1).to(torch.int64)
    t_hit = torch.where(mask, hit.t, 1.0)
    _, _, normi = _gather_inst(scene, arena.inst)

    # index_select's backward is an index_add; advanced indexing's sorts
    # every lane's row index (431 ms a round at 655,360 lanes into 18 rows
    # on an H100, the whole of a training step's backward)
    (ns, vcol, kd_face, ks, tri_e1, tri_e2, alpha, mat_type_face, has_vc1,
     embree_params) = _unpack_shade_row(
        scene, torch.index_select(_pack_shade_table(scene), 0, prim))

    # interpolated shading normal a*u + b*v + c*(1-u-v), corners (1, 2, 0)
    # (EmbreeMeshAdapter.cpp:510-521)
    col_form = scene.num_instances == 1
    u_, v_ = hit.u[:, None], hit.v[:, None]
    if col_form:
        normal = _normals_columns(ns, normi, hit.u, hit.v, tri_e1, tri_e2,
                                  arena.direction)
    else:
        normal = _normals_einsum(ns, normi, u_, v_, tri_e1, tri_e2,
                                 arena.direction)

    # per-vertex color -> lambert(interp color); else per-face (cpp:539-575)
    ci = vcol[:, 0] * (1.0 - u_ - v_) + vcol[:, 1] * u_ + vcol[:, 2] * v_
    kd = torch.where(has_vc1[:, None], ci, kd_face)
    mat_type = torch.where(has_vc1, 0, mat_type_face)

    # SECONDARY arrival decay: t>1 ? 1/t : t; w *= t  (cpp:570-575)
    is_sec = arena.type == int(RayType.SECONDARY)
    t_decay = torch.where(t_hit > 1.0, 1.0 / t_hit, t_hit)
    w_now = torch.where(mask & is_sec, arena.w * t_decay, arena.w)
    arena = arena.replace(w=w_now, t=torch.where(mask, hit.t, arena.t))

    t_shadow = (1.0 - 16.0 * RAY_EPSILON) * t_hit
    s_origin = arena.origin + arena.direction * t_shadow[:, None]
    hit_point = arena.origin + arena.direction * t_hit[:, None]

    # decorrelation counter for the per-ray hashes: round + bounce depth
    rng_extra = round_extra(round_idx, arena.depth)
    f32 = torch.float32
    spawn_rows = []
    for li in range(scene.num_lights):
        # the light's kind stays on the device (selects, no host sync); area
        # lights sample with counter-based per-ray hashes
        kind = scene.lights_kind[li]
        xi = hash_uniform2(arena.id, 11 + li, rng_extra)
        lpos_area = (scene.lights_pos[li]
                     + ((xi[:, 0] - 0.5) * scene.lights_wh[li, 0])[:, None]
                     * scene.lights_u[li]
                     + ((xi[:, 1] - 0.5) * scene.lights_wh[li, 1])[:, None]
                     * scene.lights_w[li])
        lpos = torch.where(kind == int(LightKind.AREA), lpos_area,
                           scene.lights_pos[li].expand(n, 3))
        if col_form:
            dv = [lpos[:, c] - hit_point[:, c] for c in range(3)]
            dist = torch.sqrt(torch.clamp(
                dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], min=1e-30))
            wi_c = [c / dist for c in dv]
            ndotl = torch.clamp(normal[:, 0] * wi_c[0] + normal[:, 1] * wi_c[1]
                                + normal[:, 2] * wi_c[2], min=0.0)
            wi = torch.stack(wi_c, dim=1)
            dist = dist[:, None]
        else:
            dist = _safe_norm(lpos - hit_point)
            wi = lpos - hit_point
            wi = wi / _safe_norm(wi)
            ndotl = torch.clamp(dot3(normal, wi), min=0.0)
        fall = torch.clamp(1.0 / torch.clamp(dist, min=1e-30), max=1.0)
        li_contrib = torch.where(kind == int(LightKind.AMBIENT),
                                 scene.lights_color[li].expand(n, 3),
                                 scene.lights_color[li] * fall)
        valid = mask & (ndotl > 0.0) & (li_contrib != 0.0).any(dim=-1)
        c = shade_full(mat_type, kd, ks, alpha, embree_params,
                       arena.direction, w_now, normal, wi,
                       has_specular=scene.has_specular)
        c = torch.clamp(c * li_contrib, 0.0, 1.0)
        # t_max = dir.length() quirk: glm vec3::length() returns the
        # COMPONENT COUNT (3.0), not the magnitude (cpp:347,355)
        spawn_rows.append(torch.cat([
            s_origin, lpos - s_origin, c, t_hit[:, None],
            torch.full((n, 1), 3.0, dtype=f32, device=dev),
            w_now[:, None],
            arena.id.to(f32)[:, None], arena.depth.to(f32)[:, None],
            arena.inst.to(f32)[:, None], valid.to(f32)[:, None]], dim=1))

    # ---- Russian-roulette secondary bounce (cpp:577-607) ------------------
    if no_bounce:
        arena = arena.replace(active=arena.active & ~mask)
    else:
        ndepth = arena.depth - 1
        p = 1.0 - hash_uniform(arena.id, 991, rng_extra)
        bounce = mask & (ndepth > 0) & (w_now > p)
        t_sec = (1.0 - 16.0 * float(np.finfo(np.float32).eps)) * t_hit
        new_dir = _cosine_hemisphere(normal,
                                     hash_uniform2(arena.id, 992, rng_extra))
        new_origin = arena.origin + arena.direction * t_sec[:, None]
        new_w = w_now * dot3(new_dir, normal)
        arena = arena.replace(
            origin=torch.where(bounce[:, None], new_origin, arena.origin),
            direction=torch.where(bounce[:, None], new_dir, arena.direction),
            w=torch.where(bounce, new_w, w_now),
            depth=torch.where(bounce, ndepth, arena.depth),
            type=torch.where(bounce, int(RayType.SECONDARY), arena.type),
            # terminated hits die; bouncing rays stay queued in place
            active=arena.active & (~mask | bounce))
    if not spawn_rows:
        return arena, torch.zeros((0, 16), dtype=f32, device=dev)
    return arena, torch.cat(spawn_rows, dim=0)


def _pad_rows(a: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                    dtype=a.dtype, device=a.device)])


# ---------------------------------------------------------------------------
# the looped wavefront tracer

def _resolve_spawn_occlusion(scene: SceneData, accel, spawn: torch.Tensor,
                             tile: int, impl=None) -> torch.Tensor:
    """Occlusion-test the packed spawn matrix against each spawn's own
    instance and invalidate occluded rows (rtcOccluded semantics,
    EmbreeMeshAdapter.cpp:364-385, at spawn time)."""
    m = spawn.shape[0]
    if m == 0:
        return spawn
    valid = spawn[:, 15] > 0.5
    mesh_id, minv, _ = _gather_inst(scene, spawn[:, 14].to(torch.int32))
    o, d = _to_object(minv, spawn[:, 0:3], spawn[:, 3:6])
    ray_mesh = torch.where(valid, mesh_id, -1)
    queued = valid & (ray_mesh >= 0)
    if accel is not None:
        pad = -m % PACKET
        if pad:
            o, d = _pad_rows(o, pad), _pad_rows(d, pad)
            ray_mesh, queued = _pad_rows(ray_mesh, pad, -1), _pad_rows(
                queued, pad, False)
        hit = _intersect_bvh(scene, accel, o, d, ray_mesh, queued,
                             is_shadow=torch.ones_like(queued), impl=impl)
    else:
        hit = intersect_closest(o, d, ray_mesh, queued, scene.tri_v0,
                                scene.tri_e1, scene.tri_e2, scene.tri_mesh,
                                tile=tile)
    occluded = queued[:m] & (hit.prim[:m] >= 0)
    return torch.cat([spawn[:, :15], (valid & ~occluded).to(
        torch.float32)[:, None]], dim=1)


def _append_rays(arena: RayArena, spawn: torch.Tensor,
                 pending: bool = False) -> RayArena:
    """Prefix-sum allocation of the valid spawn rows into inactive lanes,
    taken from the TOP of the arena (the k-th valid row lands in the k-th
    free lane from the top). Rows that find no free lane are dropped (the
    arena's slack is make_arena's). pending=True enters each spawn as an
    escaped shadow (inst -1, prev = its instance) for the round's
    shuffle."""
    m = spawn.shape[0]
    if m == 0:
        return arena
    dev = spawn.device
    valid = spawn[:, 15] > 0.5
    inact = ~arena.active
    rank_top = torch.flip(torch.cumsum(torch.flip(inact, (0,)).to(
        torch.int64), dim=0), (0,)) - 1
    vrank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    # rank -> spawn row; ranks with no valid spawn keep the fill value m
    row_of_rank = _scatter_drop(m, m, torch.where(valid, vrank, m), rows)
    src_row = torch.where(inact, row_of_rank[rank_top.clamp(0, m - 1)], m)
    written = src_row < m
    # index_select: a cheap backward (see _process_surface_hits)
    buf = torch.index_select(spawn, 0, src_row.clamp(0, m - 1))
    w3 = written[:, None]
    inst_row = buf[:, 14].to(torch.int32)
    none = torch.full_like(inst_row, -1)

    def sel(col, old):
        return torch.where(written, col, old)

    return arena.replace(
        origin=torch.where(w3, buf[:, 0:3], arena.origin),
        direction=torch.where(w3, buf[:, 3:6], arena.direction),
        color=torch.where(w3, buf[:, 6:9], arena.color),
        t=sel(buf[:, 9], arena.t),
        t_max=sel(buf[:, 10], arena.t_max),
        w=sel(buf[:, 11], arena.w),
        id=sel(buf[:, 12].to(torch.int32), arena.id),
        depth=sel(buf[:, 13].to(torch.int32), arena.depth),
        type=sel(int(RayType.SHADOW), arena.type),
        inst=sel(none if pending else inst_row, arena.inst),
        prev=sel(inst_row if pending else none, arena.prev),
        active=arena.active | written)


def trace_round(scene: SceneData, arena: RayArena, fb: torch.Tensor,
                round_idx: int, tile: int, accel=None, impl=None):
    """One wavefront round: intersect every queued ray against its own
    instance, shade the surface hits and test their fresh shadow spawns
    at once (a spawn lives in its parent's instance), append the
    survivors as escaped shadows, shuffle."""
    o_obj, d_obj, ray_mesh = to_object_space(scene, arena)
    queued = arena.active & (arena.inst >= 0) & (ray_mesh >= 0)
    is_shadow = arena.type == int(RayType.SHADOW)
    if accel is not None:
        hit = _intersect_bvh(scene, accel, o_obj, d_obj, ray_mesh, queued,
                             is_shadow=is_shadow, impl=impl)
    else:
        hit = intersect_closest(o_obj, d_obj, ray_mesh, queued, scene.tri_v0,
                                scene.tri_e1, scene.tri_e2, scene.tri_mesh,
                                tile=tile)
    got_hit = queued & (hit.prim >= 0)
    # shadow rays: a hit is occlusion (the ray dies); a miss leaves the
    # instance, as a primary or secondary miss does
    shadow_occluded = got_hit & is_shadow
    surf = queued & ~is_shadow
    escapes = queued & (hit.prim < 0)
    arena = arena.replace(prev=torch.where(escapes, arena.inst, arena.prev),
                          inst=torch.where(escapes, -1, arena.inst))
    arena, spawn = _process_surface_hits(scene, arena, hit,
                                         surf & (hit.prim >= 0), round_idx)
    # occluded shadow rays die silently (EmbreeMeshAdapter.cpp:492)
    arena = arena.replace(active=arena.active & ~shadow_occluded)
    spawn = _resolve_spawn_occlusion(scene, accel, spawn, tile, impl=impl)
    arena = _append_rays(arena, spawn, pending=True)
    return shuffle(scene, arena, fb, initial=False)


def trace_image(scene: SceneData, arena: RayArena, width: int, height: int,
                max_rounds: int = 64, unroll: bool = False, accel=None,
                impl=None) -> torch.Tensor:
    """Trace a camera wavefront (make_arena) to completion; returns the
    framebuffer.

    The default runs rounds until no lane holds a queued ray, testing that
    once per round on the host (GraviT's all-queues-empty termination);
    `unroll=True` runs exactly `max_rounds` rounds with no test. The JAX
    function's `key` argument is not taken: every random draw is the
    counter hash of (pixel, purpose, round, depth).
    """
    fb = image_lib.new_framebuffer(width, height, arena.origin.device)
    tile = _choose_tile(scene.num_triangles)
    arena, fb = shuffle(scene, arena, fb)      # FilterRaysLocally analog
    for r in range(max_rounds):
        if not unroll and not bool((arena.active & (arena.inst >= 0)).any()):
            break
        arena, fb = trace_round(scene, arena, fb, r, tile, accel=accel,
                                impl=impl)
    return fb


def _round_step(scene: SceneData, arena: RayArena, fb: torch.Tensor,
                round_idx: int, accel=None, impl=None):
    arena, fb = trace_round(scene, arena, fb, round_idx,
                            _choose_tile(scene.num_triangles), accel=accel,
                            impl=impl)
    live = (arena.active & (arena.inst >= 0)).sum()
    return arena, fb, live


def _initial_shuffle(scene: SceneData, arena: RayArena, width: int,
                     height: int):
    fb = image_lib.new_framebuffer(width, height, arena.origin.device)
    return shuffle(scene, arena, fb)


def trace_image_stepped(scene: SceneData, arena: RayArena, width: int,
                        height: int, max_rounds: int = 64, accel=None,
                        timer=None, impl=None) -> torch.Tensor:
    """trace_image with the round count read on the host after each round,
    and each round timed by `timer` (core.timing.Timer) when given. Same
    results."""
    arena, fb = _initial_shuffle(scene, arena, width, height)
    for r in range(max_rounds):
        with (timer.phase(f"round{r}") if timer is not None
              else contextlib.nullcontext()):
            arena, fb, live = _round_step(scene, arena, fb, r, accel, impl)
            n_live = int(live)
        if n_live == 0:
            break
    return fb


# ---------------------------------------------------------------------------
# the megapasses

def _tile_remap(rays: RayArena, width: int, height: int, T: int) -> RayArena:
    """Remap row-major camera lanes into T x T film tiles (tight packet
    frusta for the traversal kernel); _per_lane_to_fb inverts it."""
    n0 = rays.capacity

    def to_tiles(a):
        rest = tuple(a.shape[1:])
        return (a.reshape((height // T, T, width // T, T) + rest)
                .permute((0, 2, 1, 3) + tuple(4 + i for i in range(len(rest))))
                .reshape((n0,) + rest))

    return rays.map(to_tiles)


def _per_lane_to_fb(fb, per_lane, n0: int, samples: int, tiled: bool,
                    width: int, height: int, T: int):
    """(n_lanes, 4) per-lane rgba -> framebuffer add: the camera emits
    lanes in ((j*W+i)*S+k)*S+s order, so pixel == lane // S^2 (tiled films
    also undo the tile permutation); no pixel-id scatter."""
    ss = samples * samples
    n_pix = fb.shape[0]
    if tiled:
        per_pixel = (per_lane[:n0]
                     .reshape(height // T, width // T, T, T, 4)
                     .permute(0, 2, 1, 3, 4)
                     .reshape(n_pix, 4))
    else:
        grouped = per_lane[:n_pix * ss].reshape(n_pix, ss, 4)
        per_pixel = grouped[:, 0]
        for k in range(1, ss):        # left-to-right, as XLA's reduce
            per_pixel = per_pixel + grouped[:, k]
    return fb + per_pixel


def _spawn_rgba(spawn: torch.Tensor, deposit: torch.Tensor) -> torch.Tensor:
    """(m, 4) rgba rows (color*w, 1) of the depositing spawns, 0 elsewhere."""
    m = spawn.shape[0]
    rgba = torch.cat([spawn[:, 6:9] * spawn[:, 11:12],
                      torch.ones((m, 1), dtype=torch.float32,
                                 device=spawn.device)], dim=1)
    return torch.where(deposit[:, None], rgba, 0.0)


def _dense_spawn_deposit(fb, spawn, deposit, n_lanes: int, n0: int,
                         samples: int, tiled: bool, width: int, height: int,
                         T: int):
    """Whole-film dense shadow deposit: spawn row li*n + lane maps back to
    its lane by reshape, the lights summed left to right, then
    _per_lane_to_fb's dense add (bit-stable: no scatter)."""
    per_light = _spawn_rgba(spawn, deposit).reshape(-1, n_lanes, 4)
    per_lane = per_light[0]
    for li in range(1, per_light.shape[0]):
        per_lane = per_lane + per_light[li]
    return _per_lane_to_fb(fb, per_lane, n0, samples, tiled, width, height, T)


def _film_layout(rays: RayArena, width: int, height: int, samples: int,
                 tile_order: bool, dense_deposit: bool):
    """The megapasses' common prologue: whether the dense deposit and the
    tile order apply, the tile-remapped wavefront, padded to a PACKET
    multiple. Returns (rays, dense_deposit, tiled, T)."""
    n0 = rays.capacity
    dense_deposit = dense_deposit and n0 == width * height * samples * samples
    T = int(PACKET ** 0.5)
    tiled = (tile_order and dense_deposit and samples == 1
             and n0 == width * height
             and width % T == 0 and height % T == 0)
    if tiled:
        rays = _tile_remap(rays, width, height, T)
    pad = -n0 % PACKET
    if pad:
        rays = rays.map(lambda a: _pad_rows(a, pad))
    return rays, dense_deposit, tiled, T


def _live_first_sel(live: torch.Tensor, thresh: int) -> torch.Tensor:
    """The first `thresh` lane indices in (live first, stable lane order),
    exactly `argsort(~live, stable=True)[:thresh]`, from two cumsums and
    one scatter. Every index appears once (thresh <= lanes)."""
    n = live.shape[0]
    li = live.to(torch.int64)
    rank_live = torch.cumsum(li, dim=0) - li
    dead = 1 - li
    rank_dead = torch.cumsum(dead, dim=0) - dead
    n_live = rank_live[-1] + li[-1]
    pos = torch.where(live, rank_live, n_live + rank_dead)
    return _scatter_drop(thresh, 0, pos, torch.arange(
        n, dtype=torch.int64, device=live.device))


def _compact_width(n: int) -> int:
    """Width of a hop loop's compacted tail: n // 8, at least one PACKET,
    rounded up to a PACKET multiple."""
    return -(-max(PACKET, n // 8) // PACKET) * PACKET


def trace_image_fast_multi(scene: SceneData, rays: RayArena, width: int,
                           height: int, accel=None, max_rounds: int = 64,
                           samples: int = 1, tile_order: bool = True,
                           dense_deposit: bool = True,
                           impl=None) -> torch.Tensor:
    """Multi-instance depth-1 megapass: the frame in three dense phases.

      A. closest-hit hop loop over the camera wavefront (capacity N): a
         ray that hits freezes with its hit and its freeze round; a miss
         hops to the next instance through the 0.95-bump shuffle. Rounds
         run at full width while more than N//8 lanes are live, then the
         live lanes compact into an N//8 arena for the tail.
      B. one dense shade + spawn pass over every frozen hit, its light
         samples seeded by the freeze round (as the looped tracer seeds
         them by the round it shades in).
      C. any-hit hop loop over the dense (light, lane) spawn matrix, full
         width then compacted the same way; the unoccluded rows that left
         the scene deposit densely (or through the pixel-id scatter).

    Equal to trace_image when no ray can bounce (camera max_depth 1);
    callers gate on that. `rays` is the raw camera wavefront. Each loop
    reads its condition on the host once per round. `impl="plain"` runs
    the traversal's plain version (comparisons only).
    """
    dev = rays.origin.device
    fb = image_lib.new_framebuffer(width, height, dev)
    n0 = rays.capacity
    rays, dense_deposit, tiled, T = _film_layout(
        rays, width, height, samples, tile_order, dense_deposit)
    arena, fb = shuffle(scene, rays, fb)        # FilterRaysLocally analog
    n = arena.capacity
    tile = _choose_tile(scene.num_triangles)

    def closest(o_obj, d_obj, mesh, queued, is_shadow=None):
        if accel is not None:
            return _intersect_bvh(scene, accel, o_obj, d_obj, mesh, queued,
                                  is_shadow=is_shadow, impl=impl)
        return intersect_closest(o_obj, d_obj, mesh, queued, scene.tri_v0,
                                 scene.tri_e1, scene.tri_e2, scene.tri_mesh,
                                 tile=tile)

    def a_body(r, arena, hit, hitr):
        o_obj, d_obj, mesh = to_object_space(scene, arena)
        queued = arena.active & (arena.inst >= 0) & (mesh >= 0)
        h = closest(o_obj, d_obj, mesh, queued)
        got = queued & (h.prim >= 0)
        hit = _merge_hit(hit, got, *h)
        # camera rays hop one instance per looped round, so hop round r
        # IS the round the looped tracer shades this hit in
        hitr = torch.where(got, r, hitr)
        escapes = queued & (h.prim < 0)
        # hits freeze (inactive, inst kept for phase B's normi gather);
        # escapes hop through the 0.95-bump requeue
        arena = arena.replace(
            prev=torch.where(escapes, arena.inst, arena.prev),
            inst=torch.where(escapes, -1, arena.inst),
            active=arena.active & ~got)
        pending = arena.active & (arena.inst < 0)
        found, nxt, t_entry = _next_instance(
            scene, arena.origin, arena.direction, arena.t_max, arena.prev,
            pending)
        requeue = pending & found
        arena = arena.replace(
            origin=torch.where(requeue[:, None], arena.origin
                               + arena.direction * (t_entry * 0.95)[:, None],
                               arena.origin),
            inst=torch.where(requeue, nxt, arena.inst),
            active=arena.active & ~(pending & ~found))
        return arena, hit, hitr

    # ---- phase A ----------------------------------------------------------
    hit = _empty_hit(n, dev)
    hitr = torch.zeros((n,), dtype=torch.int32, device=dev)
    thresh = _compact_width(n)
    r = 0
    while r < max_rounds and int(arena.active.sum()) > thresh:
        arena, hit, hitr = a_body(r, arena, hit, hitr)
        r += 1
    sel = _live_first_sel(arena.active, thresh)
    arena_s = arena.map(lambda a: a[sel])
    hit_s, hitr_s = Hit(*(a[sel] for a in hit)), hitr[sel]
    while r < max_rounds and bool(arena_s.active.any()):
        arena_s, hit_s, hitr_s = a_body(r, arena_s, hit_s, hitr_s)
        r += 1
    # the tail's lanes back in place (sel holds no index twice)
    hit = Hit(*(big.index_copy(0, sel, small)
                for big, small in zip(hit, hit_s)))
    hitr = hitr.index_copy(0, sel, hitr_s)
    arena = RayArena(**{
        f.name: getattr(arena, f.name).index_copy(0, sel,
                                                  getattr(arena_s, f.name))
        for f in dataclasses.fields(RayArena)})
    arena = arena.replace(active=hit.prim >= 0)

    # ---- phases B + C -----------------------------------------------------
    L = scene.num_lights
    if L == 0:
        return image_lib.clamp_rgb(fb)
    spawn, dep = _multi_resolve(scene, arena, hit, hitr, closest, max_rounds)
    if dense_deposit:
        fb = _dense_spawn_deposit(fb, spawn, dep, n, n0, samples, tiled,
                                  width, height, T)
    else:
        m = spawn.shape[0]
        fb = image_lib.local_add(
            fb, spawn[:, 12].to(torch.int32), spawn[:, 6:9] * spawn[:, 11:12],
            torch.ones((m,), dtype=torch.float32, device=dev), dep)
    return image_lib.clamp_rgb(fb)


def _multi_resolve(scene: SceneData, arena: RayArena, hit: Hit, hitr,
                   closest, max_rounds: int):
    """Fast-multi phases B + C at the arena's width: one dense shade +
    spawn over the resolved hits (active lanes), then the shadow any-hit
    hop loop (full width while more than m//8 rows live, the compacted
    tail after). Returns (spawn, deposit mask)."""
    arena, spawn = _process_surface_hits(scene, arena, hit, arena.active,
                                         hitr, no_bounce=True)
    m = spawn.shape[0]
    dev = spawn.device
    s_valid = spawn[:, 15] > 0.5
    s_dir = spawn[:, 3:6]
    s_tmax = spawn[:, 10]                        # the glm length()=3.0 quirk
    origin, inst = spawn[:, 0:3], spawn[:, 14].to(torch.int32)
    prev = torch.full((m,), -1, dtype=torch.int32, device=dev)
    dead = torch.zeros((m,), dtype=torch.bool, device=dev)
    done = torch.zeros((m,), dtype=torch.bool, device=dev)

    def c_body(origin, inst, prev, dead, done, s_dir, s_tmax, valid):
        live = valid & ~dead & ~done
        mesh_id, minv, _ = _gather_inst(scene, inst)
        o_obj, d_obj = _to_object(minv, origin, s_dir)
        mesh = torch.where(inst >= 0, mesh_id, -1)
        queued = live & (inst >= 0) & (mesh >= 0)
        h = closest(o_obj, d_obj, mesh, queued,
                    is_shadow=torch.ones_like(queued))
        dead = dead | (queued & (h.prim >= 0))
        escapes = queued & (h.prim < 0)
        prev = torch.where(escapes, inst, prev)
        inst = torch.where(escapes, -1, inst)
        pending = valid & ~dead & ~done & (inst < 0)
        found, nxt, t_entry = _next_instance(scene, origin, s_dir, s_tmax,
                                             prev, pending)
        requeue = pending & found
        origin = torch.where(requeue[:, None],
                             origin + s_dir * (t_entry * 0.95)[:, None],
                             origin)
        inst = torch.where(requeue, nxt, inst)
        done = done | (pending & ~found)         # left the whole scene
        return origin, inst, prev, dead, done

    c_thresh = _compact_width(m)
    r = 0
    while (r < max_rounds
           and int((s_valid & ~dead & ~done).sum()) > c_thresh):
        origin, inst, prev, dead, done = c_body(
            origin, inst, prev, dead, done, s_dir, s_tmax, s_valid)
        r += 1
    sel = _live_first_sel(s_valid & ~dead & ~done, c_thresh)
    small = [a[sel] for a in (origin, inst, prev, dead, done)]
    rows = [a[sel] for a in (s_dir, s_tmax, s_valid)]
    while r < max_rounds and bool((rows[2] & ~small[3] & ~small[4]).any()):
        small = list(c_body(*small, *rows))
        r += 1
    dead = dead.index_copy(0, sel, small[3])
    done = done.index_copy(0, sel, small[4])
    deposit = (s_valid & ~dead & done
               & (dot3(spawn[:, 6:9], spawn[:, 6:9]) > 0.0))
    return spawn, deposit


def trace_image_fast(scene: SceneData, rays: RayArena, width: int,
                     height: int, accel=None, dense_deposit: bool = True,
                     samples: int = 1, tile_order: bool = True,
                     max_depth: int = 1, impl=None) -> torch.Tensor:
    """Single-instance megapass: the whole frame in max_depth + 1 traversal
    dispatches with zero arena churn (reference semantics: trace_image on
    one instance, any depth 1..6).

    Generation g re-traces the lanes that Russian-roulette bounced in
    generation g-1, so its hits land exactly at looped round g (the
    generation index seeds the RNG). The K*L*N shadow spawns resolve in ONE
    any-hit dispatch; blocks with no live lane are skipped by the kernel.
    `rays` is the raw camera wavefront on the device the frame runs on.
    `dense_deposit=True` requires a whole-film wavefront (lane i == pixel
    i // S^2); other wavefronts deposit through the pixel-id scatter.
    `impl="plain"` runs the traversal's plain version (comparisons only).
    """
    if scene.num_instances != 1:
        raise ValueError("trace_image_fast renders one instance; "
                         "use trace_image_fast_multi or trace_image")
    if not 1 <= max_depth <= MAX_FAST_DEPTH:
        raise ValueError(f"max_depth must be in 1..{MAX_FAST_DEPTH}, "
                         f"got {max_depth}")
    dev = rays.origin.device
    fb = image_lib.new_framebuffer(width, height, dev)
    n0 = rays.capacity
    rays, dense_deposit, tiled, T = _film_layout(
        rays, width, height, samples, tile_order, dense_deposit)

    # phase 0: assign camera rays their first (only) instance
    arena, fb = shuffle(scene, rays, fb)

    # phase 1: K = max_depth bounce generations; generation K-1 cannot
    # bounce (depth counts down from max_depth), so it runs no_bounce
    tile = _choose_tile(scene.num_triangles)
    spawns = []
    for g in range(max_depth):
        o_obj, d_obj, ray_mesh = to_object_space(scene, arena)
        queued = arena.active & (arena.inst >= 0) & (ray_mesh >= 0)
        if accel is not None:
            hit = _intersect_bvh(scene, accel, o_obj, d_obj, ray_mesh,
                                 queued, impl=impl)
        else:
            hit = intersect_closest(
                o_obj, d_obj, ray_mesh, queued, scene.tri_v0, scene.tri_e1,
                scene.tri_e2, scene.tri_mesh, tile=tile)
        surf_hits = queued & (hit.prim >= 0)
        arena, spawn_g = _process_surface_hits(
            scene, arena, hit, surf_hits, g, no_bounce=(g == max_depth - 1))
        spawns.append(spawn_g)
        if g < max_depth - 1:
            arena = arena.replace(
                active=arena.active & ~(queued & (hit.prim < 0)))
    spawn = torch.cat(spawns, dim=0)

    # phase 2: occlusion-test the dense (generation, light, lane) spawn
    # matrix in place; shadow rays live in the instance they spawned in
    m = spawn.shape[0]
    if m == 0:
        return image_lib.clamp_rgb(fb)
    s_valid = spawn[:, 15] > 0.5
    s_o, s_d = _to_object(scene.inst_minv[0].expand(m, 4, 4), spawn[:, 0:3],
                          spawn[:, 3:6])
    pad = -m % PACKET
    if pad:
        s_o, s_d, s_valid_p = (_pad_rows(s_o, pad), _pad_rows(s_d, pad),
                               _pad_rows(s_valid, pad))
    else:
        s_valid_p = s_valid
    mesh_ids = scene.inst_mesh[0].expand(s_o.shape[0])
    if accel is not None:
        hit2 = _intersect_bvh(scene, accel, s_o, s_d, mesh_ids, s_valid_p,
                              is_shadow=True, impl=impl)
    else:
        hit2 = intersect_closest(
            s_o, s_d, mesh_ids, s_valid_p, scene.tri_v0, scene.tri_e1,
            scene.tri_e2, scene.tri_mesh, tile=tile)
    occluded = hit2.prim[:m] >= 0

    # retire: unoccluded shadow rays deposit color*w (TracerBase.h:396-399),
    # one generation at a time ((fb + c_g0) + c_g1 + ...), as the looped
    # tracer retires generation g's shadows in round g
    color = spawn[:, 6:9]
    deposit = s_valid & ~occluded & (dot3(color, color) > 0.0)
    m_gen = m // max_depth
    for g in range(max_depth):
        sl = slice(g * m_gen, (g + 1) * m_gen)
        spawn_g, deposit_g = spawn[sl], deposit[sl]
        if dense_deposit:
            fb = _dense_spawn_deposit(fb, spawn_g, deposit_g,
                                      arena.capacity, n0, samples, tiled,
                                      width, height, T)
        else:
            fb = image_lib.local_add(
                fb, spawn_g[:, 12].to(torch.int32),
                spawn_g[:, 6:9] * spawn_g[:, 11:12],
                torch.ones((m_gen,), dtype=torch.float32, device=dev),
                deposit_g)
    return image_lib.clamp_rgb(fb)


def make_arena(camera_rays: RayArena, num_lights: int,
               slack: float = 1.25) -> RayArena:
    """Embed camera rays into an arena with room for shadow spawns.

    num_lights=0 (volume wavefronts, which never spawn) gets a tight arena:
    every per-round op scales with arena capacity, so slack lanes are pure
    marching cost. Capacity is rounded up to a multiple of 1024.
    """
    n = camera_rays.capacity
    spawn_mult = (1 + num_lights) if num_lights > 0 else 1
    cap = int(n * spawn_mult * (slack if num_lights > 0 else 1.0))
    cap = -(-cap // 1024) * 1024
    if cap == n:
        return camera_rays
    arena = RayArena.zeros(cap, camera_rays.origin.device)
    return RayArena(**{
        f.name: torch.cat([getattr(camera_rays, f.name),
                           getattr(arena, f.name)[n:]])
        for f in dataclasses.fields(RayArena)})
