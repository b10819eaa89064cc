"""Single-instance surface megapass, counterpart of the main-path functions
of gravit_tpu/render/tracer.py.

`trace_image_fast` renders a whole frame in max_depth + 1 traversal
dispatches: one closest-hit per bounce generation over the camera-lane
wavefront, then one any-hit over every generation's shadow rays together,
followed by a dense per-generation deposit. Result-equivalence map
(reference -> here):
  EmbreeMeshAdapter::trace closest-hit   -> _intersect_bvh / intersect_closest
  traceShadowRays rtcOccluded            -> the any-hit pass over the spawns
  generateShadowRays + Shade             -> _process_surface_hits
  TracerBase::shuffleRays                -> shuffle()

The multi-instance and looped tracers are ROADMAP slice C: the functions
here raise on scenes they do not cover. 3x3 transforms are written as
broadcast-multiply + left-to-right sums, never as matmuls.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

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
_SLICE_C = "not ported yet (ROADMAP slice C)"


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(|x|^2, tiny)) over the last (size-3) axis, kept as (..., 1)."""
    return torch.sqrt(torch.clamp(dot3(x, x), min=1e-30))[..., None]


def _choose_tile(num_tris: int) -> int:
    return max(128, min(256, -(-num_tris // 128) * 128))


def _require_single_instance(scene: SceneData) -> None:
    if scene.num_instances != 1:
        raise NotImplementedError(
            f"{scene.num_instances}-instance scenes are {_SLICE_C}")


def _gather_inst(scene: SceneData, inst: torch.Tensor):
    """Per-ray instance data (mesh id, minv, normi); one instance only."""
    _require_single_instance(scene)
    n = inst.shape[0]
    return (scene.inst_mesh[0].expand(n),
            scene.inst_minv[0].expand(n, 4, 4),
            scene.inst_normi[0].expand(n, 3, 3))


def _transform(m3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 times (N, 3) as broadcast-multiply + left-to-right sum
    (the reference's "nij,nj->ni"), never a matmul."""
    return dot3(m3, x[:, None, :])


def to_object_space(scene: SceneData, arena: RayArena):
    """World->object ray transform per lane (the rtcSetTransform analog).
    The direction is NOT renormalized so `t` has one scale in both spaces."""
    mesh_id, minv, _ = _gather_inst(scene, arena.inst)
    o = _transform(minv[:, :3, :3], arena.origin) + minv[:, :3, 3]
    d = _transform(minv[:, :3, :3], arena.direction)
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
    them retire directly.
    """
    _require_single_instance(scene)
    pending = arena.active & (arena.inst < 0)
    is_shadow = arena.type == int(RayType.SHADOW)

    def deposit_retired(fb, retire):
        dep = retire & is_shadow & (dot3(arena.color, arena.color) > 0.0)
        return image_lib.local_add(fb, arena.id, arena.color * arena.w[:, None],
                                   torch.ones_like(arena.w), dep)

    if not initial:
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
    # initial=True: the wavefront is all-PRIMARY (camera generation), so
    # the retired-shadow deposit is a guaranteed no-op and is skipped
    return arena.replace(origin=new_origin,
                         inst=torch.where(requeue, nxt, arena.inst),
                         active=arena.active & ~(pending & ~found)), fb


def _next_instance(scene: SceneData, origin, direction, t_max, prev,
                   pending):
    """BVH::intersect leaf semantics (BVH.h:61-135, `update=true` slab):
    the closest instance AABB with tfar > tnear, tnear > RAY_EPSILON,
    tnear < t_max, excluding `prev`; a scan over instances with a running
    strict-< minimum. Returns (found, next_inst, t_entry)."""
    small = torch.abs(direction) < 1e-30
    d_safe = torch.where(small, 1.0, direction)
    inv_dir = torch.where(small, torch.where(direction < 0, -1e30, 1e30),
                          1.0 / d_safe)
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


def _intersect_bvh(scene: SceneData, accel, o_obj, d_obj, queued,
                   any_hit: bool = False, impl=None) -> Hit:
    """Hit query through the packet-BVH kernel, single-mesh branch: the
    wavefront's natural layout is already block-contiguous, so each block
    with a queued lane traverses from the mesh's root and the rest are
    skipped (root -1). `any_hit` gives occlusion (rtcOccluded) semantics:
    only prim >= 0 is meaningful. One dispatch per call."""
    if accel.num_meshes != 1:
        raise NotImplementedError(f"multi-mesh BVH dispatch is {_SLICE_C}")
    n = o_obj.shape[0]
    has = queued.reshape(n // PACKET, PACKET).any(dim=1)
    block_root = torch.where(has, accel.mesh_root[0], -1).to(torch.int32)
    t, prim, u, v = bvh_intersect(
        o_obj.contiguous(), d_obj.contiguous(), queued.to(torch.int32),
        block_root, accel.bounds, accel.meta, accel.tri, any_hit=any_hit,
        impl=impl)
    gprim = torch.where(prim >= 0, accel.leaf2global[prim.clamp(min=0)], -1)
    return Hit(t=torch.where(queued, t, FLT_MAX),
               prim=torch.where(queued, gprim, -1),
               u=torch.where(queued, u, 0.0),
               v=torch.where(queued, v, 0.0))


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


def _process_surface_hits(scene: SceneData, arena: RayArena, hit: Hit,
                          mask: torch.Tensor, round_idx: int,
                          no_bounce: bool = False):
    """Hit shading (EmbreeMeshAdapter.cpp:484-607), the single-instance
    column form: sums over the 3-axis written as per-component columns.

    Returns (arena, spawn): `spawn` stacks one packed (N, 16) row block per
    light [origin 0:3 | dir 3:6 | color 6:9 | t 9 | t_max 10 | w 11 | id 12
    | depth 13 | inst 14 | valid 15]. no_bounce=True removes the
    Russian-roulette block (a depth-1 generation never bounces).
    """
    _require_single_instance(scene)
    n = arena.capacity
    dev = arena.origin.device
    prim = torch.clamp(hit.prim, 0, scene.num_triangles - 1).to(torch.int64)
    t_hit = torch.where(mask, hit.t, 1.0)
    _, _, normi = _gather_inst(scene, arena.inst)

    (ns, vcol, kd_face, ks, tri_e1, tri_e2, alpha, mat_type_face, has_vc1,
     embree_params) = _unpack_shade_row(scene, _pack_shade_table(scene)[prim])

    # interpolated shading normal a*u + b*v + c*(1-u-v), corners (1, 2, 0)
    # (EmbreeMeshAdapter.cpp:510-521)
    u1, v1 = hit.u, hit.v
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
    dir_c = [arena.direction[:, c] for c in range(3)]
    flip = ((-dir_c[0]) * nfl[0] + (-dir_c[1]) * nfl[1]
            + (-dir_c[2]) * nfl[2]) <= 0.0
    normal_c = [torch.where(flip, -c, c) for c in nsh]
    normal = torch.stack(normal_c, dim=1)
    u_, v_ = u1[:, None], v1[:, None]

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
        dv = [lpos[:, c] - hit_point[:, c] for c in range(3)]
        dist = torch.sqrt(torch.clamp(
            dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], min=1e-30))
        fall = torch.clamp(1.0 / torch.clamp(dist, min=1e-30), max=1.0)
        wi_c = [c / dist for c in dv]
        ndotl = torch.clamp(normal_c[0] * wi_c[0] + normal_c[1] * wi_c[1]
                            + normal_c[2] * wi_c[2], min=0.0)
        wi = torch.stack(wi_c, dim=1)
        li_contrib = torch.where(kind == int(LightKind.AMBIENT),
                                 scene.lights_color[li].expand(n, 3),
                                 scene.lights_color[li] * fall[:, None])
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
    return arena, torch.cat(spawn_rows, dim=0)


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


def _dense_spawn_deposit(fb, spawn, deposit, n_lanes: int, n0: int,
                         samples: int, tiled: bool, width: int, height: int,
                         T: int):
    """Whole-film dense shadow deposit: spawn row li*n + lane maps back to
    its lane by reshape, then _per_lane_to_fb's dense add."""
    m = spawn.shape[0]
    rgba = torch.cat([spawn[:, 6:9] * spawn[:, 11:12],
                      torch.ones((m, 1), dtype=torch.float32,
                                 device=spawn.device)], dim=1)
    rgba = torch.where(deposit[:, None], rgba, 0.0)
    per_light = rgba.reshape(m // n_lanes, n_lanes, 4)
    per_lane = per_light[0]
    for li in range(1, per_light.shape[0]):   # left-to-right
        per_lane = per_lane + per_light[li]
    return _per_lane_to_fb(fb, per_lane, n0, samples, tiled, width, height, T)


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
    _require_single_instance(scene)
    if not 1 <= max_depth <= MAX_FAST_DEPTH:
        raise ValueError(f"max_depth must be in 1..{MAX_FAST_DEPTH}, "
                         f"got {max_depth}")
    dev = rays.origin.device
    fb = image_lib.new_framebuffer(width, height, dev)
    n0 = rays.capacity
    dense_deposit = dense_deposit and n0 == width * height * samples * samples
    T = int(PACKET ** 0.5)
    tiled = (tile_order and dense_deposit and samples == 1
             and n0 == width * height
             and width % T == 0 and height % T == 0)
    if tiled:
        rays = _tile_remap(rays, width, height, T)
    if n0 % PACKET:
        pad = PACKET - n0 % PACKET
        rays = rays.map(lambda a: torch.cat(
            [a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=dev)]))

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
            hit = _intersect_bvh(scene, accel, o_obj, d_obj, queued,
                                 impl=impl)
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
    s_valid = spawn[:, 15] > 0.5
    minv = scene.inst_minv[0]
    m3 = minv[:3, :3].expand(m, 3, 3)
    s_o = _transform(m3, spawn[:, 0:3]) + minv[:3, 3]
    s_d = _transform(m3, spawn[:, 3:6])
    if m % PACKET:
        pad = PACKET - m % PACKET
        z = lambda a: torch.cat([a, torch.zeros(  # noqa: E731
            (pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)])
        s_o, s_d, s_valid_p = z(s_o), z(s_d), z(s_valid)
    else:
        s_valid_p = s_valid
    if accel is not None:
        hit2 = _intersect_bvh(scene, accel, s_o, s_d, s_valid_p,
                              any_hit=True, impl=impl)
    else:
        mesh_ids = scene.inst_mesh[0].expand(s_o.shape[0])
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
