"""Wavefront volume tracer: ray-march bricks + flag-protocol shuffle, and the
single-brick megapass. Counterpart of gravit_tpu/render/volume_tracer.py.

Round structure mirrors the reference's volume path (SURVEY.md §3.4):
  1. march every queued ray through its brick (the slice engine where the
     gate allows, ops/volume_march.py otherwise): the ospTraceRays step;
     rays accumulate rgb in color, opacity in w, and get RAY_OPAQUE /
     RAY_BOUNDARY termination flags in depth
  2. volume shuffle (DomainTracer.cpp:255-305): BOUNDARY rays re-enter the
     instance BVH (excluding the brick just left), bump origin by
     (1+eps)*t into the next brick or become EXTERNAL_BOUNDARY; PRIMARY
     rays with OPAQUE|EXTERNAL deposit color*w and retire
The initial camera-ray filter is the generic 0.95-bump queueing
(DomainTracer.h:158-167): flags are only honored after the first march.

Spans (core/timing.py): `volume.frame` around each tracer call,
`volume.round` around each round's march and shuffle, `volume.march_slice`
/ `volume.march_gather` around each brick's pass by its engine (the
megapass's one launch is a slice pass), `volume.shuffle`,
`volume.instance_search` around the instance-box query (inside it
`tracer.instance_slab`, the surface tracer's search), and `tracer.sync`
around every host read of the card's answer (the round test, the gates'
reductions, the gather march's early-exit test).
"""

from __future__ import annotations

import numpy as np
import torch

from gravit_tpu_torch.core.math3d import dot3
from gravit_tpu_torch.core.rays import (RAY_BOUNDARY, RAY_EXTERNAL_BOUNDARY,
                                        RAY_OPAQUE, RayArena, VolumeRayType)
from gravit_tpu_torch.core.timing import span, spanned
from gravit_tpu_torch.ops import slice_march as sm
from gravit_tpu_torch.ops.instance_slab import closest_box
from gravit_tpu_torch.ops.volume_march import march_brick
from gravit_tpu_torch.render.volume_scene import VolumeSceneData
from gravit_tpu_torch.scene import image as image_lib


def _host(x: torch.Tensor):
    """x on the host, as numpy: the tracer waits for the card here."""
    with span("tracer.sync"):
        return x.cpu().numpy()


@spanned("volume.instance_search")
def _instance_bvh_hit(scene: VolumeSceneData, arena: RayArena,
                      exclude: torch.Tensor, impl=None):
    """Closest instance AABB (leaf `update=true` semantics), excluding
    `exclude` per ray: the surface tracer's search over every instance box
    (ops/instance_slab.py::closest_box, one kernel launch on the card;
    impl="plain" runs its plain version). Returns (found, next_inst,
    tnear)."""
    return closest_box(scene.inst_lo, scene.inst_hi, arena.origin,
                       arena.direction, arena.t_max, exclude, impl=impl)


def filter_initial(scene: VolumeSceneData, arena: RayArena,
                   impl=None) -> RayArena:
    """Generic first queueing with 0.95*t bump (DomainTracer.h:158-167)."""
    pending = arena.active & (arena.inst < 0)
    found, nxt, t_entry = _instance_bvh_hit(
        scene, arena, torch.full_like(arena.inst, -1), impl=impl)
    requeue = pending & found
    origin = torch.where(
        requeue[:, None],
        arena.origin + arena.direction * (t_entry * 0.95)[:, None],
        arena.origin)
    return arena.replace(
        origin=origin,
        inst=torch.where(requeue, nxt, arena.inst),
        active=arena.active & (~pending | requeue),
    )


def _per_volume(field: tuple, v: int) -> tuple:
    """A per-volume feature tuple may be shorter than num_volumes."""
    return field[v] if v < len(field) else ()


def held_volumes(scene: VolumeSceneData, arena: RayArena) -> torch.Tensor:
    """(num_volumes,) bool, where the arena lives: the scene's bricks that
    hold a queued ray (a ray whose instance has no local brick, inst_vol
    -1 under the domain scheduler, counts for none)."""
    queued = arena.active & (arena.inst >= 0)
    safe_inst = torch.clamp(arena.inst, 0, scene.num_instances - 1).long()
    vol_of_ray = torch.where(queued, scene.inst_vol[safe_inst], -1)
    ids = torch.arange(scene.num_volumes, device=queued.device)
    return (vol_of_ray[None, :] == ids[:, None]).any(dim=1)


def read_round(go: torch.Tensor, held: list) -> tuple:
    """The round test in one host read: (whether the bool scalar `go`
    holds, per held_volumes entry of `held` (of one length) the volumes it
    names, the bricks march_round is to march)."""
    read = _host(torch.cat([go[None], *held]))
    return bool(read[0]), [tuple(int(v) for v in np.nonzero(row)[0])
                           for row in read[1:].reshape(len(held), -1)]


def march_round(scene: VolumeSceneData, arena: RayArena,
                differentiable: bool = False, slice_axes: tuple = (),
                impl=None, film_width=None, *, volumes):
    """Phase 1: march all queued rays through their bricks, one pass per
    volume named in `volumes`; rays of other volumes are masked. Callers
    name the volumes that hold a queued ray (held_volumes, read_round), or
    every volume; another volume's pass would change no lane.

    Rays whose instance has no LOCAL brick data (inst_vol == -1 under the
    domain scheduler) park untouched.

    slice_axes: optional per-volume tuple of (axis, flip) | None. A volume
    with an entry marches through the slice engine (ops/slice_march.py)
    instead of the gather march; slice_axes_for computes the entries.
    impl="plain" runs the slice engine's plain version on any device.
    film_width: the film's width when the arena's lanes are the film in
    camera lane order (the slice kernels then march 2-D tiles of it).
    """
    safe_inst = torch.clamp(arena.inst, 0, scene.num_instances - 1).long()
    vol_of_ray = scene.inst_vol[safe_inst]
    queued = arena.active & (arena.inst >= 0) & (vol_of_ray >= 0)
    minv = scene.inst_minv[safe_inst]
    m3 = minv[:, :3, :3]
    # broadcast-multiply + left-to-right sums, never a matmul
    o_obj = dot3(m3, arena.origin[:, None, :]) + minv[:, :3, 3]
    d_obj = dot3(m3, arena.direction[:, None, :])

    color, w, depth = arena.color, arena.w, arena.depth
    for v in volumes:
        mask = queued & (vol_of_ray == v)
        use_slice = (not differentiable and v < len(slice_axes)
                     and slice_axes[v] is not None
                     and v < len(scene.vol_meta))
        subs = _per_volume(scene.vol_subgrids, v)
        isovals = tuple(float(x) for x in _per_volume(scene.vol_isovalues, v))
        slcs = tuple(tuple(float(x) for x in pl)
                     for pl in _per_volume(scene.vol_slices, v))
        if use_slice:
            axis, flip = slice_axes[v]
            spacing = scene.vol_meta[v][1]     # static (sizes the ladder)
            with span("volume.march_slice"):
                c2, w2, flags = sm.slice_march(
                    o_obj, d_obj, mask, color, w,
                    scene.vol_samples[v], scene.vol_color_lut[v],
                    scene.vol_opacity_lut[v],
                    axis=int(axis), flip=bool(flip),
                    step=float(scene.vol_step[v]),
                    base_step=float(min(spacing)),
                    low=scene.vol_vrange[v][0], high=scene.vol_vrange[v][1],
                    origin=scene.vol_origin[v], spacing=tuple(spacing),
                    isovalues=isovals, subgrids=subs, slices=slcs, impl=impl,
                    film_width=film_width)
        else:
            with span("volume.march_gather"):
                c2, w2, flags = march_brick(
                    o_obj, d_obj, mask, color, w,
                    scene.vol_samples[v], scene.vol_origin[v],
                    scene.vol_spacing[v],
                    scene.vol_lo[v], scene.vol_hi[v],
                    scene.vol_color_lut[v], scene.vol_opacity_lut[v],
                    scene.vol_vrange[v],
                    scene.vol_step[v], scene.vol_max_steps[v],
                    subgrids=subs, isovalues=isovals, slices=slcs,
                    early_exit=not differentiable)
        color = torch.where(mask[:, None], c2, color)
        w = torch.where(mask, w2, w)
        depth = torch.where(mask, flags, depth)

    # marched rays leave their queue; `prev` remembers the brick for the
    # shuffle's exclusion
    return arena.replace(
        color=color, w=w, depth=depth,
        prev=torch.where(queued, arena.inst, arena.prev),
        inst=torch.where(queued, -1, arena.inst),
    )


@spanned("volume.shuffle")
def shuffle_volume(scene: VolumeSceneData, arena: RayArena,
                   fb: torch.Tensor, impl=None):
    """Phase 2: the volume flag protocol (DomainTracer.cpp:255-305).
    impl="plain" runs the instance search's plain version."""
    pending = arena.active & (arena.inst < 0)
    found, nxt, t_entry = _instance_bvh_hit(scene, arena, arena.prev,
                                            impl=impl)

    depth = arena.depth
    boundary = pending & ((depth & RAY_BOUNDARY) > 0)
    # BOUNDARY + hit: clear flag, bump (1+eps)*t, queue next brick
    requeue = boundary & found
    eps1 = float(np.float32(1.0) + np.finfo(np.float32).eps)
    origin = torch.where(
        requeue[:, None],
        arena.origin + arena.direction * (t_entry * eps1)[:, None],
        arena.origin)
    # BOUNDARY + miss: becomes EXTERNAL_BOUNDARY
    external = boundary & ~found
    depth = torch.where(boundary, depth & ~RAY_BOUNDARY, depth)
    depth = torch.where(external, depth | RAY_EXTERNAL_BOUNDARY, depth)

    inst = torch.where(requeue, nxt, arena.inst)

    # PRIMARY with OPAQUE or EXTERNAL: deposit color*w, retire
    is_primary = arena.type == int(VolumeRayType.PRIMARY)
    done = pending & is_primary & (
        (depth & (RAY_OPAQUE | RAY_EXTERNAL_BOUNDARY)) > 0)
    fb = image_lib.local_add(fb, arena.id, arena.color * arena.w[:, None],
                             torch.ones_like(arena.w), done)
    retire = done | (pending & ~requeue & ~done)

    return arena.replace(origin=origin, inst=inst, depth=depth,
                         active=arena.active & ~retire), fb


def _as_f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def _gate_stats(minv_list, directions) -> np.ndarray:
    """Per instance of minv_list, the reductions _slice_gate decides on,
    over the normalized OBJECT-space directions: rows (mean, min |d|, max,
    min), one column per object axis; (instances, 4, 3) float64. The
    float64 reductions run where `directions` lives, and their results come
    to the host in one read."""
    d = _as_f64(directions)
    stats = []
    for minv in minv_list:
        m3 = _as_f64(minv, d.device)[:3, :3]
        d_obj = dot3(m3[None], d[:, None, :])
        dn = d_obj / torch.clamp(
            torch.linalg.norm(d_obj, dim=-1, keepdim=True), min=1e-30)
        stats.append(torch.stack([dn.mean(dim=0), dn.abs().amin(dim=0),
                                  dn.amax(dim=0), dn.amin(dim=0)]))
    if not stats:
        return np.zeros((0, 4, 3))
    return _host(torch.stack(stats))


def _gate_verdict(stats) -> tuple:
    """(ok, axis, flip) of _slice_gate from its instances' _gate_stats."""
    axis, flip = 0, False
    for j, (mean, amin, dmax, dmin) in enumerate(stats):
        a, f = sm.choose_slice_axis(mean)
        if j == 0:
            axis, flip = a, f
        elif (a, f) != (axis, flip):
            return False, axis, flip
        if amin[axis] < sm.MIN_AXIS_COMPONENT:
            return False, axis, flip
        if (dmax[axis] > 0.0) if flip else (dmin[axis] < 0.0):
            return False, axis, flip
    return True, axis, flip


def _slice_gate(minv_list, directions) -> tuple:
    """Object-space slice-path gate shared by can_slice_march /
    slice_axes_for. slice_march marches OBJECT-space rays
    (d_obj = inst_minv @ d), so the dominant-axis / conditioning checks
    must run on d_obj: a rotated instance transform can drive the
    object-space |d_axis| to ~0 while the world-space check passes, making
    safe_inv blow up and the brick render empty. Requires, for EVERY
    instance in minv_list:
      - one common (axis, flip) chosen from the object-space mean,
      - |d_obj_axis| >= MIN_AXIS_COMPONENT on the normalized direction
        (plane parametrization well-conditioned),
      - all d_obj[:, axis] sharing one sign consistent with the flip:
        a ray opposing the flip would march the fixed ascending plane
        ladder back-to-front and composite in the wrong order.
    `directions` is an (N, 3) array or tensor of world directions (see
    _gate_stats). Returns (ok, axis, flip)."""
    return _gate_verdict(_gate_stats(minv_list, directions))


def _has_features(scene: VolumeSceneData, v: int) -> bool:
    return bool(_per_volume(scene.vol_subgrids, v)
                or _per_volume(scene.vol_isovalues, v)
                or _per_volume(scene.vol_slices, v))


def can_slice_march(scene: VolumeSceneData, directions) -> tuple:
    """(ok, axis, flip): whether the slice-march fast path applies.

    Requires one volume in one instance, any AMR/iso/slice feature only on
    a brick within SLAB_BYTES (_features_on_slice_ok; larger featured
    bricks keep the gather march), and every OBJECT-space ray within the
    dominant-axis cone with one consistent sign (see _slice_gate).
    """
    if scene.num_volumes != 1 or scene.num_instances != 1:
        return False, 0, False
    if _has_features(scene, 0) and not _features_on_slice_ok(scene, 0):
        return False, 0, False
    if not scene.vol_meta:
        return False, 0, False
    return _slice_gate([scene.inst_minv[0]], directions)


def _features_on_slice_ok(scene: VolumeSceneData, v: int) -> bool:
    """Isosurfaces, AMR subgrids and slice planes run on the slice engine
    only where the main brick PLUS any subgrids fit SLAB_BYTES, the size up
    to which the engine marches a brick whole; bigger bricks keep the
    gather march. The threshold decides which engine renders a featured
    brick, and so the image, exactly as in the reference."""
    nz, ny, nx = scene.vol_samples[v].shape[-3:]
    total = nz * ny * nx * 4
    for sub in _per_volume(scene.vol_subgrids, v):
        sz, sy, sx = sub[0].shape[-3:]
        total += sz * sy * sx * 4
    return total <= sm.SLAB_BYTES


@spanned("volume.frame")
def trace_volume_fast(scene: VolumeSceneData, rays: RayArena, width: int,
                      height: int, axis: int | None = None,
                      flip: bool | None = None, impl=None) -> torch.Tensor:
    """Single-brick volume megapass: the whole frame in ONE slice-march
    launch (ops/slice_march.py), the role ospTraceRays/GregSpray plays for
    the reference (OSPRayAdapter.cpp:301).

    Exactly the single-volume single-instance whole-film case: every camera
    ray marches one brick and retires, so the wavefront loop is statically
    known to run filter -> march -> deposit, and the round machinery
    (arena, shuffle, flag protocol) drops out. Callers gate with
    can_slice_march and fall back to trace_volume.

    `rays` is the raw camera wavefront (make_arena not needed). axis/flip
    override the dominant-axis choice (computed from the mean object-space
    ray direction otherwise; pass them explicitly in frame loops).
    impl="plain" runs the plain version (differentiable).
    """
    if scene.num_volumes != 1 or scene.num_instances != 1:
        raise ValueError("trace_volume_fast takes one volume in one instance")
    if _has_features(scene, 0) and not _features_on_slice_ok(scene, 0):
        raise ValueError("a featured brick over SLAB_BYTES takes the gather "
                         "march (trace_volume)")
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")

    if axis is None or flip is None:
        # axis/flip come from the OBJECT-space mean (the frame slice_march
        # actually marches in): see _slice_gate
        d = _as_f64(rays.direction)
        m3 = _as_f64(scene.inst_minv[0], d.device)[:3, :3]
        axis, flip = sm.choose_slice_axis(
            _host(dot3(m3[None], d[:, None, :]).mean(dim=0)))

    origin, spacing, (low, high) = scene.vol_meta[0]
    # object-space transform: broadcast-multiply + small-axis sums, NOT a
    # matmul
    minv = scene.inst_minv[0]
    m3 = minv[:3, :3]
    o_obj = dot3(m3[None, :, :], rays.origin[:, None, :]) + minv[:3, 3]
    d_obj = dot3(m3[None, :, :], rays.direction[:, None, :])

    n = rays.capacity
    active = rays.active if rays.active.dtype == torch.bool \
        else rays.active > 0
    with span("volume.march_slice"):
        color, w, _flags = sm.slice_march(
            o_obj, d_obj, active, rays.color, rays.w,
            scene.vol_samples[0], scene.vol_color_lut[0],
            scene.vol_opacity_lut[0],
            axis=int(axis), flip=bool(flip), step=float(scene.vol_step[0]),
            base_step=float(min(spacing)), low=low, high=high,
            origin=tuple(origin), spacing=tuple(spacing),
            isovalues=tuple(float(x) for x in _per_volume(scene.vol_isovalues,
                                                          0)),
            slices=tuple(tuple(float(x) for x in pl)
                         for pl in _per_volume(scene.vol_slices, 0)),
            subgrids=_per_volume(scene.vol_subgrids, 0),
            impl=impl,
            film_width=width if n == width * height else None)

    # single brick: BOUNDARY rays have nowhere to requeue -> EXTERNAL ->
    # every primary deposits color*w (shuffle_volume's retirement rule)
    fb = image_lib.new_framebuffer(width, height, o_obj.device)
    contrib = color * w[:, None]
    if n == width * height:
        # dense whole-film deposit: lane i == pixel i (camera lane order)
        fb = fb + torch.cat([contrib, torch.ones_like(w)[:, None]], dim=1)
    else:
        fb = image_lib.local_add(fb, rays.id, contrib, torch.ones_like(w),
                                 active)
    return image_lib.clamp_rgb(fb)


def slice_axes_for(scene: VolumeSceneData, directions) -> tuple:
    """Per-volume (axis, flip) | None tuple for march_round's slice_axes: a
    volume qualifies when its AMR/iso/slice features (if any) fit the slice
    engine and every OBJECT-space ray, for EVERY instance referencing it,
    passes the dominant-axis gate (_slice_gate). Computed once per camera.
    Accepts both a flat scene and the stacked per-device scene of
    schedule/volume_domain.py::partition_volume_scene (a leading device axis
    on the tensors; the transforms are equal across devices and inst_vol
    marks foreign instances -1, so a slot is used by an instance where ANY
    device uses it)."""
    if not scene.vol_meta:
        return ()
    iv = _host(scene.inst_vol)
    minv = scene.inst_minv
    if minv.dim() == 4:                    # stacked: (n_dev, I, 4, 4)
        minv = minv[0]
        uses = [(iv == v).any(axis=0) for v in range(scene.num_volumes)]
    else:
        uses = [iv == v for v in range(scene.num_volumes)]
    gated = [v for v in range(scene.num_volumes)
             if not _has_features(scene, v) or _features_on_slice_ok(scene, v)]
    used = sorted({int(i) for v in gated for i in np.nonzero(uses[v])[0]})
    # every instance's reductions in one read; each volume's verdict from
    # the rows of its instances
    stats = dict(zip(used, _gate_stats([minv[i] for i in used], directions)))
    out = []
    for v in range(scene.num_volumes):
        rows = [stats[int(i)] for i in np.nonzero(uses[v])[0]] \
            if v in gated else []
        ok, axis, flip = _gate_verdict(rows) if rows else (False, 0, False)
        out.append((axis, flip) if ok else None)
    return tuple(out)


@spanned("volume.frame")
def trace_volume(scene: VolumeSceneData, arena: RayArena, width: int,
                 height: int, max_rounds: int = 64,
                 unroll: bool = False, slice_axes: tuple = (),
                 impl=None) -> torch.Tensor:
    """The wavefront volume tracer: filter, then rounds of march_round and
    shuffle_volume until no ray is queued (one host read per round asks,
    and names the bricks that hold a queued ray: only they are marched).
    unroll=True is the gradient path: exactly max_rounds rounds, the gather
    march without early exit, no data-dependent control flow."""
    fb = image_lib.new_framebuffer(width, height, arena.origin.device)
    arena = filter_initial(scene, arena, impl=impl)
    for _ in range(max_rounds):
        volumes = range(scene.num_volumes)
        if not unroll:
            held = held_volumes(scene, arena)
            go, (volumes,) = read_round(held.any(), [held])
            if not go:
                break
        with span("volume.round"):
            # the arena's lanes are the camera's, in lane order (make_arena)
            arena = march_round(scene, arena, differentiable=unroll,
                                slice_axes=slice_axes, impl=impl,
                                film_width=width, volumes=volumes)
            arena, fb = shuffle_volume(scene, arena, fb, impl=impl)
    return fb
