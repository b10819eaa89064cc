"""Domain-scheduled VOLUME rendering: bricks sharded over a group, rays
migrate with their accumulated color and opacity; counterpart of
gravit_tpu/schedule/volume_domain.py.

The gvtVol_parallel.py configuration: volume bricks distribute over ranks,
rays march front to back through whichever brick they are in and carry
(rgb, opacity) across the wire, so depth order is automatic; the reference
needs IceT BLEND only to merge FINISHED pixels, which here is the final
all-reduce (a ray retires on exactly one member). Brick-to-member placement
is round-robin (reference Locations semantics); migration reuses the
surface domain scheduler's packed all_to_all (domain_sched.py).

Differences from the JAX package, by design:
  * Written once against the group (parallel/), as domain_sched.py: the
    compiled while_loop is a host loop over rounds that reads two
    all-reduced counts a round (the live rays before it, the rays to send
    after it), and skips the exchange when no member sends.
  * `slice_interpret` (the JAX Pallas interpret switch) has no
    counterpart: on the card the slice engine launches its kernels (K4, or
    K5 for a brick over SLAB_BYTES), on the CPU it runs their plain
    version. `impl="plain"` forces the plain version on the card
    (comparisons only).
  * After the owner claim the arena is prefix-compacted, so its lanes are
    no longer the film in camera order: the slice kernels march 1-D tiles
    of consecutive lanes (film_width None).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render import volume_tracer
from gravit_tpu_torch.render.volume_scene import (VolumeSceneData,
                                                  build_volume_scene)
from gravit_tpu_torch.schedule.domain_sched import (_compact_arena,
                                                    _merge_incoming,
                                                    _np, _pack_exchange,
                                                    round_robin_owners,
                                                    shard, tree_map)
from gravit_tpu_torch.scene import image as image_lib
from gravit_tpu_torch.scene.volume import Volume


def partition_volume_scene(volumes: Sequence[Volume],
                           instances: Sequence[Tuple[int, np.ndarray]],
                           n_dev: int, owners: np.ndarray | None = None,
                           device=None):
    """Per-device VolumeSceneData stacked on a leading axis, on `device`.

    Requires all bricks to share one sample-grid shape (the VolApp brick
    reader produces near-uniform bricks; pad upstream otherwise). Each
    device keeps only its local bricks (padded to a common count); foreign
    instances get inst_vol = -1. The instance boxes are the global scene's,
    vol_step / vol_max_steps the global scene's first step and longest
    ladder, and vol_meta a spacing-only tuple per local slot when every
    brick has one spacing (origin and TF range ride in the per-device
    tensors); with spacings that differ it is () and the slice engine is
    off. Returns (stacked scene, owners as an int32 tensor).
    """
    if owners is None:
        owners = round_robin_owners(len(instances), n_dev)
    owners = _np(owners)
    shapes = {tuple(v.samples.shape) for v in volumes}
    if len(shapes) != 1:
        raise ValueError(f"bricks must share a shape, got {shapes}")

    ref = build_volume_scene(volumes, instances, device="cpu")
    per_dev = [sorted({instances[i][0] for i in range(len(instances))
                       if owners[i] == d}) for d in range(n_dev)]
    max_local = max([1] + [len(v) for v in per_dev])
    spacings = {tuple(float(x) for x in v.spacing) for v in volumes}
    common = ((((0.0, 0.0, 0.0), next(iter(spacings)), (0.0, 0.0)),)
              * max_local if len(spacings) == 1 else ())

    scenes = []
    for d, vids in enumerate(per_dev):
        use = vids + [0] * (max_local - len(vids)) if vids \
            else [0] * max_local
        g2l = {g: loc for loc, g in enumerate(vids)}
        inst_local = [(g2l.get(vid, 0), m) for vid, m in instances]
        sd = build_volume_scene([volumes[g] for g in use], inst_local,
                                device="cpu")
        inst_vol = np.array(
            [g2l.get(instances[i][0], -1) if owners[i] == d else -1
             for i in range(len(instances))], np.int32)
        scenes.append(sd.replace(
            inst_vol=torch.as_tensor(inst_vol),
            inst_lo=ref.inst_lo, inst_hi=ref.inst_hi,
            vol_step=tuple(ref.vol_step[0] for _ in range(max_local)),
            vol_max_steps=tuple(max(ref.vol_max_steps)
                                for _ in range(max_local)),
            vol_meta=common))
    device = resolve_device(device)
    stacked = tree_map(lambda *xs: torch.stack(xs).to(device), *scenes)
    return stacked, torch.as_tensor(owners, device=device)


def trace_volume_domain(scene_stacked: VolumeSceneData, owners,
                        arena: RayArena, width: int, height: int, mesh,
                        axis: str = "domains", max_rounds: int = 32,
                        exchange_cap: int | None = None,
                        return_stats: bool = False, slice_axes: tuple = (),
                        local_slack: float = 2.0, impl=None):
    """Run the volume domain schedule over the mesh's `axis` group;
    returns the clamped frame, and with return_stats (frame, drops): the
    summed count of rays lost to exchange or compaction overflow.

    arena: the FULL camera wavefront (every member filters it, claims the
    rays whose first brick it owns and compacts them to ~(C / n_dev) *
    local_slack lanes, so per-round work scales as C / n).

    slice_axes (per local-volume slot): marches qualifying bricks through
    the slice engine INSIDE the domain program; every member's brick
    origins and TF ranges are its own tensors. Compute it with
    volume_tracer.slice_axes_for(scene_stacked, directions).
    """
    dom = mesh.groups[axis]
    dev = dom.device
    n_dev = dom.size
    cap = exchange_cap or max(1024, arena.capacity // n_dev)
    want = -(-int(arena.capacity * local_slack) // n_dev)
    c_local = min(arena.capacity, max(1024, -(-want // 1024) * 1024))
    owners = torch.as_tensor(owners, device=dev).long()
    n_inst = owners.shape[0]

    def owner_of(inst):
        return owners[inst.clamp(0, n_inst - 1).long()]

    def queued(a):
        return a.active & (a.inst >= 0)

    scene, state = {}, {}
    for d in dom.local:
        scene[d] = shard(scene_stacked, d, dev)
        # the generic first queueing, keep the rays whose first brick this
        # member owns, then compact to the local working width
        a = volume_tracer.filter_initial(scene[d], arena)
        a = a.replace(active=a.active & ((a.inst < 0) | (owner_of(a.inst)
                                                           == d)))
        a, d_claim = _compact_arena(a, c_local)
        state[d] = [a, image_lib.new_framebuffer(width, height, dev),
                    d_claim]

    for _ in range(max_rounds):
        live = dom.all_reduce([queued(state[d][0]).sum()
                               for d in dom.local])[0]
        if int(live) == 0:
            break
        sends = {}
        for d in dom.local:
            a, fb, _ = state[d]
            a = volume_tracer.march_round(scene[d], a, slice_axes=slice_axes,
                                          impl=impl)
            a, fb = volume_tracer.shuffle_volume(scene[d], a, fb)
            state[d][:2] = a, fb
            sends[d] = queued(a) & (owner_of(a.inst) != d)
        n_send = dom.all_reduce([sends[d].sum() for d in dom.local])[0]
        if int(n_send) == 0:
            continue            # no member has a migrant: skip the exchange
        packs = []
        for d in dom.local:
            a = state[d][0]
            dest = torch.where(sends[d], owner_of(a.inst), -1)
            a, packed, d_pack, _ = _pack_exchange(a, dest, n_dev, cap)
            state[d][0] = a
            state[d][2] = state[d][2] + d_pack
            packs.append(packed)
        fields = {name: dom.all_to_all([getattr(p, name) for p in packs])
                  for name in RayArena.__dataclass_fields__}
        for k, d in enumerate(dom.local):
            incoming = RayArena(**{n: v[k] for n, v in fields.items()})
            state[d][0], d_merge = _merge_incoming(state[d][0], incoming)
            state[d][2] = state[d][2] + d_merge

    fb = dom.all_reduce([state[d][1] for d in dom.local])[0]
    drops = dom.all_reduce([state[d][2] for d in dom.local])[0]
    fb = image_lib.clamp_rgb(fb)
    return (fb, drops) if return_stats else fb
