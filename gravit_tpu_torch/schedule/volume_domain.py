"""Domain-scheduled VOLUME rendering: bricks sharded over a group, rays
migrate with their accumulated color and opacity; counterpart of
gravit_tpu/schedule/volume_domain.py.

The gvtVol_parallel.py configuration: volume bricks distribute over ranks,
rays march front to back through whichever brick they are in and carry
(rgb, opacity) across the wire, so depth order is automatic; the reference
needs IceT BLEND only to merge FINISHED pixels, which here is the final
all-reduce (a ray retires on exactly one member). Brick-to-member placement
is round-robin (reference Locations semantics). The claim, the exchange
and the regrow rule are the surface domain scheduler's (domain_sched.py:
claim, exchange, Regrow); this module keeps the volume's own steps: the
first queueing, the owner rule, a member's round and the composite.

Differences from the JAX package, by design:
  * Written once against the group (parallel/), as domain_sched.py: the
    compiled while_loop is a host loop over rounds with two host reads a
    round: before it, the all-reduced count of live rays together with
    each local member's bricks that hold a queued ray (only they are
    marched: a pass whose mask is empty changes no lane); after it, the
    rays to send. The exchange is skipped when no member sends.
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
from gravit_tpu_torch.schedule.domain_sched import (claim, exchange,
                                                    first_cap, local_width,
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
    owners = torch.as_tensor(owners).cpu().numpy()
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
                        return_stats=False, slice_axes: tuple = (),
                        local_slack: float = 2.0, impl=None):
    """Run the volume domain schedule over the mesh's `axis` group;
    returns the clamped frame. return_stats: also the summed count of rays
    lost to exchange or compaction overflow; "peak" gives instead the tuple
    (drops, the largest per-destination demand of any round), as
    trace_domain's, for Regrow.

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
    cap = exchange_cap or first_cap(arena.capacity, n_dev)
    c_local = local_width(arena.capacity, n_dev, local_slack)
    owners = torch.as_tensor(owners, device=dev).long()
    n_inst = owners.shape[0]

    def owner_of(inst):
        return owners[inst.clamp(0, n_inst - 1).long()]

    def queued(a):
        return a.active & (a.inst >= 0)

    scenes, arenas, fbs, drops = [], [], [], []
    for d in dom.local:
        scenes.append(shard(scene_stacked, d, dev))
        # the generic first queueing, then the rays whose first brick this
        # member owns
        a = volume_tracer.filter_initial(scenes[-1], arena, impl=impl)
        a, d_claim = claim(a, owner_of(a.inst) == d, c_local)
        arenas.append(a)
        fbs.append(image_lib.new_framebuffer(width, height, dev))
        drops.append(d_claim)
    peaks = [torch.zeros((), dtype=torch.int64, device=dev)] * len(arenas)

    for _ in range(max_rounds):
        live = dom.all_reduce([queued(a).sum() for a in arenas])[0]
        go, bricks = volume_tracer.read_round(live > 0, [
            volume_tracer.held_volumes(sc, a)
            for sc, a in zip(scenes, arenas)])
        if not go:
            break
        sends = []
        for k, d in enumerate(dom.local):
            a = volume_tracer.march_round(scenes[k], arenas[k],
                                          slice_axes=slice_axes, impl=impl,
                                          volumes=bricks[k])
            arenas[k], fbs[k] = volume_tracer.shuffle_volume(
                scenes[k], a, fbs[k], impl=impl)
            sends.append(queued(arenas[k]) & (owner_of(arenas[k].inst) != d))
        n_send = dom.all_reduce([s.sum() for s in sends])[0]
        if int(n_send) == 0:
            continue            # no member has a migrant: skip the exchange
        arenas, dropped, demand = exchange(
            dom, arenas, [torch.where(s, owner_of(a.inst), -1)
                          for s, a in zip(sends, arenas)], cap)
        drops = [x + y for x, y in zip(drops, dropped)]
        peaks = [torch.maximum(x, y) for x, y in zip(peaks, demand)]

    fb = image_lib.clamp_rgb(dom.all_reduce(fbs)[0])
    if not return_stats:
        return fb
    stats = dom.all_reduce(drops)[0]
    if return_stats == "peak":
        stats = (stats, dom.all_reduce(peaks, "max")[0])
    return fb, stats
