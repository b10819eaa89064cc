"""Image scheduler: rays sharded over a group, scene replicated;
counterpart of gravit_tpu/schedule/image_sched.py.

The analog of Tracer<ImageScheduler> (algorithm/ImageTracer.h:111-269):
GraviT slices the camera rays size/world_size per MPI rank, each rank
renders its slice with all needed domains resident, then the framebuffers
are reduced. Here the RayArena is split over a group's members
(parallel/), every member traces its slice with no communication in the
loop, and the framebuffers are all-reduced and clamped (the image reduce
of TracerBase.h:418 / the IceT gather).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render import tracer as tracer_lib
from gravit_tpu_torch.render.scene_build import (Instance, SceneData,
                                                 build_scene)
from gravit_tpu_torch.render.tracer import make_arena, trace_image
from gravit_tpu_torch.scene import image as image_lib
from gravit_tpu_torch.schedule.domain_sched import (partition_accel, shard,
                                                    tree_map)


def trace_image_sharded(scene: SceneData, arena: RayArena, width: int,
                        height: int, mesh, axis: str = "rays",
                        max_rounds: int = 64, accel=None) -> torch.Tensor:
    """Trace with the arena split into contiguous slices over the members
    of `mesh`'s `axis` group; each member runs the looped trace_image on
    its slice, then the framebuffers are all-reduced and clamped.

    Requires arena.capacity divisible by the group's size (and each slice
    divisible by the traversal's PACKET when accel is given)."""
    group = mesh.groups[axis]
    if arena.capacity % group.size:
        raise ValueError(f"arena capacity {arena.capacity} is not a "
                         f"multiple of the group's {group.size} members")
    per = arena.capacity // group.size
    fbs = [trace_image(scene, arena.map(lambda a: a[k * per:(k + 1) * per]),
                       width, height, max_rounds=max_rounds, accel=accel)
           for k in group.local]
    return image_lib.composite(fbs, group)[0]


def _nbytes(tree) -> int:
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), tree)
    return sum(total)


class StreamedImageRenderer:
    """Out-of-core image scheduling: domains streamed on demand.

    The reference image scheduler loads domains lazily with an adapter
    cache so a replicate-on-demand scene can exceed one rank's memory
    (ImageTracer.h:184-233: pick the fullest queue -> cache-lookup/build
    the adapter -> trace -> shuffle). Here meshes are bin-packed first-fit
    into GROUPS whose triangle totals fit `budget_tris`; group scenes stay
    in host memory (pinned when the device is a card); each round copies
    the chosen group to the device and runs one bounded trace round. The
    next-best group is prefetched while the current one traces: on the
    card a non_blocking copy on a side CUDA stream, with an event the
    tracing stream waits on before it uses the group (a 2-slot device
    cache). Rays whose instance is not in the resident group park
    (inst_mesh == -1) until their group is scheduled. All groups pad to
    one triangle count.

    Depth-1 point-light frames are bit-identical to the all-resident
    tracer (per-ray work is round-invariant); configurations that draw
    random numbers (area lights, bounces) differ, because the hashes mix in
    the round index.

    `stats` holds the last render's rounds, group copies (`fetches`) and
    bytes copied from host to device.
    """

    # device bytes per triangle of a built SceneData, and of the BVH accel
    # when used (gravit_tpu/schedule/image_sched.py's accounting)
    BYTES_PER_TRI = 228
    BYTES_PER_TRI_ACCEL = 144

    def __init__(self, meshes, instances, lights,
                 budget_tris: int | None = None,
                 budget_bytes: int | None = None,
                 use_accel: bool = False, device=None):
        self.device = resolve_device(device)
        if budget_bytes is not None:
            per_tri = self.BYTES_PER_TRI + (
                self.BYTES_PER_TRI_ACCEL if use_accel else 0)
            budget_tris = max(1, int(budget_bytes) // per_tri)
        if budget_tris is None:
            raise ValueError("pass budget_tris or budget_bytes")
        biggest = max(m.num_triangles for m in meshes)
        if budget_tris < biggest:
            raise ValueError(
                f"budget_tris={budget_tris} below largest mesh ({biggest})")
        # greedy first-fit pack of mesh ids into groups under the budget
        groups: list[list[int]] = []
        fill: list[int] = []
        mesh2group = {}
        for mi in sorted(range(len(meshes)),
                         key=lambda i: -meshes[i].num_triangles):
            t = meshes[mi].num_triangles
            for g, f in enumerate(fill):
                if f + t <= budget_tris:
                    groups[g].append(mi)
                    fill[g] += t
                    mesh2group[mi] = g
                    break
            else:
                mesh2group[mi] = len(groups)
                groups.append([mi])
                fill.append(t)
        self.num_groups = len(groups)
        self.inst_group = np.array(
            [mesh2group[i.mesh_id] for i in instances], np.int32)
        self._inst_group = torch.as_tensor(self.inst_group.astype(np.int64),
                                           device=self.device)
        pin = self.device.type == "cuda"

        def host(tree):
            return tree_map(lambda t: t.pin_memory() if pin else t, tree)

        # per-group scenes: local meshes only, foreign inst_mesh = -1, the
        # global instance tables (domain_sched.partition_scene's
        # construction, groups over time instead of over devices)
        ref = build_scene(meshes, instances, lights, device="cpu")
        pad_to = max(fill)
        self.host_scenes = []
        for mids in groups:
            gl2loc = {mi: loc for loc, mi in enumerate(mids)}
            inst = [Instance(mesh_id=gl2loc.get(i.mesh_id, 0), m=i.m)
                    for i in instances]
            sd = build_scene([meshes[mi] for mi in mids], inst, lights,
                             pad_tris_to=pad_to, device="cpu",
                             instance_bvh=False)
            resident = torch.tensor([i.mesh_id in gl2loc for i in instances])
            sd = dataclasses.replace(
                sd, inst_mesh=torch.where(resident, sd.inst_mesh, -1),
                inst_lo=ref.inst_lo, inst_hi=ref.inst_hi,
                inst_bvh=ref.inst_bvh,
                num_meshes=max(len(m) for m in groups),
                mesh_tri_offset=(), mesh_tri_count=(),
                has_embree_materials=ref.has_embree_materials)
            self.host_scenes.append(host(sd))
        self.lights_count = int(ref.num_lights)

        # per-group BVH accel, padded to common shapes (partition_accel's
        # device padding, repurposed groups-over-time)
        self.host_accels = None
        if use_accel:
            res = np.zeros((len(instances), self.num_groups), bool)
            for i, inst_i in enumerate(instances):
                res[i, mesh2group[inst_i.mesh_id]] = True
            stacked = partition_accel(meshes, instances, self.num_groups,
                                      res, device="cpu")
            self.host_accels = [host(shard(stacked, g))
                                for g in range(self.num_groups)]
        self._side = (torch.cuda.Stream(self.device) if pin else None)
        self._dev_cache: dict = {}
        self.stats = dict(rounds=0, fetches=0, bytes_h2d=0)

    def _fetch(self, g: int):
        """Start group g's copy to the device unless it is cached: on the
        card on the side stream (after the tracing stream's work so far, so
        the new buffers are free), with an event marking its end."""
        if g in self._dev_cache:
            return
        trees = (self.host_scenes[g],
                 self.host_accels[g] if self.host_accels else None)
        self.stats["fetches"] += 1
        self.stats["bytes_h2d"] += sum(_nbytes(t) for t in trees
                                       if t is not None)
        if self._side is None:
            self._dev_cache[g] = (trees, None)
            return
        # allocate on the tracing stream, copy on the side stream
        dev = tuple(tree_map(lambda t: torch.empty_like(t, device=self.device),
                             t) for t in trees)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            for src, dst in zip(trees, dev):
                tree_map(lambda d, s: d.copy_(s, non_blocking=True), dst, src)
        done = torch.cuda.Event()
        done.record(self._side)
        self._dev_cache[g] = (dev, done)

    def _use(self, g: int):
        """Group g on the device, ready for the tracing stream."""
        self._fetch(g)
        trees, done = self._dev_cache[g]
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return trees

    def _evict_except(self, keep: set):
        for k in list(self._dev_cache):
            if k not in keep:
                _, done = self._dev_cache.pop(k)
                # a copy in flight must end before its buffers are reused
                if done is not None:
                    torch.cuda.current_stream(self.device).wait_event(done)

    def render(self, camera, max_rounds: int = 64) -> torch.Tensor:
        """One frame: each round traces the group most rays wait for and
        prefetches the runner-up. Returns the (W*H, 4) framebuffer."""
        self.stats = dict(rounds=0, fetches=0, bytes_h2d=0)
        arena = make_arena(camera.generate_rays(self.device),
                           self.lights_count)
        w, h = camera.film_width, camera.film_height
        scene0, _ = self._use(0)
        arena, fb = tracer_lib.shuffle(
            scene0, arena, image_lib.new_framebuffer(w, h, self.device))
        for r in range(max_rounds):
            live = arena.active & (arena.inst >= 0)
            counts = torch.zeros((self.num_groups,), dtype=torch.int64,
                                 device=self.device).index_add_(
                0, self._inst_group[arena.inst.clamp(min=0).long()],
                live.long()).cpu().numpy()
            if not counts.any():
                break
            ranked = np.argsort(-counts)
            g = int(ranked[0])
            scene_g, accel_g = self._use(g)
            # prefetch the runner-up while g traces
            nxt = int(ranked[1]) if (self.num_groups > 1
                                     and counts[ranked[1]] > 0) else g
            self._evict_except({g, nxt})
            self._fetch(nxt)
            arena, fb = tracer_lib.trace_round(
                scene_g, arena, fb, r,
                tracer_lib._choose_tile(scene_g.num_triangles), accel=accel_g)
            self.stats["rounds"] += 1
        return fb


def render_image_scheduler(scene: SceneData, camera, mesh=None,
                           axis: str = "rays",
                           max_rounds: int = 64) -> torch.Tensor:
    """Convenience: camera -> arena -> (sharded) trace -> framebuffer. An
    arena the group's size does not divide is padded with zero lanes."""
    dev = scene.tri_v0.device
    arena = make_arena(camera.generate_rays(dev), scene.num_lights)
    w, h = camera.film_width, camera.film_height
    if mesh is None or mesh.shape[axis] == 1:
        return trace_image(scene, arena, w, h, max_rounds=max_rounds)
    n = mesh.shape[axis]
    if arena.capacity % n:
        pad = n - arena.capacity % n
        arena = arena.map(lambda a: torch.cat(
            [a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=a.device)]))
    return trace_image_sharded(scene, arena, w, h, mesh, axis, max_rounds)
