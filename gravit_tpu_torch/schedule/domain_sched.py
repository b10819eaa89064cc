"""Domain scheduler: scene domains sharded over a group, rays migrate;
counterpart of gravit_tpu/schedule/domain_sched.py.

The re-design of Tracer<DomainScheduler> (algorithm/DomainTracer.h):
instances map to devices round-robin (DomainTracer.h:115-144); each round
a member traces only rays whose target instance it holds, the shuffle
assigns next instances, and rays bound for other members are packed into
fixed-capacity per-destination buffers and exchanged with ONE all_to_all
over the group, in place of the reference's per-rank count handshake and
Isend/Irecv exchange (DomainTracer.h:370-496). Termination is an
all-reduced count of queued rays (in place of the MPI_Gather/Scatter check
at :337-352 and the async two-phase vote, vote.cpp:47-152).

Memory model: every member holds ONLY the triangle/BVH data of its own
domains (padded to a common size), the point of domain scheduling.

Differences from the JAX package, by design:
  * The group (parallel/): a LocalGroup runs its members one after
    another in this process, a DistGroup is one member per process. The
    code below is written once over the members this process holds.
  * The compiled while_loop is a host loop over rounds. Each round reads
    two all-reduced counts on the host, and nothing more: the queued rays
    over both axes (the loop condition, before the round) and the rays to
    send over the domain axis (after it). The exchange is skipped when no
    member has a migrant, as under the JAX lax.cond.
  * The exclusive rank of a lane within its destination is the JAX
    package's one-hot cumsum over a (C, n_dev) int32 table, so every
    lane's slot is equal to JAX's, bit for bit.
  * Every "drop" scatter goes through render/tracer.py::_scatter_drop.
  * render_hybrid's frame is the static render's: its chunks continue
    the frame's round count (the per-ray hashes' counter), and a resumed
    chunk exchanges the rays a remap moved before its first round. The
    JAX package restarts the count at 0 in every chunk and parks moved
    rays for a round, so its hybrid image differs wherever a later round
    samples an area light or rolls Russian roulette: a fault of the
    reference, not copied.
  * tree_map recurses into tuples that hold tensors (the volume scene's
    per-brick tuples), where jax.tree.map recurses into every tuple;
    tuples of Python numbers stay the first tree's static metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gravit_tpu_torch.accel.scene_accel import SceneBVH, build_scene_bvh
from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.parallel.distributed import LocalGroup
from gravit_tpu_torch.render import tracer as tracer_lib
from gravit_tpu_torch.render.scene_build import (Instance, SceneData,
                                                 build_scene)
from gravit_tpu_torch.render.tracer import _scatter_drop
from gravit_tpu_torch.scene import image as image_lib
from gravit_tpu_torch.schedule.policies import POLICIES


def _holds_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    return isinstance(x, tuple) and any(_holds_tensor(v) for v in x)


def tree_map(fn, *trees):
    """fn over the tensor fields of dataclasses of one type (nested
    dataclasses included, None left alone), and over the tensors of tuples
    that hold any (the volume scene's per-brick tuples, its subgrids' nested
    ones); other fields (static metadata, tuples of Python numbers) are the
    first tree's. The jax.tree.map of the reference."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple) and _holds_tensor(first):
        if any(len(t) != len(first) for t in trees):
            raise ValueError("tree_map: tuples of unequal length")
        return tuple(tree_map(fn, *items) for items in zip(*trees))
    return first


def shard(tree, d: int, device=None):
    """Member d's slice of a tree stacked on a leading device axis."""
    return tree_map(lambda t: t[d].to(device or t.device), tree)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def round_robin_owners(num_instances: int, n_dev: int) -> np.ndarray:
    """Instance -> device map; round-robin like the reference's Locations
    distribution (DomainTracer.h:115-144)."""
    return (np.arange(num_instances) % n_dev).astype(np.int32)


def one_hot_residency(owners: np.ndarray, n_dev: int) -> np.ndarray:
    res = np.zeros((owners.shape[0], n_dev), bool)
    res[np.arange(owners.shape[0]), owners] = True
    return res


def build_routes(resident: np.ndarray):
    """Routing tables from a (I, D) residency matrix.

    Returns (route, n_rep): `route[i]` lists domain i's resident devices
    cyclically padded to D entries; a ray with pixel id `p` bound for
    domain i is served by `route[i, p % n_rep[i]]`: static round-robin
    over replicas, so the TVCG'13 replication policies actually SERVE rays
    from a replica (LoadAnotherSchedule.h:49-90).
    """
    I, D = resident.shape
    route = np.zeros((I, D), np.int32)
    n_rep = np.ones((I,), np.int32)
    for i in range(I):
        devs = np.nonzero(resident[i])[0]
        if devs.size == 0:
            devs = np.array([0])
        n_rep[i] = devs.size
        route[i] = np.resize(devs, D)
    return route, n_rep


def primary_owner_np(resident: np.ndarray) -> np.ndarray:
    return np.argmax(resident, axis=1).astype(np.int32)


def _local_mesh_ids(instances, resident, d):
    return sorted({instances[i].mesh_id for i in range(len(instances))
                   if resident[i, d]})


def partition_scene(meshes, instances: Sequence[Instance], lights,
                    n_dev: int, owners: np.ndarray | None = None,
                    resident: np.ndarray | None = None, device=None):
    """Per-device SceneData stacked on a leading device axis, on `device`.

    Device d's triangle soup holds only the meshes its instances need
    (adapter-cache semantics: each rank loads what it owns). Instance
    tables (boxes, transforms, the instance tree) are replicated: every
    device needs them for the shuffle. inst_mesh holds LOCAL mesh ids, -1
    for foreign instances (their rays are never traced locally).

    `resident` ((I, D) bool, multi-hot rows allowed) replicates a domain's
    mesh data onto EVERY device marked resident (the replication policies'
    placement); when omitted it is the one-hot of `owners`. Returns
    (stacked scene, owners as an int32 tensor).
    """
    if resident is None:
        if owners is None:
            owners = round_robin_owners(len(instances), n_dev)
        resident = one_hot_residency(_np(owners), n_dev)
    resident = np.asarray(resident)
    owners = primary_owner_np(resident)
    # world boxes need GLOBAL mesh bounds (a device's local mesh list
    # cannot resolve foreign instances' meshes)
    ref = build_scene(meshes, instances, lights, device="cpu")

    per_dev = []
    for d in range(n_dev):
        local_ids = _local_mesh_ids(instances, resident, d)
        gl2loc = {g: loc for loc, g in enumerate(local_ids)}
        local_meshes = [meshes[g] for g in local_ids]
        inst = [Instance(mesh_id=gl2loc.get(i.mesh_id, 0), m=i.m)
                for i in instances]
        sd = build_scene(local_meshes if local_meshes else [meshes[0]],
                         inst, lights, device="cpu", instance_bvh=False)
        per_dev.append((sd, resident[:, d]))

    t_max = max(sd.num_triangles for sd, _ in per_dev)
    v_max = max(sd.vertices.shape[0] for sd, _ in per_dev)
    padded = []
    for sd, mask in per_dev:
        if sd.num_triangles < t_max:
            sd = _pad_scene_tris(sd, t_max)
        if sd.vertices.shape[0] < v_max:
            sd = dataclasses.replace(sd, vertices=torch.cat([
                sd.vertices, torch.zeros((v_max - sd.vertices.shape[0], 3))]))
        padded.append(dataclasses.replace(
            sd,
            inst_mesh=torch.where(torch.as_tensor(mask), sd.inst_mesh, -1),
            inst_lo=ref.inst_lo, inst_hi=ref.inst_hi, inst_bvh=ref.inst_bvh,
            num_meshes=max(x.num_meshes for x, _ in per_dev),
            mesh_tri_offset=(), mesh_tri_count=(),
            has_embree_materials=any(x.has_embree_materials
                                     for x, _ in per_dev),
            has_specular=any(x.has_specular for x, _ in per_dev)))
    device = resolve_device(device)
    stacked = tree_map(lambda *xs: torch.stack(xs).to(device), *padded)
    return stacked, torch.as_tensor(owners, device=device)


def _pad_scene_tris(sd: SceneData, t_max: int) -> SceneData:
    pad = t_max - sd.num_triangles

    def padz(a, fill=0):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype)])

    return dataclasses.replace(
        sd, tri_v0=padz(sd.tri_v0), tri_e1=padz(sd.tri_e1),
        tri_e2=padz(sd.tri_e2), tri_ng=padz(sd.tri_ng),
        tri_ns=padz(sd.tri_ns), tri_vcol=padz(sd.tri_vcol),
        tri_has_vcol=padz(sd.tri_has_vcol),
        tri_mesh=padz(sd.tri_mesh, -2),
        tri_mat_type=padz(sd.tri_mat_type), tri_kd=padz(sd.tri_kd),
        tri_ks=padz(sd.tri_ks), tri_alpha=padz(sd.tri_alpha),
        tri_eta=padz(sd.tri_eta), tri_k=padz(sd.tri_k),
        tri_rough=padz(sd.tri_rough), tri_hsc=padz(sd.tri_hsc),
        tri_bs=padz(sd.tri_bs), tri_hsf=padz(sd.tri_hsf),
        faces=padz(sd.faces))


def partition_accel(meshes, instances: Sequence[Instance], n_dev: int,
                    resident: np.ndarray, device=None) -> SceneBVH:
    """Per-device BVH accel, padded to common shapes and stacked on a
    leading device axis (the mirror of partition_scene), on `device`.

    The reference runs the SAME fast adapter under every scheduler
    (algorithm/DomainTracer.h:228-326 -> EmbreeMeshAdapter.cpp:625): each
    device owns the flat BVHs of only its local meshes, built by the
    default (native) builder. Padding mesh slots get root -1 (their ray
    blocks are skipped by the kernel)."""
    resident = np.asarray(resident)
    if resident.ndim == 1:  # legacy owners vector
        resident = one_hot_residency(resident, n_dev)
    per_dev = []
    for d in range(n_dev):
        ids = _local_mesh_ids(instances, resident, d)
        local = [meshes[g] for g in ids] if ids else [meshes[0]]
        per_dev.append(build_scene_bvh(local, device="cpu"))

    nn = max(a.bounds.shape[0] for a in per_dev)
    tp = max(a.tri.shape[0] for a in per_dev)
    m_max = max(a.num_meshes for a in per_dev)

    def pad(arr, rows, fill=0):
        return torch.cat([arr, torch.full((rows - arr.shape[0],)
                                          + tuple(arr.shape[1:]), fill,
                                          dtype=arr.dtype)])

    padded = [SceneBVH(bounds=pad(a.bounds, nn), meta=pad(a.meta, nn),
                       tri=pad(a.tri, tp), leaf2global=pad(a.leaf2global, tp),
                       mesh_root=pad(a.mesh_root, m_max, -1),
                       num_meshes=m_max) for a in per_dev]
    device = resolve_device(device)
    return tree_map(lambda *xs: torch.stack(xs).to(device), *padded)


def _pack_exchange(arena: RayArena, dest: torch.Tensor, n_dev: int,
                   cap: int):
    """Compact rays by destination device into a (n_dev, cap) lane buffer.

    dest: (C,) destination device per lane, -1 = stays local. Overflowing
    rays are DROPPED (counted in the returned scalar); capacity should be
    sized so this never fires. Returns (arena without the sent rays, the
    packed arena, drops, the largest per-destination demand).
    """
    send_mask = dest >= 0
    d_safe = torch.where(send_mask, dest, 0).long()
    # exclusive rank within the destination bucket via a one-hot cumsum
    # over (C, n_dev) int32, as the JAX package ranks (O(C x n_dev))
    onehot = (F.one_hot(d_safe, n_dev).to(torch.int32)
              * send_mask[:, None].to(torch.int32))
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    my_rank = (rank * onehot).sum(dim=1)
    # per-destination demand this round (for predictive capacity sizing)
    dest_demand = (rank[-1] + onehot[-1]).max()
    slot = torch.where(send_mask & (my_rank < cap), d_safe * cap + my_rank,
                       n_dev * cap)
    dropped = (send_mask & (my_rank >= cap)).sum()

    def pack(field):
        return _scatter_drop(n_dev * cap, 0, slot, field).reshape(
            (n_dev, cap) + tuple(field.shape[1:]))

    packed = arena.map(pack)
    # a packed lane is valid iff some ray landed there
    valid = _scatter_drop(n_dev * cap, False, slot, arena.active & send_mask)
    packed = packed.replace(active=valid.reshape(n_dev, cap))
    # sent rays leave the local arena
    arena = arena.replace(active=arena.active & ~send_mask)
    return arena, packed, dropped, dest_demand


def _merge_incoming(arena: RayArena, incoming: RayArena):
    """Scatter received rays into free local lanes (prefix allocation).

    Returns (arena, dropped): rays that arrive when no free lane exists are
    counted, not silently lost (trace_domain sums the count so callers can
    grow capacity; the reference exchange is lossless by construction,
    DomainTracer.h:370-496)."""
    c = arena.capacity
    dev = arena.active.device
    flat = incoming.map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])))
    # the k-th free lane from the BOTTOM, by a cumsum and one scatter
    inact = ~arena.active
    rank_bot = torch.cumsum(inact.long(), dim=0) - 1
    lane_of_rank = _scatter_drop(c, c, torch.where(inact, rank_bot, c),
                                 torch.arange(c, device=dev))
    n_free = inact.sum()
    rank = torch.cumsum(flat.active.long(), dim=0) - 1
    overflow = flat.active & (rank >= n_free)
    dropped = overflow.sum()
    ok = flat.active & ~overflow
    slot = torch.where(ok, lane_of_rank[rank.clamp(0, c - 1)], c)
    # the inverse map, then a gather per field
    m = slot.shape[0]
    src_row = _scatter_drop(c, m, slot, torch.arange(m, device=dev))
    written = src_row < m
    src_safe = src_row.clamp(0, m - 1)

    def put(dst, src):
        w = written.reshape((c,) + (1,) * (dst.dim() - 1))
        return torch.where(w, src[src_safe], dst)

    return tree_map(put, arena, flat), dropped


def _compact_arena(arena: RayArena, c_local: int):
    """Prefix-compact active lanes into a fresh c_local-lane arena, so each
    member's round works on ~C/n lanes, not C (the JAX package's fix of
    its scaling runs). Overflowing rays are dropped and counted (callers
    regrow local_slack, as for the exchange)."""
    c = arena.capacity
    act = arena.active
    rank = torch.cumsum(act.long(), dim=0) - 1
    overflow = act & (rank >= c_local)
    dropped = overflow.sum()
    slot = torch.where(act & ~overflow, rank, c_local)
    src_row = _scatter_drop(c_local, c, slot,
                            torch.arange(c, device=act.device))
    written = src_row < c
    src_safe = src_row.clamp(0, c - 1)

    def take(field):
        w = written.reshape((c_local,) + (1,) * (field.dim() - 1))
        return torch.where(w, field[src_safe],
                           torch.zeros_like(field[:c_local]))

    return arena.map(take), dropped


def local_width(lanes: int, n_dev: int, slack: float) -> int:
    """A member's working lanes: its share of `lanes` times `slack`, in
    whole 1024-lane packets, at most `lanes`."""
    want = -(-int(lanes * slack) // n_dev)
    return min(lanes, max(1024, -(-want // 1024) * 1024))


def first_cap(lanes: int, n_dev: int) -> int:
    """The exchange capacity a frame starts at."""
    return max(1024, lanes // n_dev)


def claim(arena: RayArena, mine: torch.Tensor, c_local: int):
    """A member's claim (shuffleDropRays, DomainTracer.h:148-183): the
    rays it serves (`mine`) and those queued for no domain, compacted into
    c_local lanes. Returns (arena, the rays that did not fit)."""
    return _compact_arena(
        arena.replace(active=arena.active & ((arena.inst < 0) | mine)),
        c_local)


def exchange(group, arenas: Sequence[RayArena], dests: Sequence,
             cap: int):
    """Send each lane to its destination member of `group` (-1: it
    stays): pack by destination into (size, cap) buffers, one all_to_all
    per RayArena field, merge what arrives into free lanes. arenas, dests:
    the local members', in group.local order. Returns per member (arenas,
    the rays lost to a full buffer or arena, the largest per-destination
    demand)."""
    kept, packs, drops, peaks = [], [], [], []
    for arena, dest in zip(arenas, dests):
        arena, packed, d_pack, demand = _pack_exchange(arena, dest,
                                                       group.size, cap)
        kept.append(arena)
        packs.append(packed)
        drops.append(d_pack)
        peaks.append(demand.long())
    fields = {f.name: group.all_to_all([getattr(p, f.name) for p in packs])
              for f in dataclasses.fields(RayArena)}
    for k, arena in enumerate(kept):
        incoming = RayArena(**{n: v[k] for n, v in fields.items()})
        kept[k], d_merge = _merge_incoming(arena, incoming)
        drops[k] = drops[k] + d_merge
    return kept, drops, peaks


@dataclasses.dataclass
class Regrow:
    """A domain frame's exchange capacity and local slack, and the rule
    that grows them after a try that dropped rays: the capacity to the
    peak per-destination demand (at least double, at most the arena's
    lanes), the slack doubled (at n_dev nothing overflows compaction). A
    try that still drops after max_grows grows raises: the reference's
    exchange is lossless (DomainTracer.h:370-496), so a frame never
    quietly loses rays."""

    n_dev: int
    cap: int
    what: str = "ray exchange"
    max_grows: int = 3
    slack: float = 2.0
    grows: int = 0

    def retry(self, drops, peak, lanes: int) -> bool:
        """Whether the try that returned (drops, peak) must run again, from
        its arena of `lanes` lanes, at the grown capacity and slack."""
        drops = int(drops)
        if drops == 0:
            return False
        if self.grows >= self.max_grows:
            raise RuntimeError(
                f"{self.what} still dropping {drops} rays at "
                f"exchange_cap={self.cap}; increase arena capacity")
        self.grows += 1
        need = -(-max(int(peak), self.cap + 1) // 1024) * 1024
        self.cap = min(max(need, self.cap * 2), lanes)
        self.slack = min(self.slack * 2.0, float(self.n_dev))
        return True


@dataclasses.dataclass
class _Member:
    """One (domain, ray) member's state in trace_domain."""

    d: int
    scene: SceneData
    accel: object
    tile: int
    arena: RayArena
    fb: torch.Tensor
    drops: torch.Tensor
    traced: torch.Tensor
    peak: torch.Tensor
    send: torch.Tensor = None


def _over_both(dom, rays, values: dict, op: str) -> dict:
    """All-reduce {(d, r): tensor} over the domain axis, then the ray
    axis."""
    out = {}
    for r in rays.local:
        keys = [(d, r) for d in dom.local]
        out.update(zip(keys, dom.all_reduce([values[k] for k in keys], op)))
    done = {}
    for d in dom.local:
        keys = [(d, r) for r in rays.local]
        done.update(zip(keys, rays.all_reduce([out[k] for k in keys], op)))
    return done


def _gather_arena(dom, rays, members: dict) -> RayArena:
    """Every member's arena, all-gathered over the domain axis and then
    the ray axis, flattened to lanes: member (d, r) at row r * n_dom + d."""
    def gather(group, arenas):
        fields = {f.name: group.all_gather([getattr(a, f.name)
                                            for a in arenas])
                  for f in dataclasses.fields(RayArena)}
        return [RayArena(**{n: v[k].flatten(0, 1) for n, v in fields.items()})
                for k in range(len(arenas))]

    by_dom = {}
    for r in rays.local:
        keys = [(d, r) for d in dom.local]
        by_dom.update(zip(keys, gather(dom, [members[k].arena
                                             for k in keys])))
    d0 = dom.local[0]
    return gather(rays, [by_dom[(d0, r)] for r in rays.local])[0]


def trace_domain(scene_stacked: SceneData, owners, arena: RayArena,
                 width: int, height: int, mesh, axis: str = "domains",
                 max_rounds: int = 32, exchange_cap: int | None = None,
                 ray_axis: str | None = None, accel: SceneBVH | None = None,
                 return_stats=False, resident: np.ndarray | None = None,
                 return_load: bool = False, initial_shuffle: bool = True,
                 return_arena: bool = False, local_slack: float = 2.0,
                 first_round: int = 0):
    """Run the domain-scheduled trace over the mesh's groups; returns fb.

    arena: the FULL camera wavefront (every member filters it to its own
    domains, as the reference's FilterRaysLocally/shuffleDropRays).

    ray_axis: an optional SECOND axis: the arena is split over it (each
    domain group serves a slice of the rays), composing the Domain and
    Image schedulers on a 2-D layout. Migration all_to_alls stay within
    the domain axis; the framebuffer is summed over both.

    accel: an optional device-stacked SceneBVH from partition_accel; the
    traversal kernel then runs UNDER the domain scheduler as the
    reference's fast adapter runs under every tracer
    (DomainTracer.h:228-326).

    return_stats: also return the summed count of rays dropped by exchange
    or compaction overflow (nonzero means the image is missing energy;
    DomainRenderer.render grows capacity). "peak" gives instead the tuple
    (drops, peak_dest_demand), the largest single-destination send demand
    of any round: the capacity a retry should use.

    resident: an optional (I, n_dev) bool residency matrix (multi-hot rows
    = replicated domains). A ray bound for domain i stays where it is if
    its member is resident for i, else it is routed round-robin by pixel
    id over i's replicas (build_routes). Default: the one-hot of `owners`.

    return_load: also return the (n_dev,) per-device count of ray-rounds
    traced (the queue histogram the hybrid policies feed on).

    initial_shuffle=False resumes a PARTIAL frame: `arena` is then the
    stacked per-member state of an earlier return_arena=True call; no
    camera-ray claim runs, and the rays whose domain a remap moved away
    from their member are exchanged before the first round (the JAX
    package parks them a round instead, which shifts their round count
    and so their random numbers). return_arena=True also returns (that stacked
    arena, the per-domain pending histogram). The stacked arena holds
    every member's C_local lanes, gathered over both axes, member (d, r)
    at lanes (r * n_dev + d) * C_local onward: n_dev * C_local lanes on
    one axis, as in the JAX package. (The JAX package returns the
    ray-axis member 0's arenas alone on a 2-D layout, and resumes every
    ray member from them.)

    local_slack: after the initial claim each member's working arena is
    compacted to ~(C / n_dev) * local_slack lanes (capped at C); rays that
    do not fit are counted in the drops.

    first_round: the frame's number of this call's first round, the round
    counter of the per-ray hashes (area-light samples, Russian roulette).
    A resumed chunk passes the rounds run before it, so that it draws the
    numbers the uninterrupted frame draws (the JAX package restarts at 0
    in every chunk).
    """
    dom = mesh.groups[axis]
    dev = dom.device
    rays_g = mesh.groups[ray_axis] if ray_axis else LocalGroup(1, dev)
    n_dev = dom.size
    cap = exchange_cap or first_cap(arena.capacity, n_dev)
    if initial_shuffle:
        shard_in = arena.capacity // rays_g.size
        c_local = local_width(shard_in, n_dev, local_slack)
    else:
        c_local = arena.capacity // (n_dev * rays_g.size)

    if resident is None:
        resident = one_hot_residency(_np(owners), n_dev)
    route_np, n_rep_np = build_routes(np.asarray(resident))
    route = torch.as_tensor(route_np, device=dev).long()
    n_rep = torch.as_tensor(n_rep_np, device=dev).long()
    res = torch.as_tensor(np.asarray(resident), device=dev)
    n_inst = route.shape[0]

    def inst_row(inst):
        return inst.clamp(0, n_inst - 1).long()

    def serving_device(inst, ray_id):
        """Replica that serves (domain, ray): round-robin by pixel id."""
        i = inst_row(inst)
        return route[i, ray_id.long() % n_rep[i]]

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    members = {}
    for d in dom.local:
        scene_l = shard(scene_stacked, d, dev)
        accel_l = shard(accel, d, dev)
        tile = tracer_lib._choose_tile(scene_l.tri_v0.shape[0])
        for r in rays_g.local:
            fb = image_lib.new_framebuffer(width, height, dev)
            if initial_shuffle:
                part = arena
                if rays_g.size > 1:
                    part = arena.map(lambda a: a[r * shard_in:
                                                 (r + 1) * shard_in])
                part, fb = tracer_lib.shuffle(scene_l, part, fb)
                part, d_claim = claim(
                    part, serving_device(part.inst, part.id) == d, c_local)
            else:
                at = (r * n_dev + d) * c_local
                part = arena.map(lambda a: a[at:at + c_local])
                d_claim = zero
            members[(d, r)] = _Member(d, scene_l, accel_l, tile, part, fb,
                                      d_claim, zero, zero)

    def queued(m):
        return m.arena.active & (m.arena.inst >= 0)

    def mark_migrants():
        """Each member's queued rays that NO local replica serves."""
        for m in members.values():
            m.send = queued(m) & ~res[inst_row(m.arena.inst), m.d]

    def migrate():
        """Send every member's migrants to their serving members: one
        exchange per ray-axis member, skipped when no member sends."""
        n_send = {}
        for r in rays_g.local:
            keys = [(d, r) for d in dom.local]
            total = dom.all_reduce([members[k].send.sum() for k in keys])
            n_send[r] = total[0]
        n_send_host = torch.stack(list(n_send.values())).tolist()
        for r, ns in zip(n_send, n_send_host):
            if ns == 0:
                continue        # no member has a migrant: skip the exchange
            group = [members[(d, r)] for d in dom.local]
            arenas, drops, peaks = exchange(
                dom, [m.arena for m in group],
                [torch.where(m.send, serving_device(m.arena.inst, m.arena.id),
                             -1) for m in group], cap)
            for m, a, dropped, peak in zip(group, arenas, drops, peaks):
                m.arena, m.drops = a, m.drops + dropped
                m.peak = torch.maximum(m.peak, peak)

    if not initial_shuffle:
        # a resumed chunk first sends the rays whose domain moved in a
        # remap, so that each is traced in the round the uninterrupted
        # frame traces it (with no remap nothing moves: the previous
        # chunk's last exchange placed every ray)
        mark_migrants()
        migrate()
    for rnd in range(max_rounds):
        live = _over_both(dom, rays_g,
                          {k: queued(m).sum() for k, m in members.items()},
                          "sum")
        if int(next(iter(live.values()))) == 0:
            break
        for m in members.values():
            # load: rays traceable here this round
            here0 = res[inst_row(m.arena.inst), m.d]
            m.traced = m.traced + (queued(m) & here0).sum()
            m.arena, m.fb = tracer_lib.trace_round(
                m.scene, m.arena, m.fb, first_round + rnd, m.tile,
                accel=m.accel)
        mark_migrants()
        migrate()

    first = next(iter(members))
    fb = _over_both(dom, rays_g,
                    {k: m.fb for k, m in members.items()}, "sum")[first]
    drops = _over_both(dom, rays_g,
                       {k: m.drops for k, m in members.items()}, "sum")[first]
    peak = _over_both(dom, rays_g,
                      {k: m.peak for k, m in members.items()}, "max")[first]
    # the per-device load histogram, and the per-domain pending histogram
    # (the gathered (domain, #rays) map of HybridTracer.h:223-265)
    loads = {}
    for r in rays_g.local:
        keys = [(d, r) for d in dom.local]
        loads.update(zip(keys, dom.all_gather(
            [members[k].traced for k in keys])))
    load = {}
    for d in dom.local:
        keys = [(d, r) for r in rays_g.local]
        load.update(zip(keys, rays_g.all_reduce([loads[k] for k in keys])))
    load = load[first]
    hist = _over_both(dom, rays_g, {
        k: torch.zeros((n_inst,), dtype=torch.int64, device=dev).index_add_(
            0, inst_row(m.arena.inst), queued(m).long())
        for k, m in members.items()}, "sum")[first]
    if not return_arena:
        fb = image_lib.clamp_rgb(fb)
    out = [fb]
    if return_stats:
        out.append((drops, peak) if return_stats == "peak" else drops)
    if return_load:
        out.append(load)
    if return_arena:
        out += [_gather_arena(dom, rays_g, members), hist]
    return tuple(out) if len(out) > 1 else fb


@dataclasses.dataclass
class DomainRenderer:
    """The partitioned scene and the mesh of groups, bundled."""

    scene_stacked: SceneData
    owners: torch.Tensor
    mesh: object
    axis: str = "domains"

    meshes_src: Sequence = None
    instances_src: Sequence = None
    lights_src: Sequence = None
    accel: SceneBVH | None = None
    resident: np.ndarray | None = None  # (I, n_dev) bool, multi-hot ok

    @classmethod
    def build(cls, meshes, instances, lights, mesh, axis: str = "domains",
              owners: np.ndarray | None = None, use_accel: bool = False,
              resident: np.ndarray | None = None):
        n_dev = mesh.shape[axis]
        if resident is None:
            if owners is None:
                owners = round_robin_owners(len(instances), n_dev)
            resident = one_hot_residency(_np(owners), n_dev)
        return cls._placed(meshes, instances, lights, mesh, axis, resident,
                           use_accel)

    @classmethod
    def _placed(cls, meshes, instances, lights, mesh, axis, resident,
                use_accel):
        n_dev = mesh.shape[axis]
        stacked, owners = partition_scene(meshes, instances, lights, n_dev,
                                          resident=resident,
                                          device=mesh.device)
        accel = (partition_accel(meshes, instances, n_dev, resident,
                                 device=mesh.device) if use_accel else None)
        return cls(stacked, owners, mesh, axis, meshes, instances, lights,
                   accel, resident)

    def reschedule(self, pending: np.ndarray,
                   policy: str = "RayWeightedSpread") -> "DomainRenderer":
        """Hybrid scheduling between frames: recompute the domain->device
        RESIDENCY from per-domain pending-ray counts with a
        schedule/policies.py policy, then repartition (the HybridTracer
        remap, HybridTracer.h:223-299). Multi-hot rows from the
        replication policies are kept: every resident device holds the
        domain's data and serves a round-robin share of its rays."""
        n_dev = self.mesh.shape[self.axis]
        resident = POLICIES[policy](np.asarray(pending), _np(self.owners),
                                    n_dev)
        return self.repartition(resident)

    def pending_histogram(self, camera) -> np.ndarray:
        """Per-domain primary-ray demand (the gathered (domain, #rays) map
        the hybrid policies consume)."""
        dev = self.mesh.device
        scene = build_scene(self.meshes_src, self.instances_src,
                            self.lights_src, device=dev)
        arena = tracer_lib.make_arena(camera.generate_rays(dev),
                                      int(scene.num_lights))
        fb = image_lib.new_framebuffer(camera.film_width, camera.film_height,
                                       dev)
        arena, _ = tracer_lib.shuffle(scene, arena, fb)
        inst, act = _np(arena.inst), _np(arena.active)
        return np.bincount(inst[act & (inst >= 0)],
                           minlength=int(scene.num_instances))

    def repartition(self, resident: np.ndarray) -> "DomainRenderer":
        """Re-place domain data per a new residency matrix (same mesh)."""
        return self._placed(self.meshes_src, self.instances_src,
                            self.lights_src, self.mesh, self.axis, resident,
                            self.accel is not None)

    def render_hybrid(self, camera, chunk: int = 4, tau: float = 2.0,
                      policy: str = "RayWeightedSpread",
                      max_rounds: int = 32, return_load: bool = False,
                      exchange_cap: int | None = None):
        """IN-FRAME hybrid scheduling (HybridTracer.h:223-299): trace in
        chunks of `chunk` rounds; after each chunk sum the per-domain
        pending histogram over the group, and when the per-device load
        imbalance exceeds `tau` (max/mean over every member, idle ones
        included), re-place domains with `policy` and resume the SAME
        frame. Rays ride along in the stacked arena; the ones whose domain
        moved migrate through the normal exchange on the next round. The
        remap decision is the host's, between chunks (the reference's
        per-iteration master remap).

        A chunk that drops rays is rewound to the arena from before it and
        replayed at the capacity and slack Regrow grows, at most 3 times
        in a frame, then it raises. trace_domain never writes into the
        arena it is given, so the rewind needs no copy (held by
        tests/test_torch_hybrid.py).

        Each chunk continues the frame's round count (trace_domain's
        first_round), and a resumed chunk sends the rays a remap moved
        before its first round, so every ray is traced in the round, and
        draws the per-ray numbers, of the uninterrupted frame: the image
        is the static render's. The JAX package restarts the count at 0 in
        every chunk and parks the moved rays a round, which changes the
        image wherever a later round samples an area light or rolls
        Russian roulette: a fault of the reference, not copied.
        Returns the clamped frame, and with return_load the (n_dev,)
        int64 ray-rounds traced per member over all chunks."""
        dev = self.mesh.device
        arena = tracer_lib.make_arena(camera.generate_rays(dev),
                                      int(self.scene_stacked.num_lights))
        n_dev = self.mesh.shape[self.axis]
        grow = Regrow(n_dev, exchange_cap or first_cap(arena.capacity, n_dev),
                      "in-frame exchange")
        dr = self
        if dr.resident is None:
            dr = dataclasses.replace(dr, resident=one_hot_residency(
                _np(dr.owners), n_dev))
        fb_total = image_lib.new_framebuffer(camera.film_width,
                                             camera.film_height, dev)
        loads = np.zeros((n_dev,), np.int64)

        def maybe_reshard(dr, hist):
            """Re-place domains when the projected member load is
            imbalanced (over ALL members: idle ones are the signal)."""
            route_np, n_rep_np = build_routes(np.asarray(dr.resident))
            dev_pending = np.zeros(n_dev)
            for i in np.nonzero(hist)[0]:
                dev_pending[route_np[i, :n_rep_np[i]]] += (
                    hist[i] / n_rep_np[i])
            if dev_pending.max() > 0 and (
                    dev_pending.max() / dev_pending.mean() > tau):
                resident = POLICIES[policy](
                    hist, primary_owner_np(np.asarray(dr.resident)), n_dev)
                if not np.array_equal(resident, dr.resident):
                    return dr.repartition(resident)
            return dr

        # iteration-0 remap: the reference recomputes the map BEFORE the
        # first trace too (HybridTracer.h:223 runs at every iteration)
        dr = maybe_reshard(dr, np.asarray(dr.pending_histogram(camera),
                                          np.int64))
        first = True
        done_rounds = 0
        while done_rounds < max_rounds:
            # a chunk is a pure function of (arena, cap, slack): an
            # overflowing one is replayed exactly from the pre-chunk arena
            arena_prev = arena
            fb, (drops, peak), load, arena, hist = trace_domain(
                dr.scene_stacked, dr.owners, arena,
                camera.film_width, camera.film_height,
                dr.mesh, dr.axis, min(chunk, max_rounds - done_rounds),
                exchange_cap=grow.cap, accel=dr.accel,
                return_stats="peak", return_load=True,
                resident=dr.resident, initial_shuffle=first,
                return_arena=True, local_slack=grow.slack,
                first_round=done_rounds)
            if grow.retry(drops, peak, arena_prev.capacity):
                arena = arena_prev
                continue
            fb_total = fb_total + fb
            loads += _np(load).astype(np.int64)
            done_rounds += chunk
            first = False
            hist = _np(hist)
            if hist.sum() == 0:
                break
            dr = maybe_reshard(dr, hist)
        fb_total = image_lib.clamp_rgb(fb_total)
        return (fb_total, torch.as_tensor(loads)) if return_load \
            else fb_total

    def render(self, camera, max_rounds: int = 32, max_grows: int = 3,
               return_load: bool = False):
        """Render a frame; a frame that drops rays is rendered again at the
        capacity and slack Regrow grows, and raises after max_grows
        grows."""
        dev = self.mesh.device
        arena = tracer_lib.make_arena(camera.generate_rays(dev),
                                      int(self.scene_stacked.num_lights))
        n_dev = self.mesh.shape[self.axis]
        grow = Regrow(n_dev, first_cap(arena.capacity, n_dev),
                      max_grows=max_grows)
        while True:
            fb, (drops, peak), load = trace_domain(
                self.scene_stacked, self.owners, arena,
                camera.film_width, camera.film_height,
                self.mesh, self.axis, max_rounds,
                exchange_cap=grow.cap, accel=self.accel,
                return_stats="peak", resident=self.resident,
                return_load=True, local_slack=grow.slack)
            if not grow.retry(drops, peak, arena.capacity):
                return (fb, load) if return_load else fb
