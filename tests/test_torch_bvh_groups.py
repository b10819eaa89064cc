"""The invariant that lets the CUDA traversal kernel vote per warp: a voting
group that walks the PACKET's traversal order (the near child by the sign of
the packet's summed direction) and prunes with its own lanes' slab tests
returns, for every lane, what the packet-wide vote of the TPU kernel returns.

`bvh_intersect_plain(group=...)` runs both walks on the CPU. Tolerance: none.
t, prim, u and v must be EQUAL (closest hit), and the occluded flags equal
(any hit, where only prim >= 0 has a meaning), equal-t ties included: both
walks meet the leaves in one order, so they pick the same winner. Against
the Pallas kernel in interpret mode prim is equal and t, u, v are held as
tests/test_torch_bvh.py holds them (XLA contracts a*b+c on the CPU).
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gravit_tpu.ops import pallas_bvh  # noqa: E402

from gravit_tpu_torch.accel.scene_accel import build_scene_bvh  # noqa: E402
from gravit_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from test_torch_bvh import (CASES, NB, assert_close_hits,  # noqa: E402
                            tables_jax, wavefront)
from test_torch_scene import random_mesh  # noqa: E402

torch.set_num_threads(2)

GROUPS = (bt.GROUP, 256)     # the kernel's warp, and a width in between


def both_walks(o, d, valid, roots, tables, any_hit, group, t_far=None):
    """(packet-wide walk, `group`-wide walk) on the same inputs."""
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    far = torch.full((o.shape[0],), bt.FLT_MAX) if t_far is None else t(t_far)
    args = (t(o), t(d), t(valid), t(roots), *(t(x) for x in tables), far,
            any_hit)
    return (bt.bvh_intersect_plain(*args),
            bt.bvh_intersect_plain(*args, group=group))


def assert_same_function(packet, grouped, valid, any_hit):
    live = torch.as_tensor(valid) != 0
    if any_hit:
        assert torch.equal((grouped.prim >= 0) & live,
                           (packet.prim >= 0) & live)
        return
    for name in ("prim", "t", "u", "v"):
        a, b = getattr(grouped, name), getattr(packet, name)
        assert torch.equal(a, b), (name, int((a != b).sum()))
    # the smaller group never walks more than the packet does
    per = packet.group // grouped.group
    assert (grouped.node_visits.reshape(-1, per).max(dim=1).values
            <= packet.node_visits).all()
    assert grouped.group * int(grouped.node_visits.sum()) \
        <= packet.group * int(packet.node_visits.sum())


def floor_scene(seed: int, bands: int = 12):
    """chip_smoke's flagship mesh at a small size: a displaced UV sphere
    (every edge shared by two triangles, every vertex by six) over a floor
    quad whose two triangles are coplanar and axis-aligned (a leaf box of
    zero height). Returns (compiled mesh, (bounds, meta, tri))."""
    cm = chip_smoke.make_scene(seed, bands=bands).meshes[0]
    acc = build_scene_bvh([cm], device="cpu")
    assert int(acc.mesh_root[0]) == 0
    return cm, (acc.bounds, acc.meta, acc.tri)


def tiled(a, side: int):
    """Row-major (side*side, ...) film order -> 32x32 tiles, one per packet,
    as trace_image_fast lays its wavefront out."""
    T = 32
    rest = a.shape[1:]
    return (a.reshape((side // T, T, side // T, T) + rest)
            .swapaxes(1, 2).reshape((side * side,) + rest))


def camera_wavefront(cm, seed: int, aim_at: str, side: int = 64):
    """Pinhole rays of the flagship camera over a side x side film, in
    tiles; then every 5th ray is re-aimed EXACTLY at a point of the mesh:
    "edges": a random point of a triangle's first edge (shared with its
    neighbour) or of the floor's diagonal, where two triangles tie;
    "corners": a mesh vertex (shared by six triangles, and a corner of
    their leaf boxes) or a point of the floor's rim (on the face of the
    floor's zero-height box). Returns (o, d, valid, re-aimed lanes)."""
    rng = np.random.default_rng(seed)
    n = side * side
    eye = np.array([0.0, 0.1, 0.3], np.float32)
    h = np.tan(np.pi / 8)
    px = (np.arange(side) + 0.5) / side * 2 - 1
    x, y = np.meshgrid(px * h, -px * h)
    d = np.stack([x, y, -np.ones_like(x)], -1).reshape(-1, 3)
    # the floor is the mesh's last two faces, (c0, c3, c2) and (c0, c2, c1)
    c0 = cm.v0[-1]
    c2, c1 = c0 + cm.e1[-1], c0 + cm.e2[-1]
    s = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    k = rng.integers(0, cm.num_triangles, n)
    if aim_at == "edges":
        on_mesh, on_floor = cm.v0[k] + s * cm.e1[k], c0 + s * (c2 - c0)
    else:
        on_mesh = cm.v0[k] + np.where(s < 0.5, cm.e1[k], cm.e2[k])
        on_floor = c1 + s * (c2 - c1)
    aim = np.where(rng.uniform(size=(n, 1)) < 0.7, on_mesh, on_floor)
    pick = np.arange(n) % 5 == 0
    d[pick] = (aim - eye)[pick]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(eye, d.shape).copy()
    return (tiled(o, side), tiled(d, side), np.ones(n, np.int32),
            tiled(pick, side))


def bounce_wavefront(cm, seed: int, n: int):
    """Bounce-like rays: origins on random triangles of the mesh, lifted
    1e-4 along the normal, directions cosine-distributed over the normal's
    hemisphere, so a packet's rays cover the whole tree."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, cm.num_triangles, n)
    a, b = rng.uniform(0, 1, (2, n, 1))
    flip = (a + b) > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    p = cm.v0[k] + a * cm.e1[k] + b * cm.e2[k]
    nrm = np.cross(cm.e1[k], cm.e2[k])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    r1, r2 = rng.uniform(0, 1, (2, n))
    phi = 2 * np.pi * r1
    loc = np.stack([np.sqrt(r2) * np.cos(phi), np.sqrt(r2) * np.sin(phi),
                    np.sqrt(1 - r2)], -1)
    helper = np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    tx = np.cross(helper, nrm)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(nrm, tx)
    d = loc[:, :1] * tx + loc[:, 1:2] * ty + loc[:, 2:] * nrm
    o = p + 1e-4 * nrm
    return (o.astype(np.float32), d.astype(np.float32),
            (rng.uniform(size=n) < 0.7).astype(np.int32))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,max_leaf", CASES)
def test_group_walk_equals_packet_walk(n_tris, max_leaf, any_hit, group):
    cm = random_mesh(n_tris, n_tris)
    o, d, valid = wavefront(n_tris, cm.bounds_min, cm.bounds_max)
    roots = np.array([0, 0, -1, 0], np.int32)
    p, g = both_walks(o, d, valid, roots, tables_jax(cm, max_leaf), any_hit,
                      group)
    assert int((p.prim >= 0).sum()) > 200
    assert_same_function(p, g, valid, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_group_walk_shared_edges_and_floor(seed, any_hit):
    cm, tables = floor_scene(seed)
    o, d, valid, _ = camera_wavefront(cm, seed, "edges")
    roots = np.zeros(o.shape[0] // bt.PACKET, np.int32)
    p, g = both_walks(o, d, valid, roots, tables, any_hit, bt.GROUP)
    y_hit = torch.as_tensor(o[:, 1]) + p.t * torch.as_tensor(d[:, 1])
    on_floor = (p.prim >= 0) & ((y_hit - float(cm.v0[-1, 1])).abs() < 1e-5)
    assert int((p.prim >= 0).sum()) > 2000 and int(on_floor.sum()) > 100
    assert_same_function(p, g, valid, any_hit)


@pytest.mark.parametrize("seed", [0, 3])
def test_group_walk_box_face_exception(seed):
    """Where float32 bends the invariant, and how far. A ray aimed exactly
    at a box corner or face can hit a triangle (Möller-Trumbore) inside a
    leaf whose box an exact slab test rejects by a rounding; the
    packet-wide vote enters that leaf on a neighbour's test. The warp walk
    tests conservatively (the exit distance scaled by bt.WIDEN), so it
    enters such a leaf on the lane's own test and loses no hit: limit 0
    lost hits (with the exact test: 5 a seed, on the floor's rim). What is
    left: a few re-aimed lanes find the neighbouring triangle at the same
    point (limit: the measured count, 7 and 6 of the 820 re-aimed lanes,
    t within 1e-6 relative, measured 7.7e-7); no lane finds a hit the
    packet walk misses (limit 0, measured 0); every lane that was not
    re-aimed is equal; any hit: the occluded flags are equal."""
    cm, tables = floor_scene(seed)
    o, d, valid, aimed = camera_wavefront(cm, seed, "corners")
    roots = np.zeros(o.shape[0] // bt.PACKET, np.int32)
    p, g = both_walks(o, d, valid, roots, tables, False, bt.GROUP)
    differ = (p.prim != g.prim) | (p.t != g.t)
    aimed = torch.as_tensor(aimed)
    assert not bool((differ & ~aimed).any())
    lanes = chip_smoke.vertex_lanes(g, p, torch.as_tensor(valid) != 0,
                                    aimed, any_hit=False)
    assert lanes["lost"] == 0 and lanes["gained"] == 0, lanes
    assert lanes["other"] == 0, lanes
    assert 0 < lanes["swapped"] <= {0: 7, 3: 6}[seed], lanes
    assert lanes["swapped"] == int(differ.sum())
    assert lanes["swap_rel_max"] <= 1e-6, lanes
    p, g = both_walks(o, d, valid, roots, tables, True, bt.GROUP)
    assert_same_function(p, g, valid, any_hit=True)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_group_walk_bounce_rays(seed, any_hit):
    cm, tables = floor_scene(seed, bands=40)
    o, d, valid = bounce_wavefront(cm, seed, 2 * bt.PACKET)
    roots = np.zeros(2, np.int32)
    p, g = both_walks(o, d, valid, roots, tables, any_hit, bt.GROUP)
    assert int((p.prim >= 0).sum()) > 300
    assert_same_function(p, g, valid, any_hit)
    if not any_hit:
        # incoherent rays: the packet enters several times what a warp needs
        assert (bt.PACKET * int(p.node_visits.sum())
                > 2 * bt.GROUP * int(g.node_visits.sum()))


@pytest.mark.parametrize("any_hit", [False, True])
def test_group_walk_dead_lanes_and_skipped_packets(any_hit):
    """Whole warps dead, a packet with a root and no live lane, a packet
    with root -1 and live lanes, a far bound short of the mesh."""
    cm = random_mesh(5, 200)
    o, d, valid = wavefront(5, cm.bounds_min, cm.bounds_max, live_frac=0.5)
    valid[:7 * bt.GROUP] = 0                 # seven dead warps in packet 0
    valid[bt.PACKET:2 * bt.PACKET] = 0       # packet 1: rooted, nobody live
    valid[3 * bt.PACKET + 5] = 1
    roots = np.array([0, 0, 0, -1], np.int32)
    far = np.full(o.shape[0], bt.FLT_MAX, np.float32)
    far[::3] = 1.2 * np.linalg.norm(cm.bounds_max - cm.bounds_min)
    p, g = both_walks(o, d, valid, roots, tables_jax(cm), any_hit, bt.GROUP,
                      t_far=far)
    assert_same_function(p, g, valid, any_hit)
    dead = torch.as_tensor(valid) == 0
    for r in (p, g):
        assert (r.prim[dead] == -1).all() and (r.prim[3 * bt.PACKET:] == -1).all()
        assert torch.equal(r.t[dead], torch.as_tensor(far)[dead])
    assert int((g.prim >= 0).sum()) > 100
    assert int(g.node_visits[:7].sum()) == 0          # dead warps leave at once
    per = bt.PACKET // bt.GROUP
    assert int(g.node_visits[per:2 * per].sum()) == 0
    assert int(g.node_visits[3 * per:].sum()) == 0


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**20), n_tris=st.integers(1, 300),
       live=st.floats(0.05, 1.0), any_hit=st.booleans(),
       group=st.sampled_from([1, 8, 32, 128, 512]))
def test_group_walk_property(seed, n_tris, live, any_hit, group):
    cm = random_mesh(seed, n_tris)
    rng = np.random.default_rng(seed)
    if rng.uniform() < 0.5:
        o, d, valid = wavefront(seed, cm.bounds_min, cm.bounds_max, live)
    else:
        o, d, valid = bounce_wavefront(cm, seed, NB * bt.PACKET)
    roots = np.where(rng.uniform(size=NB) < 0.8, 0, -1).astype(np.int32)
    p, g = both_walks(o, d, valid, roots, tables_jax(cm), any_hit, group)
    assert_same_function(p, g, valid, any_hit)


def test_lane_counts_are_the_single_ray_walk():
    """A group of one lane walks exactly what the lane needs, so its popped
    nodes and tested rows ARE the ray-level counts (closest hit pops every
    node it pushed)."""
    cm = random_mesh(8, 150)
    o, d, valid = wavefront(8, cm.bounds_min, cm.bounds_max)
    roots = np.zeros(NB, np.int32)
    p, g = both_walks(o, d, valid, roots, tables_jax(cm), False, 1)
    assert_same_function(p, g, valid, False)
    assert torch.equal(g.node_visits, g.lane_node_tests)
    assert torch.equal(g.tri_rows, g.lane_tri_rows)
    assert int(g.lane_tri_rows.sum()) > 0
    # the packet's lanes pass no fewer tests than they would alone: they are
    # also asked about nodes that only their neighbours enter
    assert int(p.lane_node_tests.sum()) >= int(g.lane_node_tests.sum())


@pytest.mark.parametrize("any_hit", [False, True])
def test_table_reads(any_hit):
    """`reads` marks the nodes a walk popped and the leaves whose rows it
    tested, and changes nothing else: a narrower group reads a subset of
    what a wider one reads, a leaf is tested only after it is popped, and
    a launch whose roots are all -1 reads nothing. chip_smoke's byte count
    of a launch follows from these marks."""
    cm = random_mesh(6, 180)
    o, d, valid = wavefront(6, cm.bounds_min, cm.bounds_max, live_frac=0.6)
    tables = tables_jax(cm)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    nodes = tables[0].shape[0]
    far = torch.full((o.shape[0],), bt.FLT_MAX)

    def walk(roots, group):
        args = (t(o), t(d), t(valid), t(roots), *(t(x) for x in tables), far,
                any_hit)
        reads = torch.zeros((nodes,), dtype=torch.uint8)
        r = bt.bvh_intersect_plain(*args, group=group, reads=reads)
        plain = bt.bvh_intersect_plain(*args, group=group)
        for a, b in zip(r[:8], plain[:8]):
            assert torch.equal(a, b)
        return r, reads

    roots = np.array([0, 0, -1, 0], np.int32)
    marks = {}
    for group in (1, bt.GROUP, bt.PACKET):
        r, marks[group] = walk(roots, group)
        popped, entered = (marks[group] & 1) != 0, (marks[group] & 2) != 0
        assert bool(popped[0]) and not bool((entered & ~popped).any())
        assert 0 < int(popped.sum()) <= int(r.node_visits.sum())
        meta = torch.as_tensor(tables[1])
        assert 0 < int(meta[entered, 1].sum()) <= int(r.tri_rows.sum())
        assert bool((meta[entered, 2] > 0).all())           # leaves only
    for narrow, wide in ((1, bt.GROUP), (bt.GROUP, bt.PACKET)):
        assert not bool((marks[narrow] & ~marks[wide]).any())
    _, none = walk(np.full(NB, -1, np.int32), bt.GROUP)
    assert not bool(none.any())
    # the launch's bytes: 20 a lane and 4 a block, the live blocks' rays,
    # the nodes and rows read
    args = (t(o), t(d), t(valid), t(roots))
    live = int((t(valid).reshape(NB, -1)[t(roots) >= 0] != 0).sum())
    got = chip_smoke.launch_bytes(args, dict(nodes=7, rows=5))
    assert got == (o.shape[0] * 20 + NB * 4 + 3 * bt.PACKET * 16 + live * 12
                   + 7 * 48 + 5 * 48)
    assert chip_smoke.launch_bytes(
        (t(o), t(d), t(valid), t(np.full(NB, -1, np.int32))),
        dict(nodes=0, rows=0)) == o.shape[0] * 20 + NB * 4


def kernel_order_sum(x: np.ndarray) -> np.float32:
    """One packet's 1024 float32 values summed as csrc/bvh_traverse.cu's
    block_sum adds them: per warp, lane i takes lane i + off for off = 16,
    8, 4, 2, 1; then s = 0 and s += each warp's lane 0, in warp order."""
    s = np.float32(0.0)
    for w in range(bt.PACKET // 32):
        lanes = [np.float32(v) for v in x[32 * w:32 * (w + 1)]]
        off = 16
        while off:
            lanes = [np.float32(lanes[i] + lanes[i + off])
                     for i in range(off)]
            off //= 2
        s = np.float32(s + lanes[0])
    return s


@pytest.mark.parametrize("symmetric", [False, True])
def test_packet_direction_signs_kernel_order(symmetric):
    """The packet's direction signs are summed in the kernel's order, on
    any device. With `symmetric`, each packet holds rows of directions
    mirrored about x = 0 with a rounding's shift, so the x sums lie within
    rounding of zero and their signs depend on the order of the adds."""
    rng = np.random.default_rng(5)
    d = rng.standard_normal((4 * bt.PACKET, 3)).astype(np.float32)
    if symmetric:
        half = d.reshape(4, 2, bt.PACKET // 2, 3)
        half[:, 1, :, 0] = -half[:, 0, ::-1, 0] * np.float32(1 + 2**-23)
    got = bt.packet_direction_signs(torch.from_numpy(d)).numpy()
    want = np.array([[kernel_order_sum(d[p * bt.PACKET:(p + 1) * bt.PACKET,
                                         c]) >= 0 for c in range(3)]
                     for p in range(4)])
    np.testing.assert_array_equal(got, want)


def test_group_is_checked():
    cm = random_mesh(2, 37)
    o, d, valid = wavefront(2, cm.bounds_min, cm.bounds_max)
    with pytest.raises(ValueError, match="group"):
        both_walks(o, d, valid, np.zeros(NB, np.int32), tables_jax(cm),
                   False, 48)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,max_leaf", CASES)
def test_group_walk_matches_pallas_interpret(n_tris, max_leaf, any_hit):
    cm = random_mesh(n_tris, n_tris)
    bounds, meta, tri = tables = tables_jax(cm, max_leaf)
    o, d, valid = wavefront(n_tris, cm.bounds_min, cm.bounds_max)
    roots = np.array([0, 0, -1, 0], np.int32)
    ref = [np.asarray(x) for x in pallas_bvh.bvh_intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        jnp.asarray(roots), jnp.asarray(bounds), jnp.asarray(meta),
        jnp.asarray(tri), interpret=True, any_hit=any_hit)]
    _, g = both_walks(o, d, valid, roots, tables, any_hit, bt.GROUP)
    t0, p0, u0, v0 = ref
    hit = p0 >= 0
    assert hit.sum() > 200
    if any_hit:
        np.testing.assert_array_equal(g.prim.numpy() >= 0, hit)
        return
    np.testing.assert_array_equal(g.prim.numpy(), p0)
    assert_close_hits((g.t.numpy(), g.u.numpy(), g.v.numpy()), (t0, u0, v0),
                      hit)
