"""The roofline's work: the frozen builder's tree is the program's, and the
frozen walk's counts are the program's plain walk's own-lane counts."""

import numpy as np
import pytest
import torch

from portbench.reference import surface as S
from portbench.reference import walk
from portbench.reference.bvh import build_bvh
from portbench.scenes import displaced_sphere


def _mesh(bands=20):
    m = displaced_sphere.scene(3, bands).meshes[0]
    v0 = m.verts[m.faces[:, 0]]
    return v0, m.verts[m.faces[:, 1]] - v0, m.verts[m.faces[:, 2]] - v0


def test_frozen_builder_gives_the_programs_tree():
    from gravit_tpu_torch.accel.bvh import build_bvh as port_build

    v0, e1, e2 = _mesh()
    ours = build_bvh(v0, e1, e2)
    for native in (True, False):
        theirs = port_build(v0, e1, e2, native=native)
        assert np.array_equal(ours.bounds, theirs.bounds)
        assert np.array_equal(ours.meta, theirs.meta)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_counts_are_the_plain_walks(any_hit):
    """Rays whose directions share their signs, so that each ray's own
    front-to-back order is its packet's: counts equal ray by ray against
    bvh_intersect_plain at a voting group of one lane."""
    from gravit_tpu_torch.ops import bvh_traverse as bt

    v0, e1, e2 = _mesh()
    tree = build_bvh(v0, e1, e2)
    g = torch.Generator().manual_seed(0)
    n = bt.PACKET
    tgt = torch.tensor([0.0, 0.11, 0.0]) + (torch.rand(n, 3, generator=g)
                                            - 0.5) * 0.2
    o = torch.tensor([-0.4, 0.5, -0.45]).expand(n, 3).contiguous()
    d = tgt - o
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    order = tree.order
    rows = np.concatenate([v0, e1, e2], 1)[order]
    table = torch.cat([torch.as_tensor(np.concatenate(
        [rows, np.zeros((len(rows), 3), np.float32)], 1)),
        torch.zeros(bt.LEAF_PAD, 12)])
    bounds, meta = torch.as_tensor(tree.bounds), torch.as_tensor(tree.meta)
    r = bt.bvh_intersect_plain(
        o, d, torch.ones(n, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), bounds, meta, table,
        torch.full((n,), S.FLT_MAX), any_hit=any_hit, group=1)
    wk = walk.walk(bounds, meta, torch.as_tensor(rows), o, d, any_hit)
    assert torch.equal(r.lane_node_tests.long(), wk["node_tests"])
    assert torch.equal(r.lane_tri_rows.long(), wk["rows"])
    assert torch.equal(r.prim >= 0, wk["hit"])
    assert int(wk["hit"].sum()) > n // 2


def test_frame_work_counts_both_launches():
    scene = displaced_sphere.scene(0, 24)
    cam = S.Camera((0.0, 0.1, 0.3), (0.0, 0.11, 0.0), (0.0, 1.0, 0.0),
                   0.785398, 32, 32)
    (w,) = walk.frame_work(scene, [dict(kind="point", position=(0, 0.1, 0.5),
                                        color=(1, 1, 1))], [cam], "cpu")
    assert w["k1"]["rays"] > 0 and w["k2"]["rays"] > 0
    assert w["ops"] == (walk.OPS_NODE * (w["k1"]["node_tests"]
                                         + w["k2"]["node_tests"])
                        + walk.OPS_ROW * (w["k1"]["rows"] + w["k2"]["rows"]))
    assert w["bytes"] == w["k1"]["bytes"] + w["k2"]["bytes"]
