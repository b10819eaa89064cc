"""The slice kernels' schedule, mirrored on the CPU by
`slice_schedule_plain` (gravit_tpu_torch/ops/slice_march.py): rays map to
2-D film tiles (or runs of consecutive rays), a block marches batches of
planes in lockstep, and each batch has a box of grid cells, the footprint
its gathers read through L1. On the card `chip_smoke.py` holds the kernels'
own counts (busy blocks, batches, largest box) to this mirror's on the same
launches.

Checked here, exactly (no tolerance: these are integer schedules):
  * the mirror's schedule constants and argument block are the CUDA
    source's;
  * every ray maps to exactly one thread, ragged films included;
  * every tap that the plain march reads on a plane where the ray is valid
    and unsaturated lies inside the box of that ray's (block, batch), and
    that batch runs: both z rows, both hat columns in x and y, and the
    +-ISO_H gradient taps when an isosurface is on. For the whole brick
    (K4) and for z-windows (K5), for each march axis and flip, in film
    tiles and in runs of consecutive rays.
"""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gravit_tpu_torch.ops import slice_march as tsm  # noqa: E402
from test_torch_slice_march import VIEWS, setup  # noqa: E402

torch.set_num_threads(2)

SOURCE = ROOT / "gravit_tpu_torch" / "csrc" / "slice_march.cu"


def test_schedule_constants_match_the_source():
    """TILE and PLANE_BATCH are the kernels' TILE_W, TILE_H and BATCH."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tsm.TILE == (const("TILE_W"), const("TILE_H"))
    assert tsm.PLANE_BATCH == const("BATCH")


def test_march_args_fields_match_the_source():
    """_MarchArgs lists MarchArgs's members in order (the size check at
    load time runs only where the kernel is built)."""
    body = re.search(r"struct MarchArgs \{(.*?)\n\};", SOURCE.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.findall(r"\w+", part)[-1]
                      for part in decl.split(",")]
    assert names == [f for f, _ in tsm._MarchArgs._fields_]


@pytest.mark.parametrize("n,width", [(32 * 32, 32), (30 * 17, 30),
                                     (1000, 37), (1000, None), (5, None),
                                     (16 * 8, 16)])
def test_every_ray_maps_to_one_thread(n, width):
    ray_of = tsm._blocks(n, width)
    tw, th = tsm.TILE
    assert ray_of.shape[1] == tw * th
    got = ray_of[ray_of >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(n))
    if width:
        # the threads of a block lie in one tile of the film
        rows, cols = ray_of // width, ray_of % width
        for b in range(ray_of.shape[0]):
            live = ray_of[b] >= 0
            if live.any():
                assert int(rows[b][live].max() - rows[b][live].min()) < th
                assert int(cols[b][live].max() - cols[b][live].min()) < tw
                assert len(set((rows[b][live] // th).tolist())) == 1
                assert len(set((cols[b][live] // tw).tolist())) == 1
    else:
        assert torch.equal(ray_of.reshape(-1)[:n], torch.arange(n))


def _plan(arrays, meta, feat):
    t = [torch.tensor(a) for a in arrays]
    subs = tuple(tuple(torch.tensor(x) for x in s)
                 for s in feat.get("subgrids", ()))
    plan = tsm._prepare(t[0], t[1], t[2], t[5], t[6], t[7], **meta,
                        isovalues=feat.get("isovalues", ()), subgrids=subs,
                        slices=feat.get("slices", ()))
    return plan, t[3], t[4]


def _assert_boxes_cover_the_march(plan, color, w, slab_rows, film_width):
    """Run the plain march again and hold every read tap against the
    schedule's boxes; returns the schedule."""
    batch = tsm.PLANE_BATCH
    sch = tsm.slice_schedule_plain(plan, color, w, slab_rows, film_width)
    nz, nS, nL = plan.S.shape
    n = plan.rows[0].shape[0]
    block_of = torch.full((n,), -1, dtype=torch.int64)
    has = sch.ray_of >= 0
    block_of[sch.ray_of[has]] = torch.arange(sch.ray_of.shape[0])[
        :, None].expand_as(sch.ray_of)[has]
    checked = 0

    def on_plane(k, row, valid, w_now, gx, gy, tx, ty):
        nonlocal checked
        inside = valid & (w_now < tsm.OPACITY_TERMINATION)
        if not bool(inside.any()):
            return
        b, m = block_of[inside], k // batch
        assert bool(sch.executed[b, m].all()), k
        assert bool(sch.busy[b].all())
        z0, y0, x0, bz, by, bx = sch.box[b, m].unbind(-1)
        xs, ys = [tx[0], tx[1]], [ty[0], ty[1]]
        if plan.iso:
            for h in (tsm.ISO_H, -tsm.ISO_H):
                xs += tsm._hat_taps(gx + h, nL)[:2]
                ys += tsm._hat_taps(gy + h, nS)[:2]
        assert bool(((z0 <= row) & (row + 1 < z0 + bz)).all()), k
        assert row + 1 <= nz - 1
        for y in ys:
            y = y[inside]
            assert bool(((y0 <= y) & (y < y0 + by)).all()), k
        for x in xs:
            x = x[inside]
            assert bool(((x0 <= x) & (x < x0 + bx)).all()), k
        checked += int(inside.sum())

    tsm._run_plain(plan, color, w, slab_rows, on_plane=on_plane)
    assert checked > 100
    # executed batches run consecutively from each block's first
    ex = sch.executed.to(torch.int64)
    assert torch.equal(sch.executed.any(dim=1), sch.busy)
    starts = (ex[..., 1:] > ex[..., :-1]).sum(-1) + ex[..., 0]
    assert int(starts.max()) <= 1
    counts = sch.counts()
    assert counts["busy_blocks"] > 0 and counts["batches_l1"] > 0
    return sch


FEATURES = {"plain": (), "iso": ("iso",), "all": ("iso", "amr", "slice")}


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("case", list(FEATURES))
def test_boxes_cover_every_tap_whole_brick(case, film):
    arrays, meta, feat = setup(n=20, film=32, features=FEATURES[case])
    plan, color, w = _plan(arrays, meta, feat)
    sch = _assert_boxes_cover_the_march(plan, color, w, 20, 32 if film
                                        else None)
    if film:
        assert sch.ray_of.shape[0] == (32 // tsm.TILE[0]) * (32 // tsm.TILE[1])


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("view", list(VIEWS))
def test_boxes_cover_every_tap_axes_and_flips(view, film):
    """All features, grid spacing (0.5, 1, 2), sampling rate 2, from four
    sides: both flips, all three axes."""
    eye, expect = VIEWS[view]
    arrays, meta, feat = setup(n=16, film=24, eye=eye,
                               spacing=(0.5, 1.0, 2.0), rate=2.0,
                               features=("iso", "amr", "slice"))
    assert (meta["axis"], meta["flip"]) == expect
    plan, color, w = _plan(arrays, meta, feat)
    _assert_boxes_cover_the_march(plan, color, w, 16, 24 if film else None)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("view", ["diagonal", "x_flip", "z_noflip"])
def test_boxes_cover_every_tap_windows(view, film):
    """K5: a 32^3 brick in windows of 4 rows (11 windows). A plane belongs
    to one window per ray and the windows' planes ascend, so one ladder of
    batches crosses the window boundaries; each plane reads its own
    window's rows."""
    eye = (4.4, 4.0, 4.0) if view == "diagonal" else VIEWS[view][0]
    arrays, meta, _ = setup(n=32, film=32, eye=eye)
    plan, color, w = _plan(arrays, meta, {})
    assert len(tsm._windows(32, 4)) == 11
    sch = _assert_boxes_cover_the_march(plan, color, w, 4, 32 if film
                                        else None)
    # the same ladder as the whole brick's: windows change the rows only
    whole = tsm.slice_schedule_plain(plan, color, w, 32, 32 if film
                                     else None)
    assert torch.equal(sch.executed, whole.executed)


def test_saturated_and_inactive_rays_end_the_batches():
    """Rays that start saturated or inactive make no block busy; rays that
    saturate early end their block's batches before the far side."""
    arrays, meta, _ = setup(n=20, film=32)
    plan, color, w = _plan(arrays, meta, {})
    dead = tsm.slice_schedule_plain(plan, color, torch.full_like(w, 0.995),
                                    20, 32)
    assert dead.counts()["busy_blocks"] == 0
    assert not bool(dead.executed.any())
    full = tsm.slice_schedule_plain(plan, color, w, 20, 32)
    # a table that saturates in a few planes
    plan.rgba = plan.rgba.clone()
    plan.rgba[:, 3] = 0.9
    early = _assert_boxes_cover_the_march(plan, color, w, 20, 32)
    assert early.counts()["busy_blocks"] == full.counts()["busy_blocks"]
    assert int(early.executed.sum()) < int(full.executed.sum())


def test_box_bytes():
    """A box is the extent of its batch's taps in 4-byte cells, inside
    the grid, at least two rows deep; the counts are the batches that run
    with a tap and the largest of their boxes."""
    arrays, meta, _ = setup(n=20, film=32)
    plan, color, w = _plan(arrays, meta, {})
    nz, nS, nL = plan.S.shape
    sch = tsm.slice_schedule_plain(plan, color, w, 20, 32)
    run = sch.executed & (sch.nbytes > 0)
    z0, y0, x0, bz, by, bx = sch.box[run].unbind(-1)
    assert torch.equal(sch.nbytes[run], bz * by * bx * 4)
    assert bool((bz >= 2).all())
    assert bool(((z0 >= 0) & (z0 + bz <= nz) & (y0 >= 0) & (y0 + by <= nS)
                 & (x0 >= 0) & (x0 + bx <= nL)).all())
    c = sch.counts()
    assert c["batches_l1"] == int(run.sum()) > 0
    assert c["max_box_bytes"] == int(sch.nbytes[run].max())
    # a batch that does not run has no count; an idle block has no box
    assert not bool((sch.nbytes[~sch.busy] > 0).any())
