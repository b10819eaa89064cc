"""The volume configuration's pieces on the CPU at a small size: the frozen
wavelet against its formula, its bricks against the BOV reader's rule,
the orbit inside the slice gate, the readers of the volume spans, a
traced run of each volume cell, and the three controls of the limits
planted in the program and failing the check."""

import copy
import math
import sys
import types

import numpy as np
import pytest
import torch

from portbench import compare, drivers, harness, trace
from portbench import run as bench
from portbench.orbit import Orbit
from portbench.reference import volume as ref
from portbench.scenes import rt_wavelet

CELLS = ["gvt_vol.api_orbit", "gvt_vol.resident_orbit"]
READERS = ["volume.kernel_ms", "volume.rounds", "volume.host_ms",
           "volume.slice_share_pct", "facade.volume_build_ms"]
SPAN_READERS = READERS[1:]
SMALL_EXTENT = 16            # a 32^3 field in bricklets of 16
FILM = (24, 24)
SEED = 2**31 + 23


@pytest.fixture(autouse=True)
def no_spans():
    from gravit_tpu_torch.core import timing

    timing.clear()
    yield
    timing.clear()


def small(name: str):
    """The cell with its field cut to SMALL_EXTENT, the orbit scaled to it
    and the traced window cut to two frames."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    n = SMALL_EXTENT
    cell.config["scene_args"] = {"whole_extent": [-n, n - 1],
                                 "bricklets_xyz": [n, n, n]}
    side = 2.0 * n - 1.0
    cell.config["orbit"] = dict(cell.config["orbit"], center=[side / 2] * 3,
                                distance=math.sqrt(3.0) * side * 4.0)
    cell.traffic = dict(cell.traffic, trace_frames=2, warmup_frames=1,
                        warmup_seconds=0.0)
    return cell


# -- the deployment ---------------------------------------------------------

@pytest.mark.parametrize("index", [(-256, -256, -256), (0, 0, 0),
                                   (255, -17, 100), (-1, 200, -128)])
def test_generator_is_the_formula(index):
    """vtkRTAnalyticSource's value at a grid index of the 512^3 extent,
    worked out with the math module, against the generator's slab."""
    lo, hi = -256, 255
    x, y, z = ((0.0 - i) / (hi - lo) for i in index)
    want = (255.0 * math.exp(-(x * x + y * y + z * z) / (2 * 0.5 ** 2))
            + 10.0 * math.sin(60.0 * x) + 18.0 * math.sin(30.0 * y)
            + 5.0 * math.cos(40.0 * z))
    xs = rt_wavelet.axis_coords(lo, hi, 0.0)
    k, j, i = (c - lo for c in index[::-1])
    got = (rt_wavelet.MAXIMUM
           * np.exp(-(xs[i] ** 2 + xs[j] ** 2 + xs[k] ** 2) / 0.5)
           + 10.0 * np.sin(60.0 * xs[i]) + 18.0 * np.sin(30.0 * xs[j])
           + 5.0 * np.cos(40.0 * xs[k]))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    field = rt_wavelet.field((-8, 7))
    assert field.dtype == np.float32 and field.shape == (16, 16, 16)
    x8 = [(0.0 - v) / 15.0 for v in (-8, 3)]
    want8 = (255.0 * math.exp(-(x8[0] ** 2 + x8[1] ** 2 + x8[0] ** 2) / 0.5)
             + 10.0 * math.sin(60.0 * x8[0]) + 18.0 * math.sin(30.0 * x8[1])
             + 5.0 * math.cos(40.0 * x8[0]))
    assert float(field[0, 11, 0]) == pytest.approx(want8, rel=1e-6)


def test_config_is_the_full_deployment():
    cfg = harness.load_json(harness.HERE / "configs" / "gvt_vol.json")
    assert cfg["scene_args"] == {"whole_extent": [-256, 255],
                                 "bricklets_xyz": [256, 256, 256]}
    assert cfg["reduced"] == [] and cfg["film"] == [512, 512]
    sizes = [257, 256]
    assert cfg["brick_bytes"] == 4 * sum(a * b * c for a in sizes
                                         for b in sizes for c in sizes)


def test_bricking_is_the_bov_readers(tmp_path):
    """rt_wavelet's bricks equal gravit_tpu_torch's BOV reader's
    (scene/readers/bov.py, VolApp's DIVIDE_BRICK) on the same field."""
    from gravit_tpu_torch.scene.readers.bov import read_bov

    data = rt_wavelet.field((-12, 11))
    data.tofile(tmp_path / "w.raw")
    (tmp_path / "w.bov").write_text(
        "DATA_FILE: w.raw\nDATA_SIZE: 24 24 24\nDATA_FORMAT: FLOAT\n"
        "DATA_BRICKLETS: 10 12 16\nDIVIDE_BRICK: true\n")
    theirs = read_bov(str(tmp_path / "w.bov"))
    ours = rt_wavelet.bricklets(data, (10, 12, 16))
    assert len(ours) == len(theirs) == 3 * 2 * 2
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.samples, b.samples)
        assert np.array_equal(a.origin, b.origin)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_orbit_stays_inside_the_slice_gate(seed):
    """Every ray of a 512x512 film, at poses spread over the whole orbit,
    keeps 0.25 or more of its direction on one axis, of one sign: the
    reference's gate passes, so the program takes the slice engine."""
    cell = harness.load_cell("gvt_vol.resident_orbit")
    lo, hi = np.zeros(3), np.full(3, 511.0)
    orbit = Orbit(cell.config, cell.traffic, seed, bounds=(lo, hi))
    fov = math.radians(cell.config["camera"]["fov_deg"])
    worst = 1.0
    for k in range(0, 240, 4):
        eye, focus, up = orbit.pose(k)
        _, d, _ = ref.camera_rays(ref.Camera(eye, focus, up, fov, 512, 512,
                                             1, 0.5), "cpu")
        axis, _ = ref.march_axis(d)
        worst = min(worst, float(d[:, axis].abs().min()))
    assert ref.MIN_AXIS_COMPONENT < worst < 0.5


# -- the readers ------------------------------------------------------------

def a_trace(frames=2, ops=()):
    return trace.Trace(frames=frames, window_s=1.0, busy_s=0.1,
                       device_ops=list(ops) or [("k", 0.0, 0.1)],
                       idle_gaps=[("host, between operations", 0.5)])


def record_frames(n: int, gather: bool = False) -> None:
    """n api volume frames of made-up spans: a build, then a tracer call
    of two rounds of two brick passes each."""
    from gravit_tpu_torch.core import timing

    with timing.recording():
        for _ in range(n):
            with timing.span("facade.render"):
                with timing.span("facade.volume_build"):
                    pass
                with timing.span("volume.frame"):
                    with timing.span("tracer.sync"):
                        pass
                    for _ in range(2):
                        with timing.span("volume.round"):
                            with timing.span("volume.march_slice"):
                                pass
                            with timing.span("volume.march_gather"
                                             if gather else
                                             "volume.march_slice"):
                                pass
                            with timing.span("volume.shuffle"):
                                with timing.span("volume.instance_search"):
                                    pass


def test_readers_on_made_up_spans():
    record_frames(3, gather=True)
    read = {n: harness.metric_reader(n).read(a_trace(frames=3))
            for n in SPAN_READERS}
    assert read["volume.rounds"] == 2.0
    assert read["volume.slice_share_pct"] == 50.0
    assert read["volume.host_ms"] >= 0.0
    assert read["facade.volume_build_ms"] >= 0.0
    # frames that do not match the trace's
    assert all(harness.metric_reader(n).read(a_trace(frames=2)) is None
               for n in SPAN_READERS)


def test_kernel_reader_reads_the_slice_kernels_by_name():
    reader = harness.metric_reader("volume.kernel_ms")
    ops = [("void slice_kernel<false, true>(MarchArgs)", 0.0, 0.002),
           ("void slice_kernel<true, false>(MarchArgs)", 0.01, 0.011),
           ("void bvh_traverse_kernel<0>(Args)", 0.02, 0.05),
           ("Memcpy HtoD (Pageable -> Device)", 0.1, 0.2)]
    assert reader.read(a_trace(frames=2, ops=ops)) == pytest.approx(1.5)
    assert reader.read(a_trace(frames=2)) is None
    assert reader.read(a_trace(frames=0, ops=ops)) is None


def test_a_program_without_the_volume_spans_reads_none():
    """The parent: api frames with their `facade.render` and `tracer.*`
    spans, none of the volume ones."""
    from gravit_tpu_torch.core import timing

    with timing.recording():
        for _ in range(2):
            with timing.span("facade.render"):
                with timing.span("tracer.sync"):
                    pass
    assert all(harness.metric_reader(n).read(a_trace(frames=2)) is None
               for n in SPAN_READERS)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_recorded_or_no_recorder_reads_none(monkeypatch, name):
    reader = harness.metric_reader(name)
    assert reader.read(a_trace()) is None
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing",
                        types.ModuleType("gravit_tpu_torch.core.timing"))
    assert reader.read(a_trace()) is None
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing", None)
    assert reader.read(a_trace()) is None


def test_every_reader_is_listed_for_its_cells():
    bench_json = harness.load_json(harness.BENCHMARK)
    listed = {m["name"]: m.get("workloads") for m in bench_json["per_layer"]}
    for n in READERS:
        want = CELLS[:1] if n == "facade.volume_build_ms" else CELLS
        assert listed[n] == want


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reads_each_span_reader(name):
    cell = small(name)
    listed = [m["name"] for m in cell.per_layer if m["name"] in SPAN_READERS]
    res = bench.run_cell(cell, SEED, 0.5, True, device="cpu", film=FILM)
    assert res["correct"], res["checks"]
    got = {m: res["metrics"][m]["value"] for m in listed}
    assert got["volume.slice_share_pct"] == 100.0
    assert got["volume.rounds"] >= 2.0
    assert all(math.isfinite(v) and v >= 0.0 for v in got.values())
    assert ("facade.volume_build_ms" in got) == (name == CELLS[0])


# -- the controls of the limits, planted in the program ---------------------

def _bf16(b):
    s = torch.from_numpy(b.samples).to(torch.bfloat16).to(torch.float32)
    return rt_wavelet.Brick(samples=s.numpy(), origin=b.origin)


def _cut(bricklets):
    def cut(b):
        bx, by, bz = bricklets
        return rt_wavelet.Brick(
            samples=np.ascontiguousarray(b.samples[:bz, :by, :bx]),
            origin=b.origin)
    return cut


def _no_correction(monkeypatch):
    from gravit_tpu_torch.ops import slice_march as sm

    monkeypatch.setattr(sm, "_arc_correction",
                        lambda d_obj, *a: torch.ones_like(d_obj[:, 0]))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, "bfloat16", "no_opacity_correction",
                                   "no_shared_layer"])
def test_controls_planted_in_the_program_fail_the_check(monkeypatch, name,
                                                        fault):
    """The program renders from bricks in bfloat16, without the opacity
    correction or without the shared layer; the check against the
    reference from the true bricks fails under the cell's limits. Without
    a fault it passes."""
    cell = small(name)
    drv = drivers.make(cell, SEED, "cpu", FILM)
    true_data = drv.scene_data
    if fault == "no_opacity_correction":
        _no_correction(monkeypatch)
    elif fault is not None:
        change = _bf16 if fault == "bfloat16" else _cut(true_data.bricklets)
        drv.scene_data = rt_wavelet.VolumeData(
            bricks=[change(b) for b in true_data.bricks],
            size=true_data.size, bricklets=true_data.bricklets,
            low=true_data.low, high=true_data.high)
    drv.setup()
    kept = [(k, drv.frame(k)) for k in (4, 9)]
    drv.release()
    drv.scene_data = true_data
    correct, checks = compare.judge(drv.check(kept), cell.limits)
    assert correct == (fault is None), checks
