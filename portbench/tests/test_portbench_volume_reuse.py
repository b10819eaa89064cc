"""The reader of facade.volume_reuse_pct: 100 x
`facade.volume_scene_reused` / (`facade.volume_scene_reused` +
`facade.volume_scene_build`) spans; None where neither was recorded (a
program without the facade's volume scene cache), where the program holds
no recorder, or where its timing module cannot be imported; 100 on a
traced CPU run of the api volume cell at a small size (set-up renders the
first frame, so the window only reuses)."""

import copy
import math
import sys
import types

import pytest

from portbench import harness, trace
from portbench import run as bench

NAME = "facade.volume_reuse_pct"
CELL = "gvt_vol.api_orbit"


@pytest.fixture(autouse=True)
def no_spans():
    from gravit_tpu_torch.core import timing

    timing.clear()
    yield
    timing.clear()


def a_trace(frames):
    return trace.Trace(frames=frames, window_s=1.0, busy_s=0.1,
                       device_ops=[("k", 0.0, 0.1)], idle_gaps=[])


@pytest.mark.parametrize("reused,built,want", [(5, 0, 100.0), (4, 1, 80.0),
                                               (0, 0, None)])
def test_share_of_renders_that_reused(reused, built, want):
    """One more frame with neither span: it counts for neither side, and
    alone it reads None. The surface cache's spans count for neither."""
    from gravit_tpu_torch.core import timing

    with timing.recording():
        for name in (["facade.volume_scene_build"] * built
                     + ["facade.volume_scene_reused"] * reused + [None]):
            with timing.span("facade.render"):
                with timing.span("facade.volume_build"):
                    if name is not None:
                        with timing.span(name):
                            pass
                    with timing.span("facade.scene_build"):
                        pass
                with timing.span("volume.frame"):
                    pass
    got = harness.metric_reader(NAME).read(a_trace(reused + built + 1))
    assert got == want


def test_no_recorder_reads_none(monkeypatch):
    reader = harness.metric_reader(NAME)
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing",
                        types.ModuleType("gravit_tpu_torch.core.timing"))
    assert reader.read(a_trace(2)) is None
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing", None)
    assert reader.read(a_trace(2)) is None


def test_listed_for_the_api_volume_cell():
    bench_json = harness.load_json(harness.BENCHMARK)
    entry = next(m for m in bench_json["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert bench_json["per_layer"][-1] is entry


def test_a_traced_cpu_run_reads_100():
    """The api cell with its field cut to 32^3 in bricklets of 16, the
    orbit scaled to it and the traced window cut to two frames."""
    cell = harness.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    n = 16
    cell.config["scene_args"] = {"whole_extent": [-n, n - 1],
                                 "bricklets_xyz": [n, n, n]}
    side = 2.0 * n - 1.0
    cell.config["orbit"] = dict(cell.config["orbit"], center=[side / 2] * 3,
                                distance=math.sqrt(3.0) * side * 4.0)
    cell.traffic = dict(cell.traffic, trace_frames=2, warmup_frames=1,
                        warmup_seconds=0.0)
    res = bench.run_cell(cell, 2**31 + 37, 0.5, True, device="cpu",
                         film=(24, 24))
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == 100.0
    assert res["metrics"]["facade.volume_build_ms"]["value"] is not None
