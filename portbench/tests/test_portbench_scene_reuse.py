"""The reader of facade.scene_reuse_pct: 100 x `facade.scene_reused` /
(`facade.scene_reused` + `facade.scene_build`) spans; None where neither
was recorded (a program without the facade's scene cache), where the
program holds no recorder, or where its timing module cannot be imported;
100 on a traced CPU run of each cell that lists it (set-up renders the
first frame, so the window only reuses)."""

import sys
import types

import pytest

from portbench import harness, trace
from portbench import run as bench

NAME = "facade.scene_reuse_pct"


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
    alone it reads None."""
    from gravit_tpu_torch.core import timing

    with timing.recording():
        for name in (["facade.scene_build"] * built
                     + ["facade.scene_reused"] * reused + [None]):
            with timing.span("facade.render"):
                if name is not None:
                    with timing.span(name):
                        pass
                with timing.span("tracer.frame"):
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


def test_listed_for_the_api_cells():
    bench_json = harness.load_json(harness.BENCHMARK)
    entry = next(m for m in bench_json["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["gvt_simple.api_orbit",
                                  "bunny_standin.api_orbit"]


@pytest.mark.parametrize("name", ["gvt_simple.api_orbit",
                                  "bunny_standin.api_orbit"])
def test_a_traced_cpu_run_reads_100(small_cell, name):
    cell = small_cell(name)
    res = bench.run_cell(cell, 2**31 + 29, 0.5, True, device="cpu",
                         film=(16, 16))
    assert res["metrics"][NAME]["value"] == 100.0
    assert res["correct"]
