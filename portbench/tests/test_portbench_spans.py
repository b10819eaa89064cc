"""The readers of the program's spans: a finite number from a traced CPU
run of each cell that lists them, and None, never an exception, where the
program recorded nothing, holds no recorder (a commit before it) or
cannot be imported."""

import math
import sys
import types

import pytest

from portbench import harness, trace
from portbench import run as bench

READERS = ["facade.self_ms", "facade.compile_ms", "tracer.host_ms",
           "tracer.sync_wait_ms", "tracer.instance_search_ms",
           "train.forward_ms", "device.idle_unattributed_pct"]
CELLS = ["bunny_standin.resident_orbit", "gvt_simple.api_orbit",
         "gvt_simple.train", "bunny_standin.api_orbit"]


@pytest.fixture(autouse=True)
def no_spans():
    from gravit_tpu_torch.core import timing

    timing.clear()
    yield
    timing.clear()


def a_trace(frames=2):
    return trace.Trace(frames=frames, window_s=1.0, busy_s=0.1,
                       device_ops=[("k", 0.0, 0.1)],
                       idle_gaps=[("host, between operations", 0.5),
                                  ("aten::mul", 0.4)])


@pytest.mark.parametrize("name", CELLS)
def test_each_listed_reader_reads_a_traced_cpu_run(small_cell, name):
    cell = small_cell(name)
    listed = [m["name"] for m in cell.per_layer if m["name"] in READERS]
    assert listed
    res = bench.run_cell(cell, 2**31 + 17, 0.5, True, device="cpu",
                         film=(16, 16))
    for m in listed:
        assert math.isfinite(res["metrics"][m]["value"]), m


def test_every_reader_is_listed():
    bench_json = harness.load_json(harness.BENCHMARK)
    listed = {m["name"] for m in bench_json["per_layer"]}
    assert set(READERS) <= listed


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name):
    assert harness.metric_reader(name).read(a_trace()) is None


@pytest.mark.parametrize("name", READERS)
def test_no_recorder_reads_none(monkeypatch, name):
    reader = harness.metric_reader(name)
    # a program with its timing module but no recorder in it
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing",
                        types.ModuleType("gravit_tpu_torch.core.timing"))
    assert reader.read(a_trace()) is None
    # a program whose timing module cannot be imported
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing", None)
    assert reader.read(a_trace()) is None


def test_frames_that_do_not_match_read_none():
    from gravit_tpu_torch.core import timing

    with timing.recording():
        for _ in range(3):
            with timing.span("tracer.frame"):
                with timing.span("tracer.sync"):
                    pass
    reader = harness.metric_reader("tracer.sync_wait_ms")
    assert reader.read(a_trace(frames=2)) is None
    assert reader.read(a_trace(frames=3)) >= 0.0
