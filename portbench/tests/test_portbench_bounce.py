"""The depth-2 cell `bunny_standin.resident_orbit_d2` on the CPU at a small
scene and film: its reference's depth is the configuration's, a run of it
is `correct`, faults planted in the timed path are not, the TF32 control
fails, and the two readers of the bounce generations read numbers from a
traced run and None from a program without their span and counter."""

import copy
import sys
import types

import pytest
import torch

from portbench import compare, drivers, harness
from portbench import run as bench
from portbench.reference import surface_bounce
from portbench.reference.precision import Arith
from portbench.tests.conftest import SMALL_SCENE

CELL = "bunny_standin.resident_orbit_d2"
READERS = ["tracer.bounce_ms", "tracer.bounce_live_pct"]
SEED = 2**31 + 29

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_records():
    from gravit_tpu_torch.core import timing

    timing.clear()
    yield
    timing.clear()


@pytest.fixture
def d2_cell(small_cell):
    """The cell with the bunny stand-in cut to conftest's 24 bands (1,154
    triangles: the program still takes the BVH)."""
    cell = small_cell(CELL)
    cell.config = dict(copy.deepcopy(cell.config),
                       scene_args=SMALL_SCENE["bunny_standin"])
    return cell


def _run(cell, trace=False, film=(32, 32)):
    res = bench.run_cell(cell, SEED, 3.0, trace, device="cpu", film=film)
    assert res["attempted"] >= 2
    return res


def test_the_references_depth_is_the_configurations():
    cell = harness.load_cell(CELL)
    ref = harness.reference_of(cell.config)
    assert ref is surface_bounce
    assert cell.config["depth"] == surface_bounce.DEPTH
    # the harness's camera: eight fields, no depth
    cam = ref.Camera((0, 0, 1), (0, 0, 0), (0, 1, 0), 0.8, 8, 8, 1, 0.0)
    assert cam.max_depth == cell.config["depth"]
    assert cell.config_name == "bunny_standin_d2"
    assert [m["name"] for m in cell.per_layer if m["name"] in READERS] \
        == READERS
    assert "bvh_traverse_roofline" not in {m["name"] for m in cell.per_layer}


def test_run_is_correct(d2_cell):
    res = _run(d2_cell)
    assert res["correct"], res["checks"]
    assert {"frame_ms", "setup_s"} <= set(res["metrics"])


def _depth_one(monkeypatch):
    """The program renders at depth 1 what the cell asks at depth 2."""
    from gravit_tpu_torch.render import tracer

    orig = tracer.trace_image_fast

    def one(*a, **kw):
        return orig(*a, **dict(kw, max_depth=1))
    monkeypatch.setattr(tracer, "trace_image_fast", one)


def _other_salt(monkeypatch):
    """The program draws the bounce's direction with another salt (993
    for 992). The roulette's own salt is no fault at depth 2: a camera
    ray's weight is 1, so every hit with u > 0 bounces whatever u is."""
    from gravit_tpu_torch.render import tracer

    orig = tracer.hash_uniform2

    def salted(ray_id, salt, extra=None):
        return orig(ray_id, 993 if salt == 992 else salt, extra)
    monkeypatch.setattr(tracer, "hash_uniform2", salted)


@pytest.mark.parametrize("fault", [_depth_one, _other_salt])
def test_planted_fault_is_not_correct(d2_cell, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(d2_cell, film=(48, 48))
    assert not res["correct"], res["checks"]


def test_roulette_salt_changes_nothing_at_depth_two(d2_cell, monkeypatch):
    drv = drivers.make(d2_cell, SEED, "cpu", (32, 32))
    prep, params = surface_bounce.prepare(drv.scene_data,
                                          d2_cell.config["lights"], "cpu")
    cam = drv.ref_camera(drv.pose(0))
    want = surface_bounce.render(prep, params, cam)
    monkeypatch.setattr(surface_bounce, "SALT_ROULETTE", 993)
    assert (surface_bounce.render(prep, params, cam) == want).all()


def test_control_fails(d2_cell):
    drv = drivers.make(d2_cell, SEED, "cpu", (48, 48))
    prep, params = surface_bounce.prepare(drv.scene_data,
                                          d2_cell.config["lights"], "cpu")
    readings = []
    for k in range(3):
        cam = drv.ref_camera(drv.pose(k))
        low = surface_bounce.render(prep, params, cam, Arith("tf32"))
        readings.append(compare.frame_readings(
            low, surface_bounce.render(prep, params, cam)))
    ok, checks = compare.judge(compare.worst(readings), d2_cell.limits)
    assert not ok, checks


def test_readers_read_a_traced_run(d2_cell):
    res = _run(d2_cell, trace=True, film=(16, 16))
    assert res["correct"], res["checks"]
    ms = res["metrics"]["tracer.bounce_ms"]["value"]
    host = res["metrics"]["tracer.host_ms"]["value"]
    assert 0.0 < ms < host
    assert 0.0 < res["metrics"]["tracer.bounce_live_pct"]["value"] < 100.0


def test_a_program_without_them_reads_none(d2_cell, monkeypatch):
    """A program before the bounce span and counter: the traced run
    reports neither metric, and raises nothing."""
    from gravit_tpu_torch.core import timing
    from gravit_tpu_torch.render import tracer

    span = tracer.span
    monkeypatch.setattr(tracer, "span", lambda name: timing._OFF
                        if name == "tracer.bounce" else span(name))
    monkeypatch.delattr(timing, "counted")
    res = _run(d2_cell, trace=True, film=(16, 16))
    assert not set(READERS) & set(res["metrics"])
    assert "tracer.host_ms" in res["metrics"]


@pytest.mark.parametrize("name", READERS)
def test_no_timing_module_reads_none(monkeypatch, name):
    from portbench import trace

    reader = harness.metric_reader(name)
    t = trace.Trace(frames=2, window_s=1.0, busy_s=0.1)
    assert reader.read(t) is None
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing",
                        types.ModuleType("gravit_tpu_torch.core.timing"))
    assert reader.read(t) is None
    monkeypatch.setitem(sys.modules, "gravit_tpu_torch.core.timing", None)
    assert reader.read(t) is None

