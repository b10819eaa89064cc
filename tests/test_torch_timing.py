"""The port's spans (gravit_tpu_torch/core/timing.py) on the CPU: off
unless a recording() or a profiler listens; under the profiler every span
is a CPU function event (not a user annotation, which the profiler would
mirror onto a device's timeline), nested as the program nests them; each
tracer and the train step record their root and phase spans; the report's
self times add up to the root. The megapass's bounce generations record one
`tracer.bounce` span each and count their lanes; with no listener a frame
records nothing and runs the same operations as before the counter, counted
op by op under a dispatch mode (a profiler would itself be a listener)."""

import collections
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke

from gravit_tpu_torch import api, dryrun
from gravit_tpu_torch.accel.scene_accel import build_scene_bvh
from gravit_tpu_torch.core import timing
from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.examples import simple_app
from gravit_tpu_torch.render import tracer
from gravit_tpu_torch.render.renderer import Renderer, render_surface
from gravit_tpu_torch.render.scene_build import build_scene
from gravit_tpu_torch.render.train import (adam, make_train_step,
                                           params_from_scene)

torch.set_num_threads(2)

FILM = 32
TRACER_PHASES = {"tracer.shuffle", "tracer.intersect", "tracer.shade",
                 "tracer.instance_search", "tracer.deposit"}


@pytest.fixture(autouse=True)
def fresh():
    timing.clear()
    Renderer.reset()
    yield
    timing.clear()
    Renderer.reset()
    RenderContext.reset()


def simple():
    return dryrun.simple_app(FILM, FILM)


def assert_nested(spans):
    """Every span closed, inside its parent, and of its parent's root."""
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent is None:
            assert spans[s.root] is s
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.root == p.root


def test_off_records_nothing():
    meshes, instances, lights, cam = simple()
    assert timing.span("a") is timing.span("b")      # the shared no-op
    render_surface(meshes, instances, lights, cam, device="cpu")
    assert timing.recorded() == []


def test_api_frame_under_the_profiler():
    simple_app.build_scene(int(api.Schedule.Image), wsize=(FILM, FILM),
                           device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.render("Enzoschedule")
    spans = timing.recorded()
    assert_nested(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["facade.render"]
    children = {s.name for s in spans if s.parent == 0}
    assert {"facade.scene_build", "camera.generate_rays",
            "tracer.frame"} <= children
    build = [s.name for s in spans
             if s.parent is not None and spans[s.parent].name
             == "facade.scene_build"]
    assert {"facade.compile_meshes", "facade.build_scene"} <= set(build)
    names = {s.name for s in spans}
    assert TRACER_PHASES | {"tracer.sync"} <= names
    # each span is one CPU function event of its name, none an annotation
    events = [e for e in prof.events() if e.name in names]
    assert len(events) == len(spans)
    assert all(not e.is_user_annotation for e in events)
    assert {str(e.device_type) for e in events} == {"DeviceType.CPU"}


def _fast(scene_args):
    meshes, instances, lights, cam = scene_args
    one = instances[:1]
    scene = build_scene(meshes, one, lights, device="cpu")
    accel = build_scene_bvh(meshes, device="cpu")
    return lambda: tracer.trace_image_fast(
        scene, cam.generate_rays("cpu"), FILM, FILM, accel=accel)


def _fast_multi(scene_args):
    meshes, instances, lights, cam = scene_args
    scene = build_scene(meshes, instances, lights, device="cpu")
    return lambda: tracer.trace_image_fast_multi(
        scene, cam.generate_rays("cpu"), FILM, FILM)


def _looped(scene_args):
    meshes, instances, lights, cam = scene_args
    scene = build_scene(meshes, instances, lights, device="cpu")
    return lambda: tracer.trace_image(scene, tracer.make_arena(
        cam.generate_rays("cpu"), scene.num_lights), FILM, FILM)


def _train(scene_args):
    meshes, instances, lights, cam = scene_args
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = tracer.make_arena(cam.generate_rays("cpu"), scene.num_lights)
    p = params_from_scene(scene)
    step, make_opt = make_train_step(adam(1e-3), rounds=2, width=FILM,
                                     height=FILM)
    opt = make_opt(list(p))
    target = torch.zeros((FILM * FILM, 4))
    return lambda: step(p, opt, scene, arena, target)


CASES = {
    "fast": (_fast, ["camera.generate_rays", "tracer.frame"], TRACER_PHASES),
    "fast_multi": (_fast_multi, ["camera.generate_rays", "tracer.frame"],
                   TRACER_PHASES | {"tracer.sync"}),
    "looped": (_looped, ["camera.generate_rays", "tracer.frame"],
               TRACER_PHASES | {"tracer.round", "tracer.sync"}),
    "train": (_train, ["train.forward", "train.backward", "train.update"],
              TRACER_PHASES | {"tracer.frame", "tracer.round"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_tracer_and_the_train_step_record_their_phases(case):
    make, roots, phases = CASES[case]
    run = make(simple())
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    spans = timing.recorded()
    assert_nested(spans)
    assert [s.name for s in spans if s.parent is None] == roots
    assert phases <= {s.name for s in spans}


def test_report_self_times_add_up_to_the_root():
    simple_app.build_scene(int(api.Schedule.Image), wsize=(FILM, FILM),
                           device="cpu")
    with timing.recording() as rec:
        api.render("Enzoschedule")
    assert not torch._C._autograd._profiler_enabled()
    spans = rec.spans()
    assert [s.name for s in spans if s.parent is None] == ["facade.render"]
    rows = {m.group(1): (float(m.group(2)), int(m.group(3)),
                         float(m.group(4)))
            for m in re.finditer(r"(\S+): +([\d.]+) ms +\((\d+)x\) +self +"
                                 r"([\d.]+) ms", rec.report())}
    assert set(rows) == {s.name for s in spans}
    assert rows["tracer.sync"][1] == sum(s.name == "tracer.sync"
                                         for s in spans)
    root_ms = rows["facade.render"][0]
    assert sum(v[2] for v in rows.values()) == pytest.approx(root_ms,
                                                             rel=0.01)


def _bounce_frame(depth):
    """A trace_image_fast frame of the bunny stand-in at 24 bands, with its
    BVH, at camera ray depth `depth`."""
    spec = chip_smoke.make_scene(bands=24, width=FILM, height=FILM,
                                 max_depth=depth)
    scene = build_scene(spec.meshes, spec.instances, spec.lights,
                        device="cpu")
    accel = build_scene_bvh(spec.meshes, device="cpu")
    return lambda: tracer.trace_image_fast(
        scene, spec.camera.generate_rays("cpu"), FILM, FILM, accel=accel,
        max_depth=depth)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bounce_generations_record_a_span_and_count_their_lanes(
        depth, monkeypatch):
    run = _bounce_frame(depth)
    bounced = []
    orig = tracer._process_surface_hits

    def recount(scene, arena, *a, **kw):
        out, spawn = orig(scene, arena, *a, **kw)
        bounced.append(int((out.active & (out.depth < arena.depth)).sum()))
        return out, spawn

    monkeypatch.setattr(tracer, "_process_surface_hits", recount)
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    spans = timing.recorded()
    assert_nested(spans)
    bounce = [i for i, s in enumerate(spans) if s.name == "tracer.bounce"]
    assert len(bounce) == depth - 1
    for i in bounce:
        assert spans[spans[i].parent].name == "tracer.frame"
        assert {"tracer.intersect", "tracer.shade"} <= {
            s.name for s in spans if s.parent == i}
    counts = timing.counted()
    if depth == 1:
        assert counts == {}
        return
    width = -(-FILM * FILM // tracer.PACKET) * tracer.PACKET
    assert counts["tracer.bounce_lanes"] == (depth - 1) * width
    # a generation g >= 1 queues the lanes that bounced in generation g-1
    assert counts["tracer.bounce_live"] == sum(bounced[:-1]) > 0


class _Ops(TorchDispatchMode):
    """The ATen operations run inside, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_no_listener_records_nothing_and_adds_no_operation(depth):
    run = _bounce_frame(depth)
    with _Ops() as off:
        run()
    assert timing.recorded() == [] and timing.counted() == {}
    with timing.recording():
        with _Ops() as on:
            run()
    # listening adds one reduction a bounce generation, and no host read
    assert not off.ops - on.ops
    assert dict(on.ops - off.ops) == (
        {"aten.sum.default": depth - 1} if depth > 1 else {})
