"""The bricked volume path of the port on the CPU: VTK's wavelet in
VolApp's bricklets through api.render and through the resident calls
render_volume makes, against the benchmark's plain reference
(portbench/reference/volume.py), and the volume tracer's spans.

The field is the benchmark's frozen generator (portbench/scenes/
rt_wavelet.py) at a 32^3 extent in bricklets of 16: 2x2x2 bricks of 17
and 16 samples with the shared layer between them. Poses come from the
benchmark's orbit around the bricks (elevation -20..20 degrees, every
azimuth, 0.4-0.8 of VolApp's fitted distance), 32x32 film.

Tolerance against the reference, and why: max |difference| <= 1e-5 in
rgb, alpha equal. The reference takes the slice engine's float32 steps in
the same order, so the two sides round alike but for the CPU's pow, which
differs by an ulp between its vectorised body and its scalar tail (seen:
<= 1.8e-7). A sample taken on one side only (a plane at a brick's face, a
requeue that skips or repeats a plane) moves its pixel by 1e-3 or more,
which the bound excludes; alpha counts the rays that retire.
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gravit_tpu_torch import api  # noqa: E402
from gravit_tpu_torch.core import timing  # noqa: E402
from gravit_tpu_torch.core.context import RenderContext  # noqa: E402
from gravit_tpu_torch.render.renderer import Renderer  # noqa: E402
from gravit_tpu_torch.render import volume_tracer as vt  # noqa: E402
from gravit_tpu_torch.render.tracer import make_arena  # noqa: E402
from gravit_tpu_torch.render.volume_scene import build_volume_scene  # noqa: E402
from gravit_tpu_torch.render.volume_tracer import (can_slice_march,  # noqa: E402
                                                   slice_axes_for,
                                                   trace_volume)
from gravit_tpu_torch.scene.camera import PerspectiveCamera  # noqa: E402
from gravit_tpu_torch.scene.transfer import TransferFunction  # noqa: E402
from gravit_tpu_torch.scene.volume import Volume  # noqa: E402
from portbench.orbit import Orbit  # noqa: E402
from portbench.reference import volume as ref  # noqa: E402
from portbench.scenes import rt_wavelet  # noqa: E402

torch.set_num_threads(2)

EXTENT, BRICKLET, FILM = (-16, 15), 16, 32
FOV = math.radians(30.0)
JITTER = 0.5
TRANSFER = {"ramp": "gray", "max_opacity": 0.05}
TOL = 1e-5
SEEDS = (3, 2**31 + 11, 2**33 + 5)


@pytest.fixture(scope="module")
def field():
    return rt_wavelet.scene(EXTENT, (BRICKLET,) * 3)


@pytest.fixture(autouse=True)
def fresh():
    timing.clear()
    yield
    Renderer.reset()
    RenderContext.reset()
    timing.clear()


def orbit(field, seed):
    lo, hi = field.bounds()
    center = (lo + hi) / 2.0
    cfg = {"orbit": {"center": center.tolist(),
                     "distance": float(np.linalg.norm(hi - lo) * 4.0),
                     "distance_scale": [0.4, 0.8]},
           "camera": {"up": [0.0, 1.0, 0.0]}}
    return Orbit(cfg, {"orbit": {"elevation_deg": [-20.0, 20.0]}}, seed,
                 bounds=(lo, hi))


def transfer(field):
    return TransferFunction.gray_ramp(field.low, field.high, 0.05)


def api_scene(field) -> None:
    """VolApp's scene through the api: one volume and one identity instance
    a brick, a volume renderer "vr" under the Image schedule."""
    api.gvtInit(device="cpu")
    tf = transfer(field)
    for i, b in enumerate(field.bricks):
        name = f"vol{i}"
        api.createVolume(name)
        api._db().find(name)["tf"] = tf
        nz, ny, nx = b.samples.shape
        api.addVolumeSamples(name, b.samples.reshape(-1), [nx, ny, nz],
                             list(b.origin), [1.0, 1.0, 1.0], 1.0)
        api.addInstance(f"inst{i}", name,
                        np.eye(4, dtype=np.float32).ravel())
    api.addCamera("cam", [0.0, 0.0, 100.0], [15.5] * 3, [0.0, 1.0, 0.0],
                  FOV, 1, 1, JITTER)
    api.addFilm("film", FILM, FILM)
    api.addRenderer("vr", int(api.Adapter.Pvol), int(api.Schedule.Image),
                    "cam", "film", volume=True)


def api_frame(pose, fov=FOV):
    eye, focus, up = pose
    api.modifyCamera("cam", eye, focus, up, fov)
    api.render("vr")
    return Renderer.instance().framebuffer("vr")


def resident_scene(field):
    tf = transfer(field)
    volumes = [Volume(samples=b.samples, origin=b.origin,
                      spacing=np.ones(3, np.float32), tf=tf)
               for b in field.bricks]
    return build_volume_scene(
        volumes, [(i, np.eye(4, dtype=np.float32))
                  for i in range(len(volumes))], device="cpu")


def camera_rays(pose):
    eye, focus, up = pose
    cam = PerspectiveCamera(eye=eye, focus=focus, up=up, fov=FOV,
                            film_width=FILM, film_height=FILM,
                            jitter_window=JITTER)
    return cam.generate_rays("cpu", volume=True)


def resident_frame(field, pose):
    """The calls render_volume makes, with the bricks built once."""
    scene, rays = resident_scene(field), camera_rays(pose)
    assert not can_slice_march(scene, rays.direction)[0]  # eight bricks
    return trace_volume(scene, make_arena(rays, 0), FILM, FILM,
                        slice_axes=slice_axes_for(scene, rays.direction))


def queued_bricks_by_round(field, pose) -> list:
    """The wavefront replayed from its pieces, every brick marched in every
    round: per round, the bricks that hold a queued ray."""
    scene, rays = resident_scene(field), camera_rays(pose)
    axes = slice_axes_for(scene, rays.direction)
    arena = vt.filter_initial(scene, make_arena(rays, 0))
    fb = torch.zeros(FILM * FILM, 4)
    out = []
    while True:
        queued = arena.active & (arena.inst >= 0)
        if not bool(queued.any()):
            return out
        out.append(set(scene.inst_vol[arena.inst[queued].long()].tolist()))
        arena = vt.march_round(scene, arena, slice_axes=axes,
                               film_width=FILM,
                               volumes=range(scene.num_volumes))
        arena, fb = vt.shuffle_volume(scene, arena, fb)


def reference_frame(field, pose, control=None):
    eye, focus, up = pose
    prep = ref.prepare(field, TRANSFER, "cpu", control=control)
    return ref.render(prep, ref.Camera(eye, focus, up, FOV, FILM, FILM, 1,
                                       JITTER))


def test_generator_bricks(field):
    sizes = sorted({b.samples.shape for b in field.bricks})
    assert len(field.bricks) == 8
    assert {n for s in sizes for n in s} == {16, 17}
    lo, hi = field.bounds()
    assert lo.tolist() == [0.0] * 3 and hi.tolist() == [31.0] * 3


@pytest.mark.parametrize("seed", SEEDS)
def test_api_frame_matches_the_reference(field, seed):
    api_scene(field)
    pose = orbit(field, seed).pose(seed % 97)
    got = api_frame(pose)
    want = reference_frame(field, pose)
    assert float(want[:, 3].sum()) > 0.1 * FILM * FILM   # the volume shows
    assert float((got[:, :3] - want[:, :3]).abs().max()) <= TOL
    assert torch.equal(got[:, 3], want[:, 3])


@pytest.mark.parametrize("seed", SEEDS)
def test_resident_frame_equals_the_api_frame(field, seed):
    api_scene(field)
    pose = orbit(field, seed).pose(seed % 89)
    assert torch.equal(resident_frame(field, pose), api_frame(pose))


@pytest.mark.parametrize("control", ref.CONTROLS)
def test_each_control_moves_the_reference(field, control):
    """Each control moves some pixel by ten times TOL or more: the test
    above would catch it."""
    pose = orbit(field, SEEDS[0]).pose(1)
    d = (reference_frame(field, pose, control)
         - reference_frame(field, pose)).abs()
    assert float(d[:, :3].max()) > 10 * TOL


def _tree(spans):
    names = [s.name for s in spans]

    def parent(i):
        p = spans[i].parent
        return None if p is None else names[p]

    return names, parent


def _volume_build_span(spans, names, parent) -> list:
    """The names of the spans inside the one `facade.volume_build` span of
    a render, which lies in `facade.render`."""
    builds = [i for i, n in enumerate(names) if n == "facade.volume_build"]
    assert len(builds) == 1                   # the database read and build
    assert parent(builds[0]) == "facade.render"
    return [names[i] for i, s in enumerate(spans) if s.parent == builds[0]]


def test_api_frame_span_tree(field):
    """The first render's tree, whose one `facade.volume_build` span holds
    the volume scene cache's miss; the next render's holds its hit."""
    api_scene(field)
    with timing.recording() as rec:
        api_frame(orbit(field, SEEDS[1]).pose(0))
    spans = rec.spans()
    assert rec.since == 0                     # parents index `spans`
    names, parent = _tree(spans)
    assert names[0] == "facade.render" and spans[0].parent is None
    assert all(s.root == rec.since for s in spans)
    assert _volume_build_span(spans, names, parent) == [
        "facade.volume_scene_build"]
    frames = [i for i, n in enumerate(names) if n == "volume.frame"]
    assert len(frames) == 1 and parent(frames[0]) == "facade.render"
    rounds = [i for i, n in enumerate(names) if n == "volume.round"]
    assert len(rounds) >= 2
    assert all(parent(i) == "volume.frame" for i in rounds)
    for inner in ("volume.march_slice", "volume.shuffle"):
        idx = [i for i, n in enumerate(names) if n == inner]
        assert idx and all(parent(i) == "volume.round" for i in idx)
    # each round marches the bricks that hold a queued ray, and no other
    passes = [sum(1 for i, n in enumerate(names)
                  if n == "volume.march_slice" and spans[i].parent == r)
              for r in rounds]
    held = queued_bricks_by_round(field, orbit(field, SEEDS[1]).pose(0))
    assert passes == [len(b) for b in held]
    assert sum(passes) < 8 * len(rounds)
    assert "volume.march_gather" not in names
    search = [i for i, n in enumerate(names) if n == "volume.instance_search"]
    # the first queueing, then one query a shuffle
    assert len(search) == 1 + len(rounds)
    assert parent(search[0]) == "volume.frame"
    assert all(parent(i) == "volume.shuffle" for i in search[1:])
    syncs = [i for i, n in enumerate(names) if n == "tracer.sync"]
    # the gate's two reads (the instances' volumes, then every instance's
    # reductions at once) and one round test more than there are rounds
    assert len(syncs) == 2 + len(rounds) + 1
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    timing.clear()
    with timing.recording() as rec:
        api_frame(orbit(field, SEEDS[1]).pose(1))
    spans = rec.spans()
    names, parent = _tree(spans)
    assert _volume_build_span(spans, names, parent) == [
        "facade.volume_scene_reused"]
    assert names.count("volume.frame") == 1


def test_a_pose_outside_the_gate_marches_the_gather_engine(field):
    """A wide lens close to the bricks, looking along a diagonal: some ray
    has less than 0.25 of its direction on every axis, so no brick takes
    the slice engine."""
    api_scene(field)
    eye = (15.5 + 40.0, 15.5 + 20.0, 15.5 + 40.0)
    with timing.recording() as rec:
        fb = api_frame((eye, (15.5,) * 3, (0.0, 1.0, 0.0)),
                       fov=math.radians(100.0))
    spans = rec.spans()
    names, parent = _tree(spans)
    assert "volume.march_gather" in names
    assert "volume.march_slice" not in names
    # the gather march's early-exit test waits for the card
    assert any(n == "tracer.sync" and parent(i) == "volume.march_gather"
               for i, n in enumerate(names))
    assert float(fb[:, 3].sum()) > 0.0
    with pytest.raises(ValueError):
        ref.render(ref.prepare(field, TRANSFER, "cpu"),
                   ref.Camera(eye, (15.5,) * 3, (0.0, 1.0, 0.0),
                              math.radians(100.0), FILM, FILM, 1, JITTER))


def test_no_span_outside_a_recording(field):
    api_scene(field)
    api_frame(orbit(field, SEEDS[2]).pose(3))
    assert timing.recorded() == []


@pytest.fixture
def poisoned_empty():
    """torch.empty and its kin hand out NaN (floats) or the largest value
    (integers) in place of whatever memory held: a frame that reads a lane
    no op wrote shows it."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    yield
    torch.utils.deterministic.fill_uninitialized_memory = fill
    torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.mark.parametrize("pose", ["orbit", "outside_the_gate"])
def test_api_frame_reads_no_unwritten_memory(field, pose, poisoned_empty):
    """The api frame is bit-equal with every fresh buffer poisoned: the
    tracer, the march of either engine and the deposit read only lanes
    some op wrote (the instance search's indices included)."""
    if pose == "orbit":
        args = (orbit(field, SEEDS[1]).pose(5),)
    else:
        args = (((55.5, 35.5, 55.5), (15.5,) * 3, (0.0, 1.0, 0.0)),
                math.radians(100.0))
    api_scene(field)
    poisoned = api_frame(*args)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(False)
    assert torch.equal(poisoned, api_frame(*args))
    assert bool(torch.isfinite(poisoned).all())
