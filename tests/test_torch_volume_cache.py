"""The facade's volume scene cache (render/renderer.py: Renderer keeps its
last single-device volume build while the database's SceneKey holds) and
the volume revision it keys on (scene/volume.py), on the CPU.

Reuse: N camera-only api frames of two 16^3 bricks record one
`facade.volume_scene_build` span and N - 1 `facade.volume_scene_reused`
spans, each inside the render's one `facade.volume_build` span and each
frame bit-equal to a fresh Renderer's at the same pose. Invalidation:
every way of editing the database between two renders builds once more,
and the frame after the edit is bit-equal to a fresh Renderer's; a caller
writing into the array it handed to addVolumeSamples changes nothing, and
a write into the samples the api holds raises. Renderer.reset() drops the
kept build; render_volume and the volume-domain arm build on every call.
The volume revision grows with every edit and not with derived data or a
render.
"""

import math

import numpy as np
import pytest
import torch

from gravit_tpu_torch import api
from gravit_tpu_torch.core import timing
from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render.renderer import Renderer, render_volume
from gravit_tpu_torch.render.volume_scene import build_volume_scene
from gravit_tpu_torch.scene.transfer import TransferFunction
from gravit_tpu_torch.scene.volume import Volume, wavelet_volume

torch.set_num_threads(2)

N, FILM, FRAMES = 16, 32, 4
BUILD, REUSED = "facade.volume_scene_build", "facade.volume_scene_reused"
CENTER = [N - 0.5, (N - 1) / 2.0, (N - 1) / 2.0]
EYE = [CENTER[0] + 10.0, CENTER[1] - 70.0, CENTER[2] + 30.0]
UP = [0.0, 0.0, 1.0]
FOV = math.radians(30.0)


@pytest.fixture(autouse=True)
def fresh():
    timing.clear()
    Renderer.reset()
    yield
    timing.clear()
    Renderer.reset()
    RenderContext.reset()


def placed(t):
    """A column-major 4x4 (glm::value_ptr's layout) that translates by t."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m.T.ravel()


def volume_scene():
    """Two 16^3 wavelet bricks side by side (the second at x = 15), one
    identity instance each, a volume renderer "vr" under the Image
    schedule. Returns the samples buffer handed to addVolumeSamples, which
    the caller keeps."""
    api.gvtInit(device="cpu")
    db = api._db()
    brick = wavelet_volume(N)
    flat = brick.samples.reshape(-1).copy()
    for i in range(2):
        api.createVolume(f"vol{i}")
        db.find(f"vol{i}")["tf"] = brick.tf
        api.addVolumeSamples(f"vol{i}", flat, [N, N, N],
                             [float(N - 1) * i, 0.0, 0.0], [1.0, 1.0, 1.0],
                             1.0)
        api.addInstance(f"inst{i}", f"vol{i}", placed((0.0, 0.0, 0.0)))
    api.addCamera("cam", EYE, CENTER, UP, FOV, 1, 1, 0.5)
    api.addFilm("film", FILM, FILM)
    api.addRenderer("vr", int(api.Adapter.Pvol), int(api.Schedule.Image),
                    "cam", "film", volume=True)
    return flat


def ptr(name):
    return api._db().find(name)["ptr"]


def render(name="vr"):
    """api.render(name) under recording(): (its frame, {span: count}).
    The cache's spans lie inside the render's one `facade.volume_build`."""
    with timing.recording() as rec:
        api.render(name)
    spans = rec.spans()
    names = [s.name for s in spans]
    assert names.count("facade.volume_build") == 1
    outer = names.index("facade.volume_build") + rec.since
    assert all(s.parent == outer for s in spans if s.name in (BUILD, REUSED))
    return (Renderer.instance().framebuffer(name),
            {BUILD: names.count(BUILD), REUSED: names.count(REUSED)})


def fresh_frame(name="vr"):
    """The frame a new Renderer renders from the database as it stands."""
    r = Renderer()
    r.render(name)
    return r.framebuffer(name)


def test_camera_only_frames_reuse_the_build():
    volume_scene()
    seen = {BUILD: 0, REUSED: 0}
    frames = []
    for k in range(FRAMES):
        pose = [EYE[0] + 2.0 * k, EYE[1] + 1.0 * k, EYE[2] - 1.5 * k]
        api.modifyCamera("cam", pose, CENTER, UP, FOV)
        fb, counts = render()
        for key in seen:
            seen[key] += counts[key]
        assert torch.equal(fb, fresh_frame()), k
        frames.append(fb)
    assert seen == {BUILD: 1, REUSED: FRAMES - 1}
    assert not torch.equal(frames[0], frames[-1])     # the camera moved
    assert float(frames[0][:, 3].sum()) > 0.05 * FILM * FILM


# -- invalidation: an edit between two renders -----------------------------

def _new_samples(buf):
    api.addVolumeSamples("vol0", np.flip(buf).copy(), [N, N, N],
                         [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], 1.0)


def _transfer_function(buf):
    tf = ptr("vol0").tf
    ptr("vol0").tf = TransferFunction(tf.color_lut, tf.opacity_lut * 4.0,
                                      tf.low, tf.high)


def _transfer_function_range_in_place(buf):
    ptr("vol0").tf.low += 20.0            # vol1 shares the object


def _transfer_function_table_in_place(buf):
    ptr("vol1").tf.color_lut[:, 0] *= 0.25


def _isovalues(buf):
    api.setVolumeIsovalues("vol0", [float(buf.mean())])


def _isovalues_in_place(buf):
    ptr("vol0").isovalues.append(float(buf.mean()))     # a list, given before


def _slices(buf):
    api.setVolumeSlices("vol1", [[1.0, 0.2, 0.1, -(N - 1) * 1.5]])


def _amr_subgrid(buf):
    n = N // 2
    fine = np.full(n ** 3, float(buf.max()), np.float32)
    api.addAmrSubgrid("vol0", 1, 1, fine, [n, n, n], [N / 4.0] * 3,
                      [0.5] * 3)


def _subgrid_field_assignment(buf):
    sub = api._db().find("vol0")["subgrids"][0][2]     # added before
    sub.samples = np.zeros_like(sub.samples)


def _instance_matrix(buf):
    api._db().find("inst1")["mat"] = np.array(
        placed((0.0, 0.0, 3.0)), np.float32).reshape(4, 4).T


def _instance_matrix_in_place(buf):
    api._db().find("inst1")["mat"][2, 3] += 3.0


def _added_instance(buf):
    api.addInstance("inst2", "vol0", placed((0.0, 0.0, N - 1.0)))


def _sampling_rate(buf):
    ptr("vol0").sampling_rate = 2.0


def _replace_ptr_equal(buf):
    v = ptr("vol0")
    api._db().find("vol0")["ptr"] = Volume(
        samples=v.samples, origin=v.origin, spacing=v.spacing, tf=v.tf)


def _caller_writes_its_buffer(buf):
    buf += 30.0


# (edit, builds it causes, whether the frame changes)
EDITS = {
    "addVolumeSamples": (_new_samples, 1, True),
    "transfer_function": (_transfer_function, 1, True),
    "transfer_function_range_in_place": (_transfer_function_range_in_place,
                                         1, True),
    "transfer_function_table_in_place": (_transfer_function_table_in_place,
                                         1, True),
    "setVolumeIsovalues": (_isovalues, 1, True),
    "isovalues_in_place": (_isovalues_in_place, 1, True),
    "setVolumeSlices": (_slices, 1, True),
    "addAmrSubgrid": (_amr_subgrid, 1, True),
    "subgrid_field_assignment": (_subgrid_field_assignment, 1, True),
    "instance_matrix": (_instance_matrix, 1, True),
    "instance_matrix_in_place": (_instance_matrix_in_place, 1, True),
    "addInstance": (_added_instance, 1, True),
    "field_assignment": (_sampling_rate, 1, True),
    "replace_ptr_equal_volume": (_replace_ptr_equal, 1, False),
    "caller_writes_its_buffer": (_caller_writes_its_buffer, 0, False),
}


@pytest.mark.parametrize("edit", list(EDITS))
def test_an_edit_between_renders_rebuilds(edit):
    change, builds, changes = EDITS[edit]
    buf = volume_scene()
    if edit == "subgrid_field_assignment":
        _amr_subgrid(buf)
    if edit == "isovalues_in_place":
        ptr("vol0").isovalues = []
    before, counts = render()
    assert counts == {BUILD: 1, REUSED: 0}
    assert torch.equal(before, fresh_frame())
    change(buf)
    after, counts = render()
    assert counts == {BUILD: builds, REUSED: 1 - builds}
    assert torch.equal(after, fresh_frame())
    assert torch.equal(after, before) != changes
    # and the next camera-only frame reuses the new build
    _, counts = render()
    assert counts == {BUILD: 0, REUSED: 1}


def test_another_volume_of_the_same_revision_rebuilds():
    """A Volume that shares the subgrid list of the rendered one reads the
    same revision once the list is edited; the key tells them apart by
    object."""
    volume_scene()
    vol = ptr("vol0")
    dim = Volume(samples=vol.samples * 0.5, origin=vol.origin,
                 spacing=vol.spacing, tf=vol.tf)
    dim.subgrids = vol.subgrids
    vol.subgrids.clear()                   # empty before and after
    assert dim.revision == vol.revision
    before, _ = render()
    api._db().find("vol0")["ptr"] = dim
    after, counts = render()
    assert counts == {BUILD: 1, REUSED: 0}
    assert torch.equal(after, fresh_frame())
    assert not torch.equal(after, before)


@pytest.mark.parametrize("field", ["samples", "origin", "spacing",
                                   "subgrid_samples"])
def test_the_api_volume_arrays_are_read_only(field):
    """A write into an array the api holds raises instead of leaving the
    kept bricks stale."""
    buf = volume_scene()
    _amr_subgrid(buf)
    render()
    held = (api._db().find("vol0")["subgrids"][0][2].samples
            if field == "subgrid_samples" else getattr(ptr("vol0"), field))
    with pytest.raises(ValueError):
        held[(0,) * held.ndim] = 1.0
    _, counts = render()
    assert counts == {BUILD: 0, REUSED: 1}


def test_reset_drops_the_kept_build():
    volume_scene()
    render()
    kept = Renderer.instance()
    assert kept.volume_build is not None
    Renderer.reset()
    assert kept.volume_build is None
    _, counts = render()
    assert counts == {BUILD: 1, REUSED: 0}


def test_render_volume_and_the_domain_arm_build_every_call():
    volume_scene()
    db = RenderContext.instance()
    r = Renderer()
    volumes, instances = r._volume_scene(db)
    cam = r._camera(db, "cam", "film")
    with timing.recording() as rec:
        one = render_volume(volumes, instances, cam, device="cpu")
        two = render_volume(volumes, instances, cam, device="cpu")
    names = [s.name for s in rec.spans()]
    assert names.count("facade.volume_build") == 2
    assert BUILD not in names and REUSED not in names
    assert torch.equal(one, two)
    api.modifyRenderer("vr", int(api.Adapter.Pvol), int(api.Schedule.Domain),
                       "cam", "film")
    pair = Renderer(mesh=global_mesh(("domains",), (2,), device="cpu"))
    with timing.recording() as rec:
        pair.render("vr")
        pair.render("vr")
    names = [s.name for s in rec.spans()]
    assert names.count("facade.volume_build") == 2
    assert BUILD not in names and REUSED not in names
    assert names.count("volume.frame") == 0       # the domain arm's tracer
    assert pair.volume_build is None


# -- the volume revision ---------------------------------------------------

def a_volume():
    v = wavelet_volume(8)
    v.subgrids.append(wavelet_volume(4))
    return v


VOLUME_EDITS = {
    "assign_samples": lambda v: setattr(v, "samples", v.samples * 2.0),
    "assign_origin": lambda v: setattr(v, "origin", v.origin + 1.0),
    "assign_spacing": lambda v: setattr(v, "spacing", v.spacing * 2.0),
    "assign_sampling_rate": lambda v: setattr(v, "sampling_rate", 2.0),
    "assign_tf": lambda v: setattr(v, "tf", TransferFunction.gray_ramp()),
    "assign_level": lambda v: setattr(v, "level", 1),
    "assign_isovalues": lambda v: setattr(v, "isovalues", (1.0,)),
    "assign_slices": lambda v: setattr(v, "slices", ((1.0, 0, 0, -2.0),)),
    "assign_subgrids": lambda v: setattr(v, "subgrids", []),
    "append": lambda v: v.subgrids.append(wavelet_volume(4)),
    "extend": lambda v: v.subgrids.extend([wavelet_volume(4)]),
    "insert": lambda v: v.subgrids.insert(0, wavelet_volume(4)),
    "item": lambda v: v.subgrids.__setitem__(0, wavelet_volume(4)),
    "del": lambda v: v.subgrids.__delitem__(0),
    "pop": lambda v: v.subgrids.pop(),
    "clear": lambda v: v.subgrids.clear(),
    "iadd": lambda v: v.subgrids.__iadd__([wavelet_volume(4)]),
}


@pytest.mark.parametrize("edit", list(VOLUME_EDITS))
def test_every_edit_grows_the_revision(edit):
    v = a_volume()
    r0 = v.revision
    VOLUME_EDITS[edit](v)
    assert v.revision > r0


def test_derived_data_and_a_render_are_no_edit():
    """Counts, bounds, steps and a build read the volume without editing
    it; an api render attaches the node's subgrids to a copy and moves no
    revision in the database."""
    v = a_volume()
    r0 = v.revision
    v.counts, v.bounds_min, v.bounds_max, v.step_size(), v.max_steps()
    build_volume_scene([v], [(0, np.eye(4, dtype=np.float32))],
                       device="cpu")
    assert v.revision == r0
    buf = volume_scene()
    _amr_subgrid(buf)
    sub = api._db().find("vol0")["subgrids"][0][2]
    revisions = [ptr("vol0").revision, ptr("vol1").revision, sub.revision]
    render()
    render()
    assert [ptr("vol0").revision, ptr("vol1").revision,
            sub.revision] == revisions
    assert list(ptr("vol0").subgrids) == []


def test_the_api_copies_the_callers_samples():
    """What the database holds does not change when the caller writes
    into the float32 arrays it handed over."""
    api.gvtInit(device="cpu")
    api.createVolume("v")
    samples = np.linspace(0.0, 1.0, 8).astype(np.float32)
    origin = np.zeros(3, np.float32)
    api.addVolumeSamples("v", samples, [2, 2, 2], origin, [1.0] * 3, 1.0)
    api.addAmrSubgrid("v", 1, 1, samples, [2, 2, 2], origin, [0.5] * 3)
    sub = api._db().find("v")["subgrids"][0][2]
    samples += 1.0
    origin += 1.0
    want = np.linspace(0.0, 1.0, 8).astype(np.float32).reshape(2, 2, 2)
    for vol in (ptr("v"), sub):
        np.testing.assert_array_equal(vol.samples, want)
        np.testing.assert_array_equal(vol.origin, np.zeros(3, np.float32))
