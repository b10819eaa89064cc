"""The port's facade (gravit_tpu_torch/api.py, render/renderer.py::
Renderer, gvt.py, examples/) against the JAX package's, on the CPU: the
counterparts of tests/test_api.py (SimpleApp at 32^2 through the Image and
the Domain schedule, a volume render, the volume domain schedule), the
image file, the scene database, the member count from the layout, the
max_depth gate, the pygvt names, and the ported apps on generated data.

Tolerances: tests/test_api.py's own bounds. The Image frame within 1e-6
and the Domain frame within 1e-5 of JAX's api frame and of the port's
render_surface (the same tracer through the facade: the Image frame is
bit-equal to it). Volume frames through the api: bit-equal to the port's
render_volume / trace_volume_domain of the same bricks, and within 1e-5 of
JAX's api frame.

JAX runs on the 8 virtual CPU devices of tests/conftest.py, so its Domain
arms use 8 members; the port's get LocalGroup(8). JAX's frames are
committed; refresh them by hand with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/test_torch_api.py --write-golden
"""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.core.context import RenderContext as JaxContext

from gravit_tpu_torch import api, gvt
from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.examples import (amr_app, conf_app, file_load_app,
                                       simple_app, vol_app)
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render import renderer as rmod
from gravit_tpu_torch.render.renderer import (Renderer, render_surface,
                                              render_volume)
from gravit_tpu_torch.render.tracer import make_arena
from gravit_tpu_torch.render.volume_scene import build_volume_scene
from gravit_tpu_torch.render.volume_tracer import (filter_initial,
                                                   slice_axes_for)
from gravit_tpu_torch.schedule import volume_domain as vd
from gravit_tpu_torch.scene.image import read_ppm, to_rgb8
from gravit_tpu_torch.scene.volume import wavelet_volume

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "data" / "torch_port_api_golden.npz"
FILM = 32
SCHEDULES = {"image": int(api.Schedule.Image),
             "domain": int(api.Schedule.Domain)}
VOL_CAM = dict(eye=(64.0, 64.0, 64.0), focus=(7.5, 7.5, 7.5), film=16)
VD_CAM = dict(eye=(128.0, 128.0, 128.0), focus=(15.5, 15.5, 15.5), film=24)


def members(n):
    return global_mesh(("domains",), (n,), device="cpu")


def frame(name):
    return Renderer.instance().framebuffer(name)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(autouse=True)
def fresh_renderer():
    Renderer.reset()
    yield
    Renderer.reset()
    RenderContext.reset()


def simple_surface():
    """SimpleApp's scene as the api builds it, straight to render_surface
    (the reference of tests/test_api.py, the port's own tracer)."""
    db = RenderContext.instance()
    meshes, instances, lights = Renderer()._surface_scene(db)
    cam = Renderer()._camera(db, "conecam", "conefilm")
    return render_surface(meshes, instances, lights, cam, device="cpu")


@pytest.mark.parametrize("sched,tol", [("image", 1e-6), ("domain", 1e-5)])
def test_api_simple_equal_jax(gold, sched, tol):
    simple_app.build_scene(SCHEDULES[sched], wsize=(FILM, FILM),
                           mesh=members(8))
    api.render("Enzoschedule")
    fb = frame("Enzoschedule")
    ref = simple_surface()
    assert float((fb - ref).abs().max()) < tol
    if sched == "image":
        assert torch.equal(fb, ref)
    assert float(np.abs(fb.numpy() - gold[f"simple_{sched}"]).max()) < tol
    assert tp.lit(fb) > 0.05


@pytest.mark.parametrize("depth", [1, 2])
def test_api_flagship_equal_render_surface(depth):
    """chip_smoke's facade_flagship at a CPU size (24-band sphere, 1,154
    triangles: the BVH path; 32^2): the scene built through the api renders
    the frame render_surface renders from make_scene's meshes, bit for
    bit."""
    spec = chip_smoke.api_flagship(0, bands=24, width=FILM, height=FILM,
                                   depth=depth, device="cpu")
    assert spec.meshes[0].num_triangles >= rmod.BVH_MIN_TRIANGLES
    fb = chip_smoke.api_frame("flagship")
    assert torch.equal(fb, render_surface(spec.meshes, spec.instances,
                                          spec.lights, spec.camera,
                                          device="cpu"))
    assert tp.lit(fb) > 0.3


def test_writeimage_read_ppm(tmp_path):
    simple_app.build_scene(SCHEDULES["image"], wsize=(FILM, 24),
                           device="cpu")
    api.render("Enzoschedule")
    out = tmp_path / "simple"
    api.writeimage("Enzoschedule", str(out))
    img = read_ppm(str(out) + ".ppm")
    assert img.shape == (24, FILM, 3) and img.sum() > 0
    np.testing.assert_array_equal(img, to_rgb8(frame("Enzoschedule"),
                                               FILM, 24))
    # the film's output path, with ".ppm" added
    api.modifyFilm("conefilm", FILM, 24, str(tmp_path / "film_out"))
    api.render("Enzoschedule")
    assert Renderer.instance().write_image("Enzoschedule") == \
        str(tmp_path / "film_out.ppm")
    with pytest.raises(ValueError, match="not a binary PPM"):
        (tmp_path / "bad.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
        read_ppm(str(tmp_path / "bad.ppm"))


def test_api_volume_render_equal_jax(gold):
    """tests/test_api.py::test_api_volume_render: one 16^3 wavelet brick
    under the Domain schedule with one member: the single-device arm,
    render_volume's frame."""
    vol = wavelet_volume(16)
    api.gvtInit(device="cpu")
    tp.api_volume_bricks(api, [vol], VOL_CAM["eye"], VOL_CAM["focus"],
                         VOL_CAM["film"], SCHEDULES["domain"])
    api.render("vr")
    fb = frame("vr")
    cam = Renderer()._camera(RenderContext.instance(), "cam", "film")
    assert torch.equal(fb, render_volume([vol], [(0, np.eye(4))], cam,
                                         device="cpu"))
    assert bool(torch.isfinite(fb).all()) and float(fb[:, :3].sum()) > 0
    assert float(np.abs(fb.numpy() - gold["volume"]).max()) < 1e-5


def test_api_volume_domain_equal_jax(gold, monkeypatch):
    """tests/test_api.py::test_api_volume_domain_multidevice: two x-bricks
    of the 32^3 wavelet under the Domain schedule over 8 members take the
    volume domain scheduler, with the slice axes of the stacked scene."""
    bricks, _ = tp.bricked_wavelet(32)
    api.gvtInit(mesh=members(8))
    tp.api_volume_bricks(api, bricks, VD_CAM["eye"], VD_CAM["focus"],
                         VD_CAM["film"], SCHEDULES["domain"])
    calls, orig = [], rmod.trace_volume_domain

    def spy(*args, **kw):
        calls.append(kw["slice_axes"])
        return orig(*args, **kw)

    monkeypatch.setattr(rmod, "trace_volume_domain", spy)
    api.render("vr")
    fb = frame("vr")
    assert len(calls) == 1 and all(a is not None for a in calls[0])
    cam = Renderer()._camera(RenderContext.instance(), "cam", "film")
    eye4 = np.eye(4, dtype=np.float32)
    stacked, owners = vd.partition_volume_scene(
        bricks, [(0, eye4), (1, eye4)], 8, device="cpu")
    rays = cam.generate_rays("cpu", volume=True)
    ref = vd.trace_volume_domain(
        stacked, owners, make_arena(rays, 0), 24, 24, members(8),
        slice_axes=slice_axes_for(stacked, rays.direction))
    assert torch.equal(fb, ref)
    assert float(fb[:, :3].sum()) > 0
    assert float(np.abs(fb.numpy() - gold["volume_domain"]).max()) < 1e-5


def test_api_volume_domain_regrows_a_crowded_member():
    """The volume Domain arm over 8 members, looking down the x axis at the
    two x-bricks: brick 0 is the first brick of most of the 64^2 rays, more
    than its member's compacted share (C / 8 * 2 = 1,024 lanes) holds. The
    arm renders again at Regrow's slack and capacity until nothing drops:
    the frame is the single-device render_volume's."""
    bricks, _ = tp.bricked_wavelet(32)
    eye, focus, film = (-60.0, 15.5, 15.5), (15.5, 15.5, 15.5), 64
    api.gvtInit(mesh=members(8))
    tp.api_volume_bricks(api, bricks, eye, focus, film, SCHEDULES["domain"])
    cam = Renderer()._camera(RenderContext.instance(), "cam", "film")
    eye4 = np.eye(4, dtype=np.float32)
    instances = [(0, eye4), (1, eye4)]
    scene = build_volume_scene(bricks, instances, device="cpu")
    first = filter_initial(scene, make_arena(
        cam.generate_rays("cpu", volume=True), 0))
    assert int((first.active & (first.inst == 0)).sum()) >= 1536
    api.render("vr")
    fb = frame("vr")
    single = render_volume(bricks, instances, cam, device="cpu")
    assert float((fb - single).abs().max()) <= 1e-5
    assert float(fb[:, :3].sum()) > 0


def test_api_volume_domain_raises_after_max_grows(monkeypatch):
    """A volume Domain frame that still drops rays after Regrow's three
    grows raises (tests/test_torch_domain_sched.py::
    test_render_raises_after_max_grows for the surface arm): every try
    forced to an exchange capacity of one ray."""
    bricks, _ = tp.bricked_wavelet(32)
    api.gvtInit(mesh=members(8))
    tp.api_volume_bricks(api, bricks, VD_CAM["eye"], VD_CAM["focus"],
                         VD_CAM["film"], SCHEDULES["domain"])
    tries, orig = [], rmod.trace_volume_domain

    def spy(*args, **kw):
        tries.append((kw["exchange_cap"], kw["local_slack"]))
        kw["exchange_cap"] = 1
        return orig(*args, **kw)

    monkeypatch.setattr(rmod, "trace_volume_domain", spy)
    with pytest.raises(RuntimeError, match="still dropping"):
        api.render("vr")
    # the capacity stops at the arena's 1,024 lanes, the slack at 8 members
    assert tries == [(1024, 2.0), (1024, 4.0), (1024, 8.0), (1024, 8.0)]


def test_member_count_from_the_layout(monkeypatch):
    """The Domain schedule with one member (the default layout of one
    process) takes the single-device arm, never DomainRenderer; with two
    it takes DomainRenderer without an accel; the scheduler enum the
    facade shards on is api's Domain and AsyncDomain."""
    assert rmod.DOMAIN_SCHEDULES == (int(api.Schedule.Domain),
                                     int(api.Schedule.AsyncDomain))
    built, orig = [], rmod.DomainRenderer.build

    def spy(*args, **kw):
        dr = orig(*args, **kw)
        built.append(dr)
        return dr

    monkeypatch.setattr(rmod.DomainRenderer, "build", spy)
    simple_app.build_scene(SCHEDULES["domain"], wsize=(16, 16),
                           device="cpu")
    api.render("Enzoschedule")
    assert not built
    one = frame("Enzoschedule")
    assert torch.equal(one, simple_surface())
    Renderer.reset()
    simple_app.build_scene(int(api.Schedule.AsyncDomain), wsize=(16, 16),
                           mesh=members(2))
    api.render("Enzoschedule")
    assert len(built) == 1 and built[0].accel is None
    assert built[0].mesh.shape == {"domains": 2}
    assert float((frame("Enzoschedule") - one).abs().max()) < 1e-5
    # a Renderer's own layout wins over the database's
    r = Renderer(mesh=members(3))
    assert r.layout(RenderContext.instance())[0].size == 3
    with pytest.raises(ValueError, match="one-axis"):
        Renderer(mesh=global_mesh(("domains", "rays"), (2, 2),
                                  device="cpu")).layout(
            RenderContext.instance())


def test_max_depth_zero_raises():
    simple_app.build_scene(SCHEDULES["image"], wsize=(16, 16),
                           device="cpu")
    api.modifyCamera("conecam", [4.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0], 0.8, depth=0)
    with pytest.raises(NotImplementedError, match="max_depth"):
        api.render("Enzoschedule")


def test_no_card_raises_unless_told(monkeypatch):
    """With no layout and no device the facade asks for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    simple_app.build_scene(SCHEDULES["image"], wsize=(16, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.render("Enzoschedule")


def test_render_context_equal_jax():
    """find, create, group and sync behave as the JAX package's database:
    the same groups, the same nodes found, the dirty flags cleared."""
    dbs = []
    for ctx in (RenderContext, JaxContext):
        ctx.reset()
        db = ctx.instance()
        node = db.create("Data", "Mesh", "m")
        node["file"] = "m.obj"
        db.create("Lights", "PointLight", "l")["color"] = (1.0, 1.0, 1.0)
        assert db.find("m") is node and db.find("missing") is None
        assert db.find("l").type == "PointLight" and node.dirty
        db.sync()
        assert not node.dirty and not db.root.dirty
        assert db.group("Data").children["m"].get("file") == "m.obj"
        dbs.append(sorted((g, sorted(db.group(g).children))
                          for g in db.root.children))
        assert ctx.instance() is db
        ctx.reset()
        assert ctx.instance() is not db
    assert dbs[0] == dbs[1]


def test_gvt_names_equal_the_root_shim():
    import gvt as root_gvt

    names = {n for n in dir(gvt) if not n.startswith("_")}
    assert names == {n for n in dir(root_gvt) if not n.startswith("_")}
    gvt.gvtInit(device="cpu")
    gvt.createMesh("m")
    gvt.addMeshMaterialSpecular("m", 1, [1.0, 0.5, 0.5], [0.2] * 3, 8.0)
    mat = api._db().find("m")["ptr"].material
    assert (mat.type, mat.alpha) == (1, 8.0)


@pytest.mark.parametrize("sched", ["image", "domain"])
def test_vol_app_and_amr_app_build_scene(sched):
    """The ported apps' build_scene on generated data (the wavelet volume,
    the synthetic AMR tree) renders through the api, equal to
    render_volume of the same volumes (one member: the single-device
    arm)."""
    bricks = vol_app.load_bricks()
    vol_app.build_scene(bricks, SCHEDULES[sched], wsize=(16, 16),
                        device="cpu")
    api.render("vr")
    cam = Renderer()._camera(RenderContext.instance(), "cam", "film")
    assert torch.equal(frame("vr"), render_volume(
        bricks, [(0, np.eye(4))], cam, device="cpu"))
    assert amr_app.build_scene(SCHEDULES[sched], wsize=(16, 16),
                               device="cpu") == 1
    api.render("amr")
    # the facade attaches the node's subgrids to a copy of its Volume and
    # writes nothing into the database's
    assert api._db().find("amrvol0")["ptr"].subgrids == []
    (vol,), _ = Renderer()._volume_scene(RenderContext.instance())
    assert len(vol.subgrids) == 1 and vol.subgrids[0].level == 1
    cam = Renderer()._camera(RenderContext.instance(), "conecam", "conefilm")
    fb = frame("amr")
    assert torch.equal(fb, render_volume([vol], [(0, np.eye(4))], cam,
                                         device="cpu"))
    assert float(fb[:, :3].sum()) > 0


def _write_cube_obj(tmp_path):
    """SimpleApp's cube scaled to 0.1 at (0, 0.1, 0): in front of
    file_load_app's default camera and under its light."""
    spec = chip_smoke.cube_mesh()
    verts = np.reshape(chip_smoke.CUBE_VERTS, (-1, 3)) * 0.1 + [0, 0.1, 0]
    faces = np.reshape(chip_smoke.CUBE_FACES, (-1, 3))
    assert spec.num_triangles == len(faces)
    (tmp_path / "cube.obj").write_text(
        "".join(f"v {x} {y} {z}\n" for x, y, z in verts)
        + "".join(f"f {a} {b} {c}\n" for a, b, c in faces))
    return str(tmp_path / "cube.obj")


def test_file_load_and_conf_apps_on_written_files(tmp_path):
    """file_load_app and conf_app (both .conf dialects) on files this test
    writes: each renders a lit frame through the api."""
    obj = _write_cube_obj(tmp_path)
    file_load_app.build_scene(obj, SCHEDULES["image"], wsize=(16, 16),
                              device="cpu")
    api.render("r")
    assert tp.lit(frame("r")) > 0.05
    (tmp_path / "r.conf").write_text(
        "16 16\n45.0\n0 0.3 0.3\n0 0.1 0\n0 1 0\nSurface\nImage\n1.0\n"
        "1 1 1\ncube.obj\n")
    assert not conf_app.is_geom_conf(str(tmp_path / "r.conf"))
    conf_app.build_render_conf(str(tmp_path / "r.conf"), "out",
                               device="cpu")
    api.render("r")
    assert tp.lit(frame("r")) > 0.05
    (tmp_path / "g.conf").write_text(
        f"{obj} -0.05 0.05 -0.05 0.05 0.15 0.05\n")
    assert conf_app.is_geom_conf(str(tmp_path / "g.conf"))
    assert conf_app.build_geom_conf(str(tmp_path / "g.conf"), "out",
                                    device="cpu") == 1
    api.modifyFilm("film", 16, 16, "out")
    api.render("r")
    assert tp.lit(frame("r")) > 0.01


def test_apps_import_without_side_effects(monkeypatch):
    """Importing an app parses no arguments and renders nothing."""
    monkeypatch.setattr(sys, "argv", ["app", "-no-such-flag"])
    for name in ("simple_app", "vol_app", "amr_app", "conf_app",
                 "file_load_app", "trace_view_app"):
        mod = importlib.reload(importlib.import_module(
            f"gravit_tpu_torch.examples.{name}"))
        assert callable(mod.main)
    assert RenderContext._instance is None


def write_golden(path=GOLDEN) -> None:
    """JAX's api frames for the tests above (run by hand)."""
    sys.path.insert(0, str(tp.ROOT / "examples"))
    import simple_app as jax_simple_app

    from gravit_tpu import api as japi
    from gravit_tpu.render.renderer import Renderer as JaxRenderer
    from gravit_tpu.scene.volume import wavelet_volume as jax_wavelet

    out = {}
    for sched, code in SCHEDULES.items():
        JaxRenderer.reset()
        jax_simple_app.build_scene(code, wsize=(FILM, FILM))
        japi.render("Enzoschedule")
        out[f"simple_{sched}"] = np.asarray(
            JaxRenderer.instance().framebuffer("Enzoschedule"))
    for key, bricks, cam in (
            ("volume", [jax_wavelet(16)], VOL_CAM),
            ("volume_domain", tp.bricked_wavelet(32)[1], VD_CAM)):
        JaxRenderer.reset()
        japi.gvtInit()
        tp.api_volume_bricks(japi, bricks, cam["eye"], cam["focus"],
                             cam["film"], SCHEDULES["domain"])
        japi.render("vr")
        out[key] = np.asarray(JaxRenderer.instance().framebuffer("vr"))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
