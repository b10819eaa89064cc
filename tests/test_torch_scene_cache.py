"""The facade's scene cache (render/renderer.py: Renderer keeps its last
single-device surface build while the database's SceneKey holds) and the
mesh revision it keys on (scene/mesh.py), on the CPU.

Reuse: N camera-only api frames of SimpleApp (brute intersection) and of a
1,154-triangle mesh (the BVH branch) record one `facade.scene_build` span
and N - 1 `facade.scene_reused` spans, each frame bit-equal to a fresh
Renderer's at the same pose. Invalidation: every way of editing the
database between two renders builds once more, and the frame after the
edit is bit-equal to a fresh Renderer's; a caller writing into the array it
handed to addMeshVertices changes nothing. Renderer.reset() drops the kept
build; render_surface and the domain arm build on every call. The mesh
revision grows with every edit and not with compile(), finish() or
compute_bounding_box().
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from gravit_tpu_torch import api
from gravit_tpu_torch.core import timing
from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.examples import simple_app
from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render.renderer import Renderer, render_surface
from gravit_tpu_torch.scene.material import Material
from gravit_tpu_torch.scene.mesh import Mesh

torch.set_num_threads(2)

FILM = 32
FRAMES = 4
BUILD, REUSED = "facade.scene_build", "facade.scene_reused"


@pytest.fixture(autouse=True)
def fresh():
    timing.clear()
    Renderer.reset()
    yield
    timing.clear()
    Renderer.reset()
    RenderContext.reset()


def render(name):
    """api.render(name) under recording(): (its frame, {span: count})."""
    with timing.recording() as rec:
        api.render(name)
    names = [s.name for s in rec.spans()]
    return (Renderer.instance().framebuffer(name),
            {BUILD: names.count(BUILD), REUSED: names.count(REUSED)})


def fresh_frame(name):
    """The frame a new Renderer renders from the database as it stands."""
    r = Renderer()
    r.render(name)
    return r.framebuffer(name)


def simple():
    simple_app.build_scene(int(api.Schedule.Image), wsize=(FILM, FILM),
                           device="cpu")
    return "Enzoschedule", "conecam", ([4.0, 0.0, 0.0], [0.0, 0.0, 0.0])


def flagship():
    spec = chip_smoke.api_flagship(0, bands=24, width=FILM, height=FILM,
                                   device="cpu")
    assert spec.meshes[0].num_triangles >= 512
    cam = spec.camera
    return "flagship", "cam", (list(cam.eye), list(cam.focus))


@pytest.mark.parametrize("scene", [simple, flagship])
def test_camera_only_frames_reuse_the_build(scene):
    name, cam, (eye, focus) = scene()
    seen = {BUILD: 0, REUSED: 0}
    frames = []
    for k in range(FRAMES):
        pose = [eye[0] + 0.05 * k, eye[1] + 0.02 * k, eye[2] - 0.03 * k]
        api.modifyCamera(cam, pose, focus, [0.0, 1.0, 0.0],
                         45.0 * math.pi / 180.0)
        fb, counts = render(name)
        for key in seen:
            seen[key] += counts[key]
        assert torch.equal(fb, fresh_frame(name)), k
        frames.append(fb)
    assert seen == {BUILD: 1, REUSED: FRAMES - 1}
    assert not torch.equal(frames[0], frames[-1])     # the camera moved


# -- invalidation: a small scene, edited between two renders ---------------

CONE_V = np.asarray(simple_app.CONE_VERTS, np.float32)
CUBE_V = np.asarray(simple_app.CUBE_VERTS, np.float32)
# a square facing the camera (tilted: its box is not flat), left
# unfinished (no normals) so that the normal, colour and finish edits show
QUAD_V = [0.0, -1.0, -1.0, 0.0, 1.0, -1.0, -0.2, 1.0, 1.0, -0.2, -1.0, 1.0]
QUAD_F = [1, 2, 3, 1, 3, 4]


def placed(t, s):
    """A column-major 4x4 (glm::value_ptr's layout): translate t, scale s."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= s
    m[:3, 3] = t
    return m.T.ravel()


def small_scene():
    """Cone and cube (finished) in front of a large unfinished quad, one
    point light, renderer "r". Returns the quad's vertex buffer, which
    the caller keeps."""
    api.gvtInit(device="cpu")
    api.createMesh("cone")
    api.addMeshVertices("cone", 7, CONE_V)
    api.addMeshTriangles("cone", 6, simple_app.CONE_FACES)
    api.addMeshMaterial("cone", 0, [1.0, 1.0, 1.0], 1.0)
    api.finishMesh("cone")
    api.createMesh("cube")
    api.addMeshVertices("cube", 24, CUBE_V)
    api.addMeshTriangles("cube", 12, simple_app.CUBE_FACES)
    api.addMeshMaterial("cube", 0, [0.8, 0.8, 0.3], 1.0)
    api.finishMesh("cube")
    quad_v = np.asarray(QUAD_V, np.float32)
    api.createMesh("quad")
    api.addMeshVertices("quad", 4, quad_v)
    api.addMeshTriangles("quad", 2, QUAD_F)
    api.addInstance("i0", "cone", placed((0.0, 0.5, 0.5), 0.6))
    api.addInstance("i1", "cube", placed((0.0, -0.5, -0.5), 0.6))
    api.addInstance("i2", "quad", placed((-1.0, 0.0, 0.0), 1.5))
    api.addPointLight("light", [1.0, 0.0, -1.0], [1.0, 1.0, 1.0])
    api.addCamera("cam", [4.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  45.0 * math.pi / 180.0, 1, 1, 0.5)
    api.addFilm("film", FILM, FILM)
    api.addRenderer("r", int(api.Adapter.Embree), int(api.Schedule.Image),
                    "cam", "film")
    return quad_v


def ptr(name):
    return api._db().find(name)["ptr"]


def _vertices_and_triangles(buf):
    api.addMeshVertices("quad", 3, [0.0, 1.0, -0.3, 0.0, 1.3, 0.0,
                                    0.0, 1.0, 0.3])
    api.addMeshTriangles("quad", 1, [5, 7, 6])


def _face_normals(buf):
    api.addMeshFaceNormals("quad", 2, [-1.0, 0.0, 0.0] * 2)


def _vertex_normals(buf):
    n = np.asarray([1.0, 0.6, 0.0], np.float32)
    api.addMeshVertexNormals("quad", 4, np.tile(n / np.linalg.norm(n), 4))


def _material(buf):
    api.addMeshMaterial("quad", 0, [1.0, 0.2, 0.2], 1.0)


def _materials(buf):
    api.addMeshMaterials("quad", 2, [0, 0], [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                         [[0.5] * 3] * 2, [1.0, 1.0])


def _vertex_color(buf):
    api.addMeshVertexColor("quad", 4, [1.0, 0.0, 0.0, 0.0, 1.0, 0.0,
                                       0.0, 0.0, 1.0, 1.0, 1.0, 0.0])


def _finish(buf):
    api.finishMesh("quad")


def _second_mesh(buf):
    api.createMesh("extra")
    api.addMeshVertices("extra", 7, CONE_V)
    api.addMeshTriangles("extra", 6, simple_app.CONE_FACES)
    api.finishMesh("extra")


def _instance(buf):
    api.addInstance("i3", "cone", placed((1.0, 0.0, 0.0), 0.5))


def _point_light(buf):
    api.addPointLight("light2", [2.0, 1.0, 1.0], [0.5, 0.5, 0.5])


def _area_light(buf):
    api.addAreaLight("light2", [2.0, 1.0, 1.0], [0.5, 0.5, 0.5],
                     [-1.0, 0.0, 0.0], 0.5, 0.5)


def _modify_light(buf):
    api.modifyLight("light", [1.0, 0.0, -1.0], [1.0, 1.0, 1.0],
                    [-1.0, 0.0, 1.0], 0.8, 0.8)


def _replace_ptr(buf):
    m = Mesh()
    m.add_vertices(np.asarray(QUAD_V, np.float32) * 0.5)
    m.add_faces(np.asarray(QUAD_F))
    api._db().find("quad")["ptr"] = m


def _replace_ptr_equal(buf):
    m = Mesh()
    m.add_vertices(np.asarray(QUAD_V, np.float32))
    m.add_faces(np.asarray(QUAD_F))
    api._db().find("quad")["ptr"] = m


def _append_extend(buf):
    m = ptr("quad")
    m.vertices.append(np.asarray([0.0, 0.0, 1.5], np.float32))
    m.faces.extend([(3, 2, 4)])


def _iadd(buf):
    m = ptr("quad")
    m.vertices += [np.asarray([0.0, 0.0, 1.5], np.float32)]
    m.faces += [(3, 2, 4)]


def _item_assignment(buf):
    ptr("quad").vertices[0] = np.asarray([0.0, -1.3, -1.3], np.float32)


def _delete(buf):
    del ptr("quad").faces[1]


def _field_assignment(buf):
    ptr("quad").material = Material(kd=(0.2, 0.2, 1.0))


def _caller_writes_its_buffer(buf):
    buf += 0.3


# (edit, builds it causes, whether the frame changes)
EDITS = {
    "addMeshVertices+addMeshTriangles": (_vertices_and_triangles, 1, True),
    "addMeshFaceNormals": (_face_normals, 1, True),
    "addMeshVertexNormals": (_vertex_normals, 1, True),
    "addMeshMaterial": (_material, 1, True),
    "addMeshMaterials": (_materials, 1, True),
    "addMeshVertexColor": (_vertex_color, 1, True),
    "finishMesh": (_finish, 1, True),        # vertex normals, rounded apart
    "second_createMesh": (_second_mesh, 1, False),     # no instance of it
    "addInstance": (_instance, 1, True),
    "addPointLight": (_point_light, 1, True),
    "addAreaLight": (_area_light, 1, True),
    "modifyLight_point_to_area": (_modify_light, 1, True),
    "replace_ptr": (_replace_ptr, 1, True),
    "replace_ptr_equal_mesh": (_replace_ptr_equal, 1, False),
    "vertices.append+faces.extend": (_append_extend, 1, True),
    "+=": (_iadd, 1, True),
    "item_assignment": (_item_assignment, 1, True),
    "del": (_delete, 1, True),
    "field_assignment": (_field_assignment, 1, True),
    "caller_writes_its_buffer": (_caller_writes_its_buffer, 0, False),
}


@pytest.mark.parametrize("edit", list(EDITS))
def test_an_edit_between_renders_rebuilds(edit):
    change, builds, changes = EDITS[edit]
    buf = small_scene()
    before, counts = render("r")
    assert counts == {BUILD: 1, REUSED: 0}
    assert torch.equal(before, fresh_frame("r"))
    change(buf)
    after, counts = render("r")
    assert counts == {BUILD: builds, REUSED: 1 - builds}
    assert torch.equal(after, fresh_frame("r"))
    assert torch.equal(after, before) != changes
    # and the next camera-only frame reuses the new build
    _, counts = render("r")
    assert counts == {BUILD: 0, REUSED: 1}


def test_another_mesh_of_the_same_revision_rebuilds():
    """A Mesh that shares every list with the rendered one reads the same
    revision once the lists are edited; the key tells them apart by
    object."""
    small_scene()
    quad = ptr("quad")
    red = Mesh(material=Material(kd=(1.0, 0.0, 0.0)))
    for field in ("vertices", "faces", "normals", "face_normals",
                  "vertex_colors", "face_materials"):
        setattr(red, field, getattr(quad, field))
    quad.vertices.append(np.zeros(3, np.float32))   # no face uses it
    assert red.revision == quad.revision
    before, _ = render("r")
    api._db().find("quad")["ptr"] = red
    after, counts = render("r")
    assert counts == {BUILD: 1, REUSED: 0}
    assert torch.equal(after, fresh_frame("r"))
    assert not torch.equal(after, before)


def test_reset_drops_the_kept_build():
    small_scene()
    render("r")
    kept = Renderer.instance()
    assert kept.scene_build is not None
    Renderer.reset()
    assert kept.scene_build is None
    _, counts = render("r")
    assert counts == {BUILD: 1, REUSED: 0}


def test_render_surface_and_the_domain_arm_build_every_call():
    name, _, _ = simple()
    db = RenderContext.instance()
    r = Renderer()
    meshes, instances, lights = r._surface_scene(db)
    cam = r._camera(db, "conecam", "conefilm")
    with timing.recording() as rec:
        render_surface(meshes, instances, lights, cam, device="cpu")
        render_surface(meshes, instances, lights, cam, device="cpu")
    names = [s.name for s in rec.spans()]
    assert names.count("facade.build_scene") == 2
    api.modifyRenderer(name, int(api.Adapter.Embree),
                       int(api.Schedule.Domain), "conecam", "conefilm")
    two = Renderer(mesh=global_mesh(("domains",), (2,), device="cpu"))
    with timing.recording() as rec:
        two.render(name)
        two.render(name)
    names = [s.name for s in rec.spans()]
    assert names.count("facade.compile_meshes") == 2
    assert BUILD not in names and REUSED not in names
    assert two.scene_build is None


# -- the mesh revision -----------------------------------------------------

def a_mesh():
    m = Mesh()
    m.add_vertices(np.asarray(QUAD_V, np.float32))
    m.add_faces(np.asarray(QUAD_F))
    return m


ROW = np.zeros(3, np.float32)
MESH_EDITS = {
    "add_vertices": lambda m: m.add_vertices(np.ones((1, 3), np.float32)),
    "add_faces": lambda m: m.add_faces(np.asarray([1, 2, 4])),
    "generate_normals": lambda m: m.generate_normals(),
    "finish_with_normals": lambda m: m.finish(),
    "assign_material": lambda m: setattr(m, "material", Material()),
    "assign_list": lambda m: setattr(m, "faces", [(0, 1, 2)]),
    "assign_bounds": lambda m: setattr(m, "bounds_min", ROW),
    "append": lambda m: m.vertices.append(ROW),
    "extend": lambda m: m.faces.extend([(0, 1, 2)]),
    "insert": lambda m: m.faces.insert(0, (0, 1, 2)),
    "item": lambda m: m.vertices.__setitem__(0, ROW),
    "slice": lambda m: m.faces.__setitem__(slice(0, 1), [(0, 1, 2)]),
    "del": lambda m: m.faces.__delitem__(0),
    "pop": lambda m: m.faces.pop(),
    "clear": lambda m: m.face_normals.clear(),
    "remove": lambda m: m.faces.remove(m.faces[0]),
    "sort": lambda m: m.faces.sort(reverse=True),
    "reverse": lambda m: m.faces.reverse(),
    "iadd": lambda m: m.normals.__iadd__([ROW]),
    "imul": lambda m: m.vertex_colors.__imul__(2),
}


@pytest.mark.parametrize("edit", list(MESH_EDITS))
def test_every_edit_grows_the_revision(edit):
    m = a_mesh()
    r0 = m.revision
    MESH_EDITS[edit](m)
    assert m.revision > r0


def test_derived_data_is_no_edit():
    m = a_mesh()
    m.finish()               # the first finish generates normals: an edit
    r0 = m.revision
    m.compile()
    m.finish()
    m.compute_bounding_box()
    m.generate_normals()     # already there: returns at once
    assert m.revision == r0
    assert m.bounds_min is not None


def test_lists_are_the_meshs_own():
    """Assigning a plain list stores a copy; a list shared with another
    mesh stays shared, and an edit through it grows both revisions."""
    m, other = a_mesh(), a_mesh()
    plain = [(0, 1, 2)]
    m.faces = plain
    plain.append((0, 2, 3))
    assert list(m.faces) == [(0, 1, 2)]
    other.vertices = m.vertices
    r_m, r_o = m.revision, other.revision
    m.vertices.append(ROW)
    assert m.revision > r_m and other.revision > r_o


def test_add_methods_copy_their_input():
    want = np.asarray(QUAD_V, np.float32).reshape(-1, 3)
    buf = want.copy()
    m = Mesh()
    m.add_vertices(buf)
    buf += 1.0
    np.testing.assert_array_equal(np.asarray(m.vertices), want)


COPIES = {
    "addMeshVertices": (lambda b: api.addMeshVertices("quad", 2, b),
                        lambda: ptr("quad").vertices[-2:]),
    "addMeshFaceNormals": (lambda b: api.addMeshFaceNormals("quad", 2, b),
                           lambda: ptr("quad").face_normals[-2:]),
    "addMeshVertexNormals": (lambda b: api.addMeshVertexNormals("quad", 2, b),
                             lambda: ptr("quad").normals[-2:]),
    "addMeshVertexColor": (lambda b: api.addMeshVertexColor("quad", 2, b),
                           lambda: ptr("quad").vertex_colors[-2:]),
    "addInstance": (lambda b: api.addInstance("i3", "cone", b),
                    lambda: api._db().find("i3")["mat"]),
}


@pytest.mark.parametrize("call", list(COPIES))
def test_the_api_copies_the_callers_array(call):
    """What the database holds does not change when the caller writes
    into the float32 array it handed over."""
    small_scene()
    give, held = COPIES[call]
    buf = np.linspace(0.1, 0.6, 16 if call == "addInstance" else 6
                      ).astype(np.float32)
    give(buf)
    want = np.array(held(), np.float32)
    buf += 1.0
    np.testing.assert_array_equal(np.array(held(), np.float32), want)
