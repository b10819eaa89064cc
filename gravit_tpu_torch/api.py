"""Public API, counterpart of gravit_tpu/api.py: GraviT's ~30-function C
API (render/api/api.h).

A user of the reference drives scenes through `api::gvtInit/createMesh/...`;
every one of those entry points exists here with the same name, argument
order and semantics (cited per function). State lives in the RenderContext
scene database; `render()` compiles it into tensors on the card and runs
the requested scheduler over the layout's members (render/renderer.py),
reusing the last surface or volume build while the database's scene is
unchanged.
The mesh functions, addInstance, addVolumeSamples and addAmrSubgrid copy
the arrays they are handed (as Mesh.cpp's push_back does), so a caller may
reuse its buffer; a volume's copies are read-only.

Differences by design:
  - no MPI: `gvtsync()` is a replication no-op (every process builds the
    same database)
  - adapters: every surface adapter enum maps to the port's tracers (the
    traversal kernel for meshes of 512 triangles or more); ospray/pvol map
    to the volume integrator
  - `addRenderer(..., schedule=Domain)` shards domains over the members of
    the layout and migrates rays with all_to_all
  - `gvtInit(..., mesh=, device=)` names the layout (a parallel.Mesh) or
    the device of the default one, parallel.global_mesh(); the JAX package
    takes every jax device instead
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from gravit_tpu_torch.core.context import RenderContext
from gravit_tpu_torch.render.renderer import Renderer
from gravit_tpu_torch.scene.material import Material
from gravit_tpu_torch.scene.mesh import Mesh
from gravit_tpu_torch.scene.tessellate import convex_hull, delaunay_2_5d
from gravit_tpu_torch.scene.transfer import TransferFunction
from gravit_tpu_torch.scene.volume import Volume


class Adapter(enum.IntEnum):
    """render/Types.h:33-45 (Volume only when GVT_BUILD_VOLUME)."""

    Volume = 0
    Surface = 1
    Manta = 2
    Optix = 3
    Embree = 4
    Ospray = 5
    Pvol = 6
    EmbreeStream = 7
    Heterogeneous = 8


class Schedule(enum.IntEnum):
    """render/Types.h:50-60."""

    Image = 0
    Domain = 1
    AsyncImage = 2
    AsyncDomain = 3
    RayWeightedSpread = 4
    LoadOnce = 5
    LoadAnyOnce = 6
    LoadAnother = 7
    LoadMany = 8


def _db() -> RenderContext:
    return RenderContext.instance()


def gvtInit(argc: int = 0, argv=None, threads: Optional[int] = None,
            mesh=None, device=None) -> None:
    """api.cpp:76-102 (MPI_Init + context creation). Resets the context.
    `mesh` (a parallel.Mesh with one axis) is the layout render() runs
    over; without it, parallel.global_mesh() on `device` (None: the
    card)."""
    RenderContext.reset()
    db = _db()
    db.root["threads"] = threads or 1
    db.root["mesh"] = mesh
    db.root["device"] = device


# --------------------------------------------------------------------------
# meshes (api.cpp:116-281)

def createMesh(name: str) -> None:
    db = _db()
    n = db.create("Data", "Mesh", name)
    n["file"] = name
    n["ptr"] = Mesh()


def addMeshVertices(name: str, n: int, vertices, tessellate: bool = False,
                    qhullargs: str = "") -> None:
    m: Mesh = _db().find(name)["ptr"]
    verts = np.asarray(vertices, np.float32).reshape(-1, 3)[:n]
    m.add_vertices(verts)
    if tessellate:
        _tessellate(m, verts, qhullargs)


def _tessellate(m: Mesh, verts: np.ndarray, qhullargs: str) -> None:
    """Tessellate the point cloud (the qhull path, api.cpp:143-170).

    "d"-style args use 2.5D Delaunay (terrain clouds, the TessApp case);
    otherwise the convex hull. Triangles land 0-based directly (the
    reference pushes qhull facets via addFace with +1, api.cpp:162-165).
    """
    if "d" in (qhullargs or "d Qz").split():
        tris = delaunay_2_5d(verts)
    else:
        tris = convex_hull(verts)
    m.faces.extend(tuple(int(i) for i in t) for t in tris)


def addMeshTriangles(name: str, n: int, triangles) -> None:
    m: Mesh = _db().find(name)["ptr"]
    tris = np.asarray(triangles, np.int64).reshape(-1, 3)[:n]
    m.add_faces(tris)  # 1-based, degenerate-dropping (Mesh.cpp:103-110)


def addMeshFaceNormals(name: str, n: int, normals) -> None:
    m: Mesh = _db().find(name)["ptr"]
    fn = np.array(normals, np.float32).reshape(-1, 3)[:n]
    m.face_normals.extend(fn)


def addMeshVertexNormals(name: str, n: int, normals) -> None:
    m: Mesh = _db().find(name)["ptr"]
    vn = np.array(normals, np.float32).reshape(-1, 3)[:n]
    m.normals.extend(vn)
    if len(m.normals) == len(m.vertices):
        m.have_normals = True


def finishMesh(name: str, compute_normal: bool = True) -> None:
    node = _db().find(name)
    m: Mesh = node["ptr"]
    m.compute_bounding_box()
    if compute_normal:
        m.generate_normals()
    node["bbox"] = (m.bounds_min, m.bounds_max)
    node["Locations"] = [0]


def addMeshMaterial(name: str, mattype: int, kd, ks_or_alpha=1.0,
                    alpha: float = 1.0) -> None:
    """Covers both overloads (api.cpp:228-255): (type, kd, alpha) and
    (type, kd, ks, alpha)."""
    m: Mesh = _db().find(name)["ptr"]
    if np.ndim(ks_or_alpha) == 0:
        m.material = Material(type=int(mattype),
                              kd=tuple(np.asarray(kd, np.float32)),
                              alpha=float(ks_or_alpha))
    else:
        m.material = Material(type=int(mattype),
                              kd=tuple(np.asarray(kd, np.float32)),
                              ks=tuple(np.asarray(ks_or_alpha, np.float32)),
                              alpha=float(alpha))


def addMeshMaterials(name: str, n: int, mattype, kd, ks, alpha) -> None:
    m: Mesh = _db().find(name)["ptr"]
    mattype = np.asarray(mattype).reshape(-1)
    kd = np.asarray(kd, np.float32).reshape(-1, 3)
    ks = np.asarray(ks, np.float32).reshape(-1, 3)
    alpha = np.asarray(alpha, np.float32).reshape(-1)
    for i in range(n):
        m.face_materials.append(Material(
            type=int(mattype[i]), kd=tuple(kd[i]), ks=tuple(ks[i]),
            alpha=float(alpha[i])))


def addMeshVertexColor(name: str, n: int, kd) -> None:
    m: Mesh = _db().find(name)["ptr"]
    cols = np.array(kd, np.float32).reshape(-1, 3)[:n]
    m.vertex_colors.extend(cols)


# --------------------------------------------------------------------------
# instances (api.cpp:292-322)

def addInstance(instancename: str, meshname: str, m) -> None:
    """`m` is a 16-float COLUMN-major buffer (glm::make_mat4 layout)."""
    db = _db()
    node = db.create("Instances", "Instance", instancename)
    mat = np.array(m, np.float32).reshape(4, 4).T  # column-major -> rows
    node["meshRef"] = meshname
    node["mat"] = mat
    node["id"] = len(db.group("Instances").children) - 1


# --------------------------------------------------------------------------
# volumes (api.cpp:542-614)

def createVolume(name: str, amr: bool = False) -> None:
    db = _db()
    n = db.create("Data", "Volume", name)
    n["file"] = name
    n["amr"] = amr
    n["ptr"] = None
    n["subgrids"] = []


def addVolumeTransferFunctions(name: str, colortfname: str,
                               opacitytfname: str, low: float,
                               high: float) -> None:
    node = _db().find(name)
    node["tf"] = TransferFunction.from_files(colortfname, opacitytfname,
                                             low, high)


def _owned(values) -> np.ndarray:
    """A read-only float32 copy of `values`: the volume's own (see
    scene/volume.py's editing contract)."""
    out = np.array(values, np.float32)
    out.flags.writeable = False
    return out


def addVolumeSamples(name: str, samples, counts, origin, deltas,
                     samplingrate: float, bounds=None) -> None:
    node = _db().find(name)
    vol = Volume.from_flat(_owned(samples), np.asarray(counts, np.int64),
                           _owned(origin), _owned(deltas),
                           float(samplingrate), tf=node.get("tf"))
    node["ptr"] = vol
    node["bbox"] = (vol.bounds_min, vol.bounds_max)


def addAmrSubgrid(name: str, gridid: int, level: int, samples, counts,
                  origin, deltas) -> None:
    node = _db().find(name)
    sub = Volume.from_flat(_owned(samples), np.asarray(counts, np.int64),
                           _owned(origin), _owned(deltas), 1.0,
                           tf=node.get("tf"))
    sub.level = level
    node["subgrids"].append((gridid, level, sub))


# --------------------------------------------------------------------------
# lights (api.cpp:330-430)

def setVolumeIsovalues(name: str, values) -> None:
    """Extension: Volume::SetIsovalues (Volume.h:132); the reference sets
    this from apps directly, not through api.h."""
    node = _db().find(name)
    node["isovalues"] = tuple(float(v) for v in np.asarray(values).ravel())
    if node["ptr"] is not None:
        node["ptr"].isovalues = node["isovalues"]


def setVolumeSlices(name: str, planes) -> None:
    """Extension: Volume::SetSlices (Volume.h:97) — planes (N, 4)."""
    node = _db().find(name)
    pl = tuple(tuple(float(x) for x in row)
               for row in np.asarray(planes).reshape(-1, 4))
    node["slices"] = pl
    if node["ptr"] is not None:
        node["ptr"].slices = pl


def addPointLight(name: str, pos, color) -> None:
    n = _db().create("Lights", "PointLight", name)
    n["position"] = tuple(np.asarray(pos, np.float32))
    n["color"] = tuple(np.asarray(color, np.float32))


def addAreaLight(name: str, pos, color, normal, w: float, h: float) -> None:
    n = _db().create("Lights", "AreaLight", name)
    n["position"] = tuple(np.asarray(pos, np.float32))
    n["color"] = tuple(np.asarray(color, np.float32))
    n["normal"] = tuple(np.asarray(normal, np.float32))
    n["width"] = float(w)
    n["height"] = float(h)


def modifyLight(name: str, pos, color, normal=None, w: float = None,
                h: float = None) -> None:
    """Both overloads (api.h:166-180); adding a normal turns a PointLight
    into an AreaLight, as the reference documents."""
    node = _db().group("Lights").children.get(name)
    if node is None:
        return
    node["position"] = tuple(np.asarray(pos, np.float32))
    node["color"] = tuple(np.asarray(color, np.float32))
    if normal is not None:
        node.type = "AreaLight"
        node["normal"] = tuple(np.asarray(normal, np.float32))
        node["width"] = float(w)
        node["height"] = float(h)


# --------------------------------------------------------------------------
# camera / film (api.cpp:434-490)

def addCamera(name: str, pos, focus, up, fov: float, depth: int,
              samples: int, jitter: float) -> None:
    n = _db().create("Cameras", "Camera", name)
    n["eyePoint"] = tuple(np.asarray(pos, np.float32))
    n["focus"] = tuple(np.asarray(focus, np.float32))
    n["upVector"] = tuple(np.asarray(up, np.float32))
    n["fov"] = float(fov)
    n["rayMaxDepth"] = int(depth)
    n["raySamples"] = int(samples)
    n["jitterWindowSize"] = float(jitter)


def modifyCamera(name: str, pos, focus, up, fov: float, depth: int = None,
                 samples: int = None, jitter: float = None) -> None:
    node = _db().group("Cameras").children.get(name)
    if node is None:
        return
    node["eyePoint"] = tuple(np.asarray(pos, np.float32))
    node["focus"] = tuple(np.asarray(focus, np.float32))
    node["upVector"] = tuple(np.asarray(up, np.float32))
    node["fov"] = float(fov)
    if depth is not None:
        node["rayMaxDepth"] = int(depth)
    if samples is not None:
        node["raySamples"] = int(samples)
    if jitter is not None:
        node["jitterWindowSize"] = float(jitter)


def addFilm(name: str, w: int, h: int, path: str = "") -> None:
    n = _db().create("Films", "Film", name)
    n["width"] = int(w)
    n["height"] = int(h)
    n["outputPath"] = path


def modifyFilm(name: str, w: int, h: int, path: str = "") -> None:
    node = _db().group("Films").children.get(name)
    if node is None:
        return
    node["width"] = int(w)
    node["height"] = int(h)
    node["outputPath"] = path


# --------------------------------------------------------------------------
# renderer (api.cpp:500-535)

def addRenderer(name: str, adapter: int, schedule: int,
                Camera: str = "Camera", Film: str = "Film",
                volume: bool = False) -> None:
    n = _db().create("Schedulers", "Scheduler", name)
    n["type"] = int(schedule)
    n["adapter"] = int(adapter)
    n["camera"] = Camera
    n["film"] = Film
    n["volume"] = bool(volume)


def modifyRenderer(name: str, adapter: int, schedule: int,
                   Camera: str = "Camera", Film: str = "Film") -> None:
    node = _db().group("Schedulers").children.get(name)
    if node is None:
        return
    node["type"] = int(schedule)
    node["adapter"] = int(adapter)
    node["camera"] = Camera
    node["film"] = Film


def render(name: str) -> None:
    """api.cpp:527-530 -> gvtRenderer::render: build + trace."""
    Renderer.instance().render(name)


def writeimage(name: str, output: str = "") -> None:
    Renderer.instance().write_image(name, output)


def gvtsync() -> None:
    _db().sync()
