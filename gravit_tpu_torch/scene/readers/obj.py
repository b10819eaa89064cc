"""Wavefront OBJ reader (+ .mtl materials).
Counterpart of gravit_tpu/scene/readers/obj.py, copied (numpy only).

Reference: data/reader/ObjReader.cpp (tinyobjloader path). Notes for parity:
faces land in the mesh 0-based WITHOUT the degenerate-face filter of
Mesh::addFace (ObjReader.cpp:193-197 pushes Face directly); vertex normals
from the file are normalized; a file without normals gets them from
generateNormals() only if the caller asks (SimpleFileLoadApp.cpp:157 does).
Polygons fan-triangulate like tinyobj. When the obj references materials,
every face gets one, built with ka=ambient/kd=diffuse/ks=specular and the
caller's material_type (ObjReader.cpp:153-167).
"""

from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np

from gravit_tpu_torch.scene.material import Material
from gravit_tpu_torch.scene.mesh import Mesh


def _resolve(idx: int, count: int) -> int:
    """OBJ 1-based w/ negative-relative indices -> 0-based."""
    return idx - 1 if idx > 0 else count + idx


def read_mtl(path: str) -> Dict[str, Material]:
    """Minimal .mtl parser: newmtl/Kd/Ks/Ns (Ka read but unused by the
    shading models, matching Material.cpp)."""
    mats: Dict[str, Material] = {}
    cur = None
    p = pathlib.Path(path)
    if not p.exists():
        return mats
    for line in p.read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "newmtl":
            cur = parts[1]
            mats[cur] = Material()
        elif cur is not None and parts[0] == "Kd":
            mats[cur].kd = tuple(float(x) for x in parts[1:4])
        elif cur is not None and parts[0] == "Ks":
            mats[cur].ks = tuple(float(x) for x in parts[1:4])
        elif cur is not None and parts[0] == "Ns":
            mats[cur].alpha = float(parts[1])
    return mats


def read_obj(path: str, material_type: int = 0,
             generate_normals: bool = True) -> Mesh:
    verts: list = []
    normals: list = []
    faces: list = []
    face_mats: list = []
    materials: Dict[str, Material] = {}
    cur_mat = None
    base = pathlib.Path(path).parent

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif tag == "vn":
                n = np.array([float(parts[1]), float(parts[2]),
                              float(parts[3])], np.float32)
                nl = np.linalg.norm(n)
                normals.append(n / nl if nl > 0 else n)
            elif tag == "mtllib":
                materials.update(read_mtl(str(base / parts[1])))
            elif tag == "usemtl":
                cur_mat = materials.get(parts[1])
                if cur_mat is not None:
                    cur_mat.type = material_type
            elif tag == "f":
                ids = [_resolve(int(p.split("/")[0]), len(verts))
                       for p in parts[1:]]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append((ids[0], ids[k], ids[k + 1]))
                    face_mats.append(cur_mat)

    mesh = Mesh()
    mesh.add_vertices(np.asarray(verts, np.float32))
    # bypass add_faces: obj faces go in raw (0-based, no degenerate filter)
    mesh.faces = [tuple(int(i) for i in f) for f in faces]
    if len(normals) == len(verts):
        mesh.normals = [np.asarray(n, np.float32) for n in normals]
        mesh.have_normals = True
    mesh.material = Material(type=material_type)
    if materials and any(m is not None for m in face_mats):
        mesh.face_materials = face_mats
    if generate_normals:
        mesh.generate_normals()
    mesh.compute_bounding_box()
    return mesh
