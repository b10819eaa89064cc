"""PLY reader (ascii + binary little-endian).
Counterpart of gravit_tpu/scene/readers/ply.py, copied (numpy only).

Reference: PlyReader (data/reader/PlyReader.cpp) wraps third-party/ply and
reads a DIRECTORY of ply domain files, optionally distributing them
round-robin over ranks (PlyReader.cpp:54). `read_ply` loads one file;
`read_ply_dir` reproduces the directory-of-domains behavior, returning one
mesh per file (each becomes a domain/instance).
"""

from __future__ import annotations

import pathlib
import struct
from typing import List, Optional, Tuple

import numpy as np

from gravit_tpu_torch.scene.material import Material
from gravit_tpu_torch.scene.mesh import Mesh

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def _parse_header(data: bytes):
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a ply file (no end_header)")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]
    if header[0].strip() != "ply":
        raise ValueError("not a ply file")
    fmt = None
    elements = []  # (name, count, [(prop_kind, ...)...])
    for line in header[1:]:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
    return fmt, elements, body


def read_ply(path: str, material: Optional[Material] = None) -> Mesh:
    data = pathlib.Path(path).read_bytes()
    fmt, elements, body = _parse_header(data)

    verts: List = []
    faces: List[Tuple[int, int, int]] = []

    if fmt == "ascii":
        toks = body.split()
        ti = 0
        for name, count, props in elements:
            for _ in range(count):
                vals = {}
                for p in props:
                    if p[0] == "list":
                        n = int(float(toks[ti])); ti += 1
                        lst = [int(float(toks[ti + k])) for k in range(n)]
                        ti += n
                        vals[p[3]] = lst
                    else:
                        vals[p[2]] = float(toks[ti]); ti += 1
                _collect(name, vals, verts, faces)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            for _ in range(count):
                vals = {}
                for p in props:
                    if p[0] == "list":
                        cf, cs = _TYPES[p[1]]
                        n = struct.unpack_from("<" + cf, body, off)[0]
                        off += cs
                        vf, vs = _TYPES[p[2]]
                        lst = list(struct.unpack_from("<%d%s" % (n, vf),
                                                      body, off))
                        off += n * vs
                        vals[p[3]] = lst
                    else:
                        vf, vs = _TYPES[p[1]]
                        vals[p[2]] = struct.unpack_from("<" + vf, body,
                                                        off)[0]
                        off += vs
                _collect(name, vals, verts, faces)
    else:
        raise ValueError(f"unsupported ply format {fmt}")

    mesh = Mesh()
    mesh.add_vertices(np.asarray(verts, np.float32))
    tris = []
    for f in faces:
        for k in range(1, len(f) - 1):  # fan-triangulate polygons
            tris.append((f[0], f[k], f[k + 1]))
    mesh.faces = [tuple(int(i) for i in t) for t in tris]
    mesh.material = material or Material()
    mesh.generate_normals()
    mesh.compute_bounding_box()
    return mesh


def _collect(name, vals, verts, faces):
    if name == "vertex":
        verts.append((vals.get("x", 0.0), vals.get("y", 0.0),
                      vals.get("z", 0.0)))
    elif name == "face":
        idx = vals.get("vertex_indices") or vals.get("vertex_index") or []
        if len(idx) >= 3:
            faces.append(tuple(idx))


def read_ply_dir(path: str, rank: int = 0, size: int = 1,
                 material: Optional[Material] = None) -> List[Mesh]:
    """Directory of ply domains, round-robin over 'ranks'
    (PlyReader.cpp:54). In SPMD use rank=0/size=1 and let the domain
    scheduler own placement."""
    files = sorted(pathlib.Path(path).glob("*.ply"))
    return [read_ply(str(f), material) for i, f in enumerate(files)
            if i % size == rank]
