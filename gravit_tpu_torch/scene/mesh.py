"""Host-side triangle mesh (numpy) and its compiled form, copied from
gravit_tpu/scene/mesh.py (the port keeps its own copy; no code is shared).

Reference: data/primitives/Mesh.{h,cpp}. `addFace` is 1-based and silently
drops degenerate faces (Mesh.cpp:103-110); `generateNormals` accumulates
unnormalized face normals onto vertices then normalizes (Mesh.cpp:116-155);
faces_to_normals stores the face's own vertex indices (I, J, K).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gravit_tpu_torch.scene.material import Material


@dataclasses.dataclass
class Mesh:
    """Mutable host-side mesh under construction (the api.* target)."""

    vertices: list = dataclasses.field(default_factory=list)
    faces: list = dataclasses.field(default_factory=list)
    normals: list = dataclasses.field(default_factory=list)        # per-vertex
    face_normals: list = dataclasses.field(default_factory=list)
    vertex_colors: list = dataclasses.field(default_factory=list)
    material: Optional[Material] = None
    face_materials: list = dataclasses.field(default_factory=list)
    have_normals: bool = False
    bounds_min: Optional[np.ndarray] = None
    bounds_max: Optional[np.ndarray] = None

    def add_vertices(self, verts: np.ndarray) -> None:
        verts = np.asarray(verts, np.float32).reshape(-1, 3)
        self.vertices.extend(verts)

    def add_faces(self, tris: np.ndarray) -> None:
        """1-based vertex indices; degenerate faces dropped (Mesh.cpp:103-110)."""
        tris = np.asarray(tris, np.int64).reshape(-1, 3) - 1
        v = np.asarray(self.vertices, np.float32)
        for a, b, c in tris:
            if (
                np.array_equal(v[a], v[b])
                or np.array_equal(v[b], v[c])
                or np.array_equal(v[c], v[a])
            ):
                continue
            self.faces.append((int(a), int(b), int(c)))

    def generate_normals(self) -> None:
        """Angle-unweighted vertex normal accumulation (Mesh.cpp:116-155)."""
        if self.have_normals:
            return
        v = np.asarray(self.vertices, np.float32)
        f = np.asarray(self.faces, np.int64).reshape(-1, 3)
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        fn = np.cross(e1, e2)
        fn_unit = fn / np.linalg.norm(fn, axis=-1, keepdims=True)
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn_unit)
        vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-30)
        self.face_normals = list(fn_unit.astype(np.float32))
        self.normals = list(vn.astype(np.float32))
        self.have_normals = True

    def compute_bounding_box(self) -> None:
        v = np.asarray(self.vertices, np.float32)
        self.bounds_min = v.min(axis=0)
        self.bounds_max = v.max(axis=0)

    def finish(self, compute_normals: bool = True) -> "CompiledMesh":
        self.compute_bounding_box()
        if compute_normals:
            self.generate_normals()
        return self.compile()

    def compile(self) -> "CompiledMesh":
        """Freeze into flat numpy arrays ready for device upload."""
        v = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        f = np.asarray(self.faces, np.int64).reshape(-1, 3).astype(np.int32)
        nf = len(f)
        v0 = v[f[:, 0]]
        e1 = v[f[:, 1]] - v0
        e2 = v[f[:, 2]] - v0

        if len(self.face_normals) == nf:
            fn = np.asarray(self.face_normals, np.float32)
        else:
            fn = np.cross(e1, e2)
            fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
        if len(self.normals) == len(v):
            n = np.asarray(self.normals, np.float32)
            shading_n = np.stack([n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]], axis=1)
        else:
            shading_n = np.repeat(fn[:, None, :], 3, axis=1)

        if len(self.vertex_colors) == len(v):
            c = np.asarray(self.vertex_colors, np.float32)
            vcol = np.stack([c[f[:, 0]], c[f[:, 1]], c[f[:, 2]]], axis=1)
        else:
            vcol = None

        mat = self.material or Material()
        if self.face_materials:
            mats = [m if m is not None else mat for m in self.face_materials]
        else:
            mats = [mat] * nf

        self.compute_bounding_box()
        return CompiledMesh(
            v0=v0.astype(np.float32),
            e1=e1.astype(np.float32),
            e2=e2.astype(np.float32),
            geom_normal=fn.astype(np.float32),
            shading_normals=shading_n.astype(np.float32),
            vertex_colors=vcol,
            faces=f,
            num_vertices=len(v),
            mat_type=np.array([m.type for m in mats], np.int32),
            mat_kd=np.array([m.kd for m in mats], np.float32),
            mat_ks=np.array([m.ks for m in mats], np.float32),
            mat_alpha=np.array([m.alpha for m in mats], np.float32),
            mat_eta=np.array([m.eta for m in mats], np.float32),
            mat_k=np.array([m.k for m in mats], np.float32),
            mat_rough=np.array([m.roughness for m in mats], np.float32),
            mat_hsc=np.array([m.horizon_scatter_color for m in mats],
                             np.float32),
            mat_bs=np.array([m.back_scattering for m in mats], np.float32),
            mat_hsf=np.array([m.horizon_scatter_falloff for m in mats],
                             np.float32),
            bounds_min=self.bounds_min,
            bounds_max=self.bounds_max,
        )


@dataclasses.dataclass
class CompiledMesh:
    """Immutable SoA mesh: triangles pre-expanded to (v0, e1, e2).

    Pre-expanding edges trades 3x vertex storage for a gather-free
    Möller-Trumbore inner loop — the right trade on TPU where HBM streams
    beat random access.
    """

    v0: np.ndarray                  # (T, 3)
    e1: np.ndarray                  # (T, 3)
    e2: np.ndarray                  # (T, 3)
    geom_normal: np.ndarray         # (T, 3) unit face normal
    shading_normals: np.ndarray     # (T, 3, 3) per-corner unit normals
    vertex_colors: Optional[np.ndarray]  # (T, 3, 3) or None
    faces: np.ndarray               # (T, 3) int32 vertex ids (for autodiff scatter)
    num_vertices: int
    mat_type: np.ndarray            # (T,)
    mat_kd: np.ndarray              # (T, 3)
    mat_ks: np.ndarray              # (T, 3)
    mat_alpha: np.ndarray           # (T,)
    mat_eta: np.ndarray             # (T, 3) embree-metal
    mat_k: np.ndarray               # (T, 3)
    mat_rough: np.ndarray           # (T,)
    mat_hsc: np.ndarray             # (T, 3) embree-velvet
    mat_bs: np.ndarray              # (T,)
    mat_hsf: np.ndarray             # (T,)
    bounds_min: np.ndarray          # (3,)
    bounds_max: np.ndarray          # (3,)

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]
