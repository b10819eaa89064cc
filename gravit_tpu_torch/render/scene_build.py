"""Compile a host-side scene description into the device-resident SceneData.

Counterpart of gravit_tpu/render/scene_build.py, the analog of GraviT's
tracer Initialize() (algorithm/TracerBase.h:247-308): all meshes concatenate
into one triangle soup (a per-triangle mesh id keeps instances separable),
instances are SoA transform tables, lights a fixed bundle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gravit_tpu_torch.accel.instance_bvh import (InstanceBVH,
                                                 build_instance_bvh)
from gravit_tpu_torch.core import math3d
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.scene.light import Light, bundle_lights
from gravit_tpu_torch.scene.mesh import CompiledMesh

# instance counts at or above this build the instance BVH for the shuffle
# (scene_build.py:198-204)
INSTANCE_BVH_THRESHOLD = 64


@dataclasses.dataclass
class SceneData:
    """Device-side scene: tensors plus static metadata."""

    vertices: torch.Tensor      # (V, 3)
    faces: torch.Tensor         # (T, 3) int32 into `vertices`

    tri_v0: torch.Tensor        # (T, 3)
    tri_e1: torch.Tensor        # (T, 3)
    tri_e2: torch.Tensor        # (T, 3)
    tri_ng: torch.Tensor        # (T, 3) unit geometric normal
    tri_ns: torch.Tensor        # (T, 3, 3) per-corner shading normals
    tri_vcol: torch.Tensor      # (T, 3, 3) per-corner colors (1.0 if unused)
    tri_has_vcol: torch.Tensor  # (T,) bool
    tri_mesh: torch.Tensor      # (T,) i32
    tri_mat_type: torch.Tensor  # (T,) i32
    tri_kd: torch.Tensor        # (T, 3)
    tri_ks: torch.Tensor        # (T, 3)
    tri_alpha: torch.Tensor     # (T,)
    tri_eta: torch.Tensor       # (T, 3) embree material family
    tri_k: torch.Tensor         # (T, 3)
    tri_rough: torch.Tensor     # (T,)
    tri_hsc: torch.Tensor       # (T, 3)
    tri_bs: torch.Tensor        # (T,)
    tri_hsf: torch.Tensor       # (T,)

    inst_mesh: torch.Tensor     # (I,) i32
    inst_lo: torch.Tensor       # (I, 3) world bbox (two-corner transform)
    inst_hi: torch.Tensor       # (I, 3)
    inst_m: torch.Tensor        # (I, 4, 4)
    inst_minv: torch.Tensor     # (I, 4, 4)
    inst_normi: torch.Tensor    # (I, 3, 3)

    lights_kind: torch.Tensor   # (L,) i32
    lights_pos: torch.Tensor    # (L, 3)
    lights_color: torch.Tensor  # (L, 3)
    lights_u: torch.Tensor      # (L, 3)
    lights_w: torch.Tensor      # (L, 3)
    lights_wh: torch.Tensor     # (L, 2)

    # the instance tree of the shuffle (None: the scan over instances)
    inst_bvh: Optional[InstanceBVH] = None

    # static metadata
    num_instances: int = 0
    num_lights: int = 0
    num_meshes: int = 0
    mesh_tri_offset: tuple = ()
    mesh_tri_count: tuple = ()
    has_embree_materials: bool = False
    # any phong/blinn triangle? False lets shade() skip the power branches
    has_specular: bool = True

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(SceneData)
                      if f.type == "torch.Tensor")
STATIC_FIELDS = tuple(f.name for f in dataclasses.fields(SceneData)
                      if f.type != "torch.Tensor" and f.name != "inst_bvh")


@dataclasses.dataclass
class Instance:
    mesh_id: int
    m: np.ndarray  # (4, 4) row-major world transform


def build_scene(meshes: Sequence[CompiledMesh],
                instances: Sequence[Instance],
                lights: Sequence[Light],
                pad_tris_to: Optional[int] = None,
                device=None, instance_bvh: Optional[bool] = None
                ) -> SceneData:
    """`instance_bvh=None` builds the instance tree from
    INSTANCE_BVH_THRESHOLD instances on; True / False force it on / off.
    It is never built for one instance."""
    device = resolve_device(device)
    offsets, counts = [], []
    off = 0
    for m in meshes:
        offsets.append(off)
        counts.append(m.num_triangles)
        off += m.num_triangles

    cat = lambda parts: np.concatenate(parts, axis=0)  # noqa: E731
    vert_parts, face_parts = [], []
    voff = 0
    for m in meshes:
        verts = np.zeros((m.num_vertices, 3), np.float32)
        # recover vertex positions from (v0, e1, e2): v0 at corner0 etc.
        verts[m.faces[:, 0]] = m.v0
        verts[m.faces[:, 1]] = m.v0 + m.e1
        verts[m.faces[:, 2]] = m.v0 + m.e2
        vert_parts.append(verts)
        face_parts.append(m.faces + voff)
        voff += m.num_vertices
    arrays = {
        "vertices": cat(vert_parts) if vert_parts
        else np.zeros((0, 3), np.float32),
        "faces": cat(face_parts).astype(np.int32) if face_parts
        else np.zeros((0, 3), np.int32),
        "tri_v0": cat([m.v0 for m in meshes]),
        "tri_e1": cat([m.e1 for m in meshes]),
        "tri_e2": cat([m.e2 for m in meshes]),
        "tri_ng": cat([m.geom_normal for m in meshes]),
        "tri_ns": cat([m.shading_normals for m in meshes]),
        "tri_vcol": cat([
            m.vertex_colors if m.vertex_colors is not None
            else np.ones((m.num_triangles, 3, 3), np.float32)
            for m in meshes]),
        "tri_has_vcol": cat([
            np.full((m.num_triangles,), m.vertex_colors is not None)
            for m in meshes]),
        "tri_mesh": cat([np.full((m.num_triangles,), i, np.int32)
                         for i, m in enumerate(meshes)]),
        "tri_mat_type": cat([m.mat_type for m in meshes]),
        "tri_kd": cat([m.mat_kd for m in meshes]),
        "tri_ks": cat([m.mat_ks for m in meshes]),
        "tri_alpha": cat([m.mat_alpha for m in meshes]),
        "tri_eta": cat([m.mat_eta for m in meshes]),
        "tri_k": cat([m.mat_k for m in meshes]),
        "tri_rough": cat([m.mat_rough for m in meshes]),
        "tri_hsc": cat([m.mat_hsc for m in meshes]),
        "tri_bs": cat([m.mat_bs for m in meshes]),
        "tri_hsf": cat([m.mat_hsf for m in meshes]),
    }
    t = arrays["tri_v0"].shape[0]
    if pad_tris_to is not None and pad_tris_to > t:
        pad = pad_tris_to - t
        for name, a in arrays.items():
            if name == "vertices":
                continue
            fill = -2 if name == "tri_mesh" else 0
            arrays[name] = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

    inst_m = np.stack([np.asarray(i.m, np.float32) for i in instances])
    lo, hi = [], []
    for i in instances:
        # world bbox by transforming the two mesh-bbox corners, exactly as
        # api.cpp:307-312 (NOT a conservative 8-corner transform)
        msh = meshes[i.mesh_id]
        m = np.asarray(i.m, np.float32)
        il = m[:3, :3] @ msh.bounds_min + m[:3, 3]
        ih = m[:3, :3] @ msh.bounds_max + m[:3, 3]
        lo.append(np.minimum(il, ih))
        hi.append(np.maximum(il, ih))
    lb = bundle_lights(list(lights))
    arrays.update(
        inst_mesh=np.array([i.mesh_id for i in instances], np.int32),
        inst_lo=np.stack(lo), inst_hi=np.stack(hi),
        inst_m=inst_m,
        inst_minv=np.stack([np.linalg.inv(m).astype(np.float32)
                            for m in inst_m]),
        inst_normi=np.stack([math3d.normal_matrix(m) for m in inst_m]),
        lights_kind=lb.kind, lights_pos=lb.position, lights_color=lb.color,
        lights_u=lb.u, lights_w=lb.w,
        lights_wh=np.stack([lb.width, lb.height], axis=-1),
    )
    if instance_bvh is None:
        instance_bvh = len(instances) >= INSTANCE_BVH_THRESHOLD
    ibvh = None
    if instance_bvh and len(instances) > 1:
        ibvh = build_instance_bvh(arrays["inst_lo"], arrays["inst_hi"],
                                  device=device)
    mat = arrays["tri_mat_type"]
    return SceneData(
        inst_bvh=ibvh,
        **{k: torch.as_tensor(np.ascontiguousarray(a), device=device)
           for k, a in arrays.items()},
        num_instances=len(instances),
        num_lights=lb.count,
        num_meshes=len(meshes),
        mesh_tri_offset=tuple(offsets),
        mesh_tri_count=tuple(counts),
        has_embree_materials=bool(np.any(mat >= 3)),
        has_specular=bool(np.any((mat == 1) | (mat == 2))),
    )


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x / max(|x|, 1e-30) row by row, |x| = sqrt of the left-to-right
    dot3 sum (the JAX package's jnp.linalg.norm order). At a zero row the
    backward is 0: JAX's sqrt(sum(x*x)) gives NaN there (0 * inf), as
    torch.linalg.norm does not. No fixture has a degenerate triangle."""
    n2 = math3d.dot3(x, x)
    pos = n2 > 0.0
    n = torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return x / torch.clamp(n, min=1e-30)[:, None]


def refresh_geometry(scene: SceneData, vertices: torch.Tensor) -> SceneData:
    """Re-derive the triangle soup from a (possibly updated) vertex buffer
    (JAX render/scene_build.py:238-260), out of place, so that autograd
    carries gradients of rendered pixels to `vertices` through (v0, e1,
    e2), the geometric normals and the generateNormals()-style
    area-weighted vertex normals (Mesh.cpp:116-155).

    The vertex-normal sums are `index_add`: on the card repeated indices
    are summed by atomics in no fixed order, so their last bit (and a
    vertex gradient's) can vary from run to run; hold card results by a
    bound, not bit-equality.
    """
    f = scene.faces.to(torch.int64)
    v0 = vertices[f[:, 0]]
    e1 = vertices[f[:, 1]] - v0
    e2 = vertices[f[:, 2]] - v0
    fn = _unit_rows(math3d.cross3(e1, e2))
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn = vn.index_add(0, f[:, k], fn)
    vn = _unit_rows(vn)
    tri_ns = torch.stack([vn[f[:, 0]], vn[f[:, 1]], vn[f[:, 2]]], dim=1)
    return dataclasses.replace(scene, vertices=vertices, tri_v0=v0,
                               tri_e1=e1, tri_e2=e2, tri_ng=fn, tri_ns=tri_ns)
