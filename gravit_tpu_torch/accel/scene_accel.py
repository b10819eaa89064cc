"""Scene-level acceleration bundle, counterpart of
gravit_tpu/accel/scene_accel.py: per-mesh flat BVHs concatenated for the
traversal kernel, plus the leaf-order -> global-triangle map used to gather
shading data after a hit."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gravit_tpu_torch.accel.bvh import LEAF_PAD_ROWS, build_bvh
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.scene.mesh import CompiledMesh


@dataclasses.dataclass
class SceneBVH:
    bounds: torch.Tensor       # (Nn, 8) f32
    meta: torch.Tensor         # (Nn, 4) i32, leaf tri ranges in CONCAT leaf order
    tri: torch.Tensor          # (Tp, 12) f32 leaf-ordered v0|e1|e2|pad
    leaf2global: torch.Tensor  # (Tp,) i32 leaf-order row -> global tri id
    mesh_root: torch.Tensor    # (M,) i32 root node per mesh
    num_meshes: int = 0


def build_scene_bvh(meshes: Sequence[CompiledMesh], device=None) -> SceneBVH:
    device = resolve_device(device)
    bounds_parts, meta_parts, tri_parts, map_parts, roots = [], [], [], [], []
    node_off = 0
    tri_off = 0        # rows in the packed (leaf-order) triangle table
    for m in meshes:
        bvh = build_bvh(m.v0, m.e1, m.e2)
        mt = bvh.meta.copy()
        leaf = mt[:, 2] > 0
        mt[~leaf, 0] += node_off          # children
        mt[~leaf, 1] += node_off
        mt[leaf, 0] += tri_off            # leaf tri start in packed rows
        roots.append(node_off)
        node_off += bvh.bounds.shape[0]

        order = bvh.order
        packed = np.zeros((order.shape[0], 12), np.float32)
        packed[:, 0:3] = m.v0[order]
        packed[:, 3:6] = m.e1[order]
        packed[:, 6:9] = m.e2[order]
        tri_parts.append(packed)
        # global triangle ids follow build_scene's concat order
        map_parts.append(order.astype(np.int32) + tri_off)
        bounds_parts.append(bvh.bounds)
        meta_parts.append(mt)
        tri_off += order.shape[0]

    # tail padding so any leaf slice [start, start+8) is readable; padded
    # rows are degenerate (det == 0 -> never hit)
    pad = LEAF_PAD_ROWS
    tri = np.concatenate(tri_parts + [np.zeros((pad, 12), np.float32)])
    leaf2global = np.concatenate(map_parts + [np.zeros((pad,), np.int32)])
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SceneBVH(
        bounds=as_t(np.concatenate(bounds_parts, axis=0)),
        meta=as_t(np.concatenate(meta_parts, axis=0)),
        tri=as_t(tri),
        leaf2global=as_t(leaf2global),
        mesh_root=as_t(np.asarray(roots, np.int32)),
        num_meshes=len(meshes),
    )
