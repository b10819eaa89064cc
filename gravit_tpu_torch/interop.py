"""Carry state across from the JAX package, from numpy arrays only.

Each function takes a mapping of field name to `np.ndarray` (the caller
runs `np.asarray` on every JAX leaf) plus the static fields, and returns the
port's dataclass on `device`. The port never sees a JAX object. Tests use it
to trace the SAME flat BVH arrays through both packages: the JAX package's
native builder orders leaf triangles differently from the numpy builder.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from gravit_tpu_torch.accel.scene_accel import SceneBVH
from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render.scene_build import (STATIC_FIELDS, TENSOR_FIELDS,
                                                 SceneData)


def _tensors(cls, arrays: Mapping[str, np.ndarray], names, device):
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__}: missing arrays {missing}")
    return {n: torch.tensor(np.asarray(arrays[n]), device=device)
            for n in names}


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                     **static) -> SceneData:
    """SceneData from its tensor fields as numpy arrays; `static` names
    num_instances, num_lights, ... (gravit_tpu's non-pytree fields)."""
    device = resolve_device(device)
    unknown = set(static) - set(STATIC_FIELDS)
    if unknown:
        raise TypeError(f"unknown static fields {sorted(unknown)}")
    return SceneData(**_tensors(SceneData, arrays, TENSOR_FIELDS, device),
                     **static)


def bvh_from_numpy(arrays: Mapping[str, np.ndarray], num_meshes: int,
                   device=None) -> SceneBVH:
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(SceneBVH)
             if f.name != "num_meshes"]
    return SceneBVH(**_tensors(SceneBVH, arrays, names, device),
                    num_meshes=num_meshes)


def rays_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> RayArena:
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(RayArena)]
    return RayArena(**_tensors(RayArena, arrays, names, device))
