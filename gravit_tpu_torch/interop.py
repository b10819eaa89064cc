"""Carry state across from the JAX package, from numpy arrays only.

Each function takes a mapping of field name to `np.ndarray` (the caller
runs `np.asarray` on every JAX leaf) plus the static fields, and returns the
port's dataclass on `device`. The port never sees a JAX object. Tests use it
to trace the SAME flat BVH arrays through both packages: the JAX package's
native builder orders leaf triangles differently from the numpy builder.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from gravit_tpu_torch.accel.instance_bvh import InstanceBVH
from gravit_tpu_torch.accel.scene_accel import SceneBVH
from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render import train
from gravit_tpu_torch.render import volume_scene as vs
from gravit_tpu_torch.render.scene_build import (STATIC_FIELDS, TENSOR_FIELDS,
                                                 SceneData)


def _tensors(cls, arrays: Mapping[str, np.ndarray], names, device):
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__}: missing arrays {missing}")
    return {n: torch.tensor(np.asarray(arrays[n]), device=device)
            for n in names}


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                     inst_bvh: Optional[Mapping[str, np.ndarray]] = None,
                     **static) -> SceneData:
    """SceneData from its tensor fields as numpy arrays; `inst_bvh` holds
    the instance tree's arrays (None: no tree); `static` names
    num_instances, num_lights, ... (gravit_tpu's non-pytree fields)."""
    device = resolve_device(device)
    unknown = set(static) - set(STATIC_FIELDS)
    if unknown:
        raise TypeError(f"unknown static fields {sorted(unknown)}")
    tree = (None if inst_bvh is None
            else instance_bvh_from_numpy(inst_bvh, device))
    return SceneData(**_tensors(SceneData, arrays, TENSOR_FIELDS, device),
                     inst_bvh=tree, **static)


def instance_bvh_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> InstanceBVH:
    device = resolve_device(device)
    names = [f.name for f in dataclasses.fields(InstanceBVH)]
    return InstanceBVH(**_tensors(InstanceBVH, arrays, names, device))


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


def volume_scene_from_numpy(arrays: Mapping[str, object], device=None,
                            **static) -> vs.VolumeSceneData:
    """VolumeSceneData from the JAX scene's leaves as numpy: the per-volume
    fields as lists of arrays, the per-instance fields as arrays,
    `vol_subgrids` as a per-volume tuple of (samples, origin, spacing, lo,
    hi) tuples (optional); `static` names num_instances, vol_step, ...
    (gravit_tpu's non-pytree fields)."""
    device = resolve_device(device)
    unknown = set(static) - set(vs.STATIC_FIELDS)
    if unknown:
        raise TypeError(f"unknown static fields {sorted(unknown)}")
    names = vs.VOLUME_TENSOR_FIELDS + vs.INSTANCE_TENSOR_FIELDS
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"VolumeSceneData: missing arrays {missing}")

    def tensor(x):
        return torch.tensor(np.asarray(x), device=device)

    fields = {n: tuple(tensor(x) for x in arrays[n])
              for n in vs.VOLUME_TENSOR_FIELDS}
    fields.update({n: tensor(arrays[n]) for n in vs.INSTANCE_TENSOR_FIELDS})
    subgrids = tuple(tuple(tuple(tensor(x) for x in sub) for sub in subs)
                     for subs in arrays.get("vol_subgrids", ()))
    return vs.VolumeSceneData(**fields, vol_subgrids=subgrids, **static)


def train_state_from_numpy(params, adam_leaves=None, device=None,
                           optimizer=None):
    """The JAX package's training state carried across: `params` are
    TrainParams' four leaves (vertices, kd, light_pos, light_color) as numpy
    arrays, `adam_leaves` optax Adam's state leaves in flatten order (count,
    mu's four params, nu's four params; None: a fresh optimiser). Returns
    (TrainParams of leaf tensors that require grad, a torch.optim.Adam over
    them primed with those moments). `optimizer` is the torch.optim factory
    (default train.adam(1e-3), optax.adam(1e-3)'s counterpart)."""
    device = resolve_device(device)
    p = train.TrainParams(*(
        torch.tensor(np.asarray(a, np.float32), device=device)
        .requires_grad_(True) for a in params))
    opt = (optimizer or train.adam(1e-3))(list(p))
    if adam_leaves is not None:
        train.load_adam_state(opt, p, train.adam_state_from_leaves(
            adam_leaves, device))
    return p, opt
