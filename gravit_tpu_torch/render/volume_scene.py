"""Device-side volume scene: bricks as domains, instances as placements.
Counterpart of gravit_tpu/render/volume_scene.py.

The volume analog of scene_build.SceneData. Brick sample grids can differ in
shape, so they stay a tuple of per-volume tensors; everything per-instance is
SoA. Mirrors what the reference stores in the context DB for Volume nodes
(render/cntx/rcontext.h Volume schema + api.cpp createVolume path).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.scene.volume import Volume

# per-volume tuples of tensors, per-instance tensors, and the static fields
VOLUME_TENSOR_FIELDS = ("vol_samples", "vol_origin", "vol_spacing", "vol_lo",
                        "vol_hi", "vol_color_lut", "vol_opacity_lut",
                        "vol_vrange")
INSTANCE_TENSOR_FIELDS = ("inst_vol", "inst_lo", "inst_hi", "inst_minv")
STATIC_FIELDS = ("num_instances", "num_volumes", "vol_step", "vol_max_steps",
                 "vol_isovalues", "vol_slices", "vol_meta")


@dataclasses.dataclass
class VolumeSceneData:
    # per-volume leaves (tuples: shapes differ between bricks)
    vol_samples: Tuple[torch.Tensor, ...]   # each (nz, ny, nx)
    vol_origin: Tuple[torch.Tensor, ...]    # each (3,)
    vol_spacing: Tuple[torch.Tensor, ...]   # each (3,)
    vol_lo: Tuple[torch.Tensor, ...]
    vol_hi: Tuple[torch.Tensor, ...]
    vol_color_lut: Tuple[torch.Tensor, ...]    # each (256, 3)
    vol_opacity_lut: Tuple[torch.Tensor, ...]  # each (256,)
    vol_vrange: Tuple[torch.Tensor, ...]       # each (2,)
    # instances
    inst_vol: torch.Tensor    # (I,) i32
    inst_lo: torch.Tensor     # (I, 3) world bbox
    inst_hi: torch.Tensor     # (I, 3)
    inst_minv: torch.Tensor   # (I, 4, 4)

    # AMR: per-volume tuple of (samples, origin, spacing, lo, hi), ordered
    # coarse -> fine (Volume.h griddata nesting)
    vol_subgrids: Tuple[tuple, ...] = ()

    # static
    num_instances: int = 0
    num_volumes: int = 0
    vol_step: tuple = ()
    vol_max_steps: tuple = ()
    vol_isovalues: tuple = ()
    vol_slices: tuple = ()
    # static per-volume geometry/TF metadata for the slice-march fast path:
    # per volume a tuple (origin3, spacing3, (low, high))
    vol_meta: tuple = ()

    def replace(self, **changes) -> "VolumeSceneData":
        return dataclasses.replace(self, **changes)


def build_volume_scene(volumes: Sequence[Volume],
                       instances: Sequence[Tuple[int, np.ndarray]],
                       device=None) -> VolumeSceneData:
    """instances: list of (volume_id, 4x4 world transform)."""
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    vs, vo, vsp, vlo, vhi, vcl, vol_, vr = [], [], [], [], [], [], [], []
    steps, max_steps, subs = [], [], []
    for v in volumes:
        tf = v.tf
        if tf is None:
            raise ValueError("volume needs a transfer function")
        vs.append(f32(v.samples))
        vo.append(f32(v.origin))
        vsp.append(f32(v.spacing))
        vlo.append(f32(v.bounds_min))
        vhi.append(f32(v.bounds_max))
        c, a, r = tf.device_luts(device)
        vcl.append(c)
        vol_.append(a)
        vr.append(r)
        steps.append(v.step_size())
        max_steps.append(v.max_steps())
        subs.append(tuple(
            (f32(sub.samples), f32(sub.origin), f32(sub.spacing),
             f32(sub.bounds_min), f32(sub.bounds_max))
            for sub in sorted(v.subgrids, key=lambda g: g.level)))

    inst_vol = np.array([i[0] for i in instances], np.int32)
    inst_m = np.stack([np.asarray(m, np.float32) for _, m in instances])
    inst_minv = np.stack([np.linalg.inv(m).astype(np.float32)
                          for m in inst_m])
    lo, hi = [], []
    for vid, m in instances:
        v = volumes[vid]
        m = np.asarray(m, np.float32)
        il = m[:3, :3] @ v.bounds_min + m[:3, 3]
        ih = m[:3, :3] @ v.bounds_max + m[:3, 3]
        lo.append(np.minimum(il, ih))
        hi.append(np.maximum(il, ih))

    return VolumeSceneData(
        vol_samples=tuple(vs), vol_origin=tuple(vo), vol_spacing=tuple(vsp),
        vol_lo=tuple(vlo), vol_hi=tuple(vhi),
        vol_color_lut=tuple(vcl), vol_opacity_lut=tuple(vol_),
        vol_vrange=tuple(vr),
        inst_vol=torch.tensor(inst_vol, device=device),
        inst_lo=f32(np.stack(lo)), inst_hi=f32(np.stack(hi)),
        inst_minv=f32(inst_minv),
        vol_subgrids=tuple(subs),
        num_instances=len(instances), num_volumes=len(volumes),
        vol_step=tuple(steps), vol_max_steps=tuple(max_steps),
        vol_isovalues=tuple(tuple(float(x) for x in v.isovalues)
                            for v in volumes),
        vol_slices=tuple(tuple(tuple(float(x) for x in pl)
                               for pl in v.slices) for v in volumes),
        vol_meta=tuple(
            (tuple(float(x) for x in v.origin),
             tuple(float(x) for x in v.spacing),
             (float(v.tf.low), float(v.tf.high)))
            for v in volumes),
    )
