"""Perspective camera with multi-jittered sampling, counterpart of
gravit_tpu/scene/camera.py.

Parity target: gvtPerspectiveCamera (data/scene/gvtCamera.cpp:89-312),
RIGHT_HAND_CAMERA convention. Ray generation is one vectorized expression
over the whole film.
"""

from __future__ import annotations

import dataclasses

import torch

from gravit_tpu_torch.core.math3d import cross3, norm3
from gravit_tpu_torch.core.rays import (FLT_MAX, RayArena, RayType,
                                        VolumeRayType)
from gravit_tpu_torch.core.timing import spanned
from gravit_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PerspectiveCamera:
    eye: tuple = (0.0, 0.0, 0.0)
    focus: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = 0.5235987755982988  # radians; all reference apps pass radians
    film_width: int = 512
    film_height: int = 512
    samples: int = 1          # rays per pixel = samples^2
    max_depth: int = 1
    jitter_window: float = 0.5
    # "current": half_sample = samples*0.5 (gvtCamera.cpp:250);
    # "golden": integer samples/2 (offset 0 at samples=1)
    jitter_mode: str = "current"

    @property
    def num_rays(self) -> int:
        return self.film_width * self.film_height * self.samples * self.samples

    def basis(self, device):
        """Camera basis (u, v, w): gvtCamera.cpp:92-144, RIGHT_HAND branch."""
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.tensor(self.eye, **f32)
        focus = torch.tensor(self.focus, **f32)
        up = torch.tensor(self.up, **f32)
        w = (focus - eye) / norm3(focus - eye)
        v0 = up / norm3(up)
        u = cross3(w, v0)
        u = u / norm3(u)
        v = cross3(u, w)
        v = v / norm3(v)
        return u, v, w

    @spanned("camera.generate_rays")
    def generate_rays(self, device=None, volume: bool = False) -> RayArena:
        """Whole-film primary ray wavefront (gvtCamera.cpp:233-312).

        Pixel NDC uses the W-1/H-1 convention (x0 = i*2/(W-1) - 1); the
        multi-jitter offset for sub-sample (k, s) is
        (s - half) * jitter_window / samples. `id` is the PIXEL index
        (j*W + i), shared by all samples of a pixel. Lanes run in
        ((j*W+i)*S+k)*S+s order. Volume rays start with w = 0 (w
        accumulates opacity), depth = 0 (depth holds the termination flags)
        and VolumeRayType.PRIMARY (gvtCamera.cpp:293-299).
        """
        device = resolve_device(device)
        W, H, S = self.film_width, self.film_height, self.samples
        u, v, w = self.basis(device)
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.tensor(self.eye, **f32)

        vert = torch.tan(torch.tensor(self.fov, **f32) * 0.5)
        horz = vert * (W / float(H))
        offset = self.jitter_window / float(S)
        half = float(S // 2) if self.jitter_mode == "golden" else S * 0.5

        shape = (H, W, S, S)
        j = torch.arange(H, **f32).view(H, 1, 1, 1).expand(shape)
        i = torch.arange(W, **f32).view(1, W, 1, 1).expand(shape)
        k = torch.arange(S, **f32).view(1, 1, S, 1).expand(shape)
        s = torch.arange(S, **f32).view(1, 1, 1, S).expand(shape)

        x0 = i * (2.0 / (W - 1)) - 1.0
        y0 = j * (2.0 / (H - 1)) - 1.0
        x = (x0 + (s - half) * offset) * horz
        y = (y0 + (k - half) * offset) * vert

        d = x[..., None] * u + y[..., None] * v + w
        d = d / norm3(d)[..., None]

        n = self.num_rays
        i32 = dict(dtype=torch.int32, device=device)
        return RayArena(
            origin=eye.expand(n, 3).clone(),
            direction=d.reshape(n, 3),
            color=torch.zeros((n, 3), **f32),
            t_max=torch.full((n,), FLT_MAX, **f32),
            t=torch.full((n,), FLT_MAX, **f32),
            w=torch.full((n,), 0.0 if volume else 1.0 / float(S * S), **f32),
            id=(j * W + i).reshape(n).to(torch.int32),
            depth=torch.full((n,), 0 if volume else self.max_depth, **i32),
            type=torch.full((n,), int(VolumeRayType.PRIMARY if volume
                                      else RayType.PRIMARY), **i32),
            inst=torch.full((n,), -1, **i32),
            prev=torch.full((n,), -1, **i32),
            active=torch.ones((n,), dtype=torch.bool, device=device),
        )
