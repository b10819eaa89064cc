"""The resident volume loop: the bricks built into the volume scene once in
set-up; a frame is the camera's volume rays for the pose and the tracer
render_volume picks for them (render/renderer.py: the slice gate, the
wavefront tracer with each brick's engine), without the build.

What the volume drivers share is here (drivers/__init__.py's RenderDriver
and scene_bounds take meshes): the orbit from the volume's bounds, the
transfer function and the check against portbench/reference/volume.py."""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare
from portbench.drivers import Driver, RenderDriver
from portbench.harness import reference_of
from portbench.orbit import Orbit


class VolumeDriver(RenderDriver):
    """Frame k renders pose k of the seeded orbit around the bricks."""

    def __init__(self, cell, seed: int, device, film=None):
        Driver.__init__(self, cell, seed, device, film)
        self.orbit = Orbit(self.cfg, self.mix, self.seed,
                           bounds=self.scene_data.bounds())

    def transfer(self):
        """The configuration's transfer function over the field's range."""
        from gravit_tpu_torch.scene.transfer import TransferFunction

        tf = self.cfg["transfer"]
        if tf["ramp"] != "gray":
            raise NotImplementedError(f"transfer ramp {tf['ramp']!r}")
        return TransferFunction.gray_ramp(
            low=self.scene_data.low, high=self.scene_data.high,
            max_opacity=float(tf["max_opacity"]))

    def check(self, kept: list) -> dict:
        """Worst readings over the kept frames [(k, framebuffer)]."""
        ref = reference_of(self.cfg)
        prep = ref.prepare(self.scene_data, self.cfg["transfer"],
                           self.device,
                           sampling_rate=float(self.cfg["sampling_rate"]))
        readings = []
        for k, fb in kept:
            with torch.no_grad():
                want = ref.render(prep, self.ref_camera(self.pose(k)))
            readings.append(compare.frame_readings(fb, want))
        return compare.worst(readings)


class ResidentVolumeDriver(VolumeDriver):
    def setup(self) -> None:
        from gravit_tpu_torch.render.volume_scene import build_volume_scene
        from gravit_tpu_torch.scene.volume import Volume

        tf, rate = self.transfer(), float(self.cfg["sampling_rate"])
        volumes = [Volume(samples=b.samples, origin=b.origin,
                          spacing=np.ones(3, np.float32), sampling_rate=rate,
                          tf=tf) for b in self.scene_data.bricks]
        eye4 = np.eye(4, dtype=np.float32)
        self.scene = build_volume_scene(
            volumes, [(i, eye4) for i in range(len(volumes))],
            device=self.device)
        self.warm_up()

    def camera(self, k: int):
        from gravit_tpu_torch.scene.camera import PerspectiveCamera

        eye, focus, up = self.pose(k)
        return PerspectiveCamera(
            eye=eye, focus=focus, up=up, fov=self.fov,
            film_width=self.width, film_height=self.height,
            samples=int(self.cfg["samples"]), max_depth=int(self.cfg["depth"]),
            jitter_window=float(self.cfg["camera"]["jitter"]))

    def frame(self, k: int):
        from gravit_tpu_torch.render.tracer import make_arena
        from gravit_tpu_torch.render.volume_tracer import (can_slice_march,
                                                           slice_axes_for,
                                                           trace_volume,
                                                           trace_volume_fast)

        cam, sc = self.camera(k), self.scene
        rays = cam.generate_rays(self.device, volume=True)
        W, H = self.width, self.height
        ok, axis, flip = can_slice_march(sc, rays.direction)
        if ok:
            return trace_volume_fast(sc, rays, W, H, axis=axis, flip=flip)
        return trace_volume(sc, make_arena(rays, 0), W, H,
                            slice_axes=slice_axes_for(sc, rays.direction))

    def release(self) -> None:
        self.scene = None


DRIVER = ResidentVolumeDriver
