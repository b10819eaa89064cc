"""The resident loop: the scene and its BVH built once in set-up; a frame
is the camera's rays for the pose and the tracer render_surface would
pick (render/renderer.py:80-97), without the build."""

from __future__ import annotations

import numpy as np

from portbench.drivers import RenderDriver, port_lights, port_meshes


class ResidentDriver(RenderDriver):
    def setup(self) -> None:
        from gravit_tpu_torch.accel.scene_accel import build_scene_bvh
        from gravit_tpu_torch.render.renderer import BVH_MIN_TRIANGLES
        from gravit_tpu_torch.render.scene_build import Instance, build_scene

        meshes = port_meshes(self.scene_data)
        self.scene = build_scene(
            meshes, [Instance(mesh_id=i, m=np.asarray(m, np.float32))
                     for i, m in self.scene_data.instances],
            port_lights(self.cfg), device=self.device)
        self.accel = None
        if sum(m.num_triangles for m in meshes) >= BVH_MIN_TRIANGLES:
            self.accel = build_scene_bvh(meshes, device=self.device)
        self.warm_up()

    def frame(self, k: int):
        from gravit_tpu_torch.render import tracer as tr
        from gravit_tpu_torch.scene.camera import PerspectiveCamera

        eye, focus, up = self.pose(k)
        depth, samples = int(self.cfg["depth"]), int(self.cfg["samples"])
        cam = PerspectiveCamera(
            eye=eye, focus=focus, up=up, fov=self.fov,
            film_width=self.width, film_height=self.height, samples=samples,
            max_depth=depth, jitter_window=float(self.cfg["camera"]["jitter"]))
        rays = cam.generate_rays(self.device)
        W, H, sc = self.width, self.height, self.scene
        if sc.num_instances == 1 and depth <= tr.MAX_FAST_DEPTH:
            return tr.trace_image_fast(sc, rays, W, H, accel=self.accel,
                                       samples=samples, max_depth=depth)
        if depth <= 1:
            return tr.trace_image_fast_multi(sc, rays, W, H, accel=self.accel,
                                             samples=samples)
        return tr.trace_image(sc, tr.make_arena(rays, sc.num_lights), W, H,
                              accel=self.accel)

    def release(self) -> None:
        self.scene = self.accel = None


DRIVER = ResidentDriver
