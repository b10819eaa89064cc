"""The api loop: the scene built through the api in set-up; a frame is
api.modifyCamera, api.render and Renderer.framebuffer."""

from __future__ import annotations

import numpy as np

from portbench.drivers import RenderDriver


class ApiDriver(RenderDriver):
    RENDERER, CAMERA, FILM = "cell", "cam", "film"

    def setup(self) -> None:
        from gravit_tpu_torch import api

        cfg, cam = self.cfg, self.cfg["camera"]
        api.gvtInit(device=None if self.device.type == "cuda"
                    else str(self.device))
        for i, m in enumerate(self.scene_data.meshes):
            name = f"mesh{i}"
            verts = np.asarray(m.verts, np.float32)
            faces = np.asarray(m.faces, np.int64) + 1
            api.createMesh(name)
            api.addMeshVertices(name, len(verts), verts.ravel())
            api.addMeshTriangles(name, len(faces), faces.ravel())
            api.addMeshMaterial(name, int(m.mat_type), list(m.kd),
                                float(m.alpha))
            api.finishMesh(name)
        for k, (mesh_id, mat) in enumerate(self.scene_data.instances):
            # column-major, as glm::value_ptr hands it over
            api.addInstance(f"inst{k}", f"mesh{mesh_id}",
                            np.asarray(mat, np.float32).T.ravel())
        for k, li in enumerate(cfg["lights"]):
            if li["kind"] != "point":
                raise NotImplementedError(f"light kind {li['kind']!r}")
            api.addPointLight(f"light{k}", li["position"], li["color"])
        api.addCamera(self.CAMERA, cam["eye"], cam["focus"], cam["up"],
                      self.fov, int(cfg["depth"]), int(cfg["samples"]),
                      float(cam["jitter"]))
        api.addFilm(self.FILM, self.width, self.height)
        api.addRenderer(self.RENDERER, int(api.Adapter.Embree),
                        int(api.Schedule[cfg["schedule"]]), self.CAMERA,
                        self.FILM)
        self.warm_up()

    def frame(self, k: int):
        from gravit_tpu_torch import api
        from gravit_tpu_torch.render.renderer import Renderer

        eye, focus, up = self.pose(k)
        api.modifyCamera(self.CAMERA, eye, focus, up, self.fov)
        api.render(self.RENDERER)
        return Renderer.instance().framebuffer(self.RENDERER)

    def release(self) -> None:
        from gravit_tpu_torch.core.context import RenderContext
        from gravit_tpu_torch.render.renderer import Renderer

        Renderer.reset()
        RenderContext.reset()


DRIVER = ApiDriver
