"""The api volume loop: the bricks handed to the api in set-up, one volume
and one identity instance each, as VolApp does; a frame is
api.modifyCamera, api.render and Renderer.framebuffer (the facade's volume
arm builds the volume scene from the database on every render)."""

from __future__ import annotations

import numpy as np

from portbench.drivers.resident_volume import VolumeDriver


class ApiVolumeDriver(VolumeDriver):
    RENDERER, CAMERA, FILM = "cell", "cam", "film"

    def setup(self) -> None:
        from gravit_tpu_torch import api

        cfg, cam = self.cfg, self.cfg["camera"]
        api.gvtInit(device=None if self.device.type == "cuda"
                    else str(self.device))
        tf, rate = self.transfer(), float(cfg["sampling_rate"])
        eye4 = np.eye(4, dtype=np.float32).ravel()
        for i, b in enumerate(self.scene_data.bricks):
            name = f"vol{i}"
            api.createVolume(name)
            # the transfer function as VolApp's reader attaches it
            # (examples/vol_app.py); api.addVolumeTransferFunctions reads
            # .cmap / .omap files
            api._db().find(name)["tf"] = tf
            nz, ny, nx = b.samples.shape
            api.addVolumeSamples(name, b.samples.reshape(-1), [nx, ny, nz],
                                 list(b.origin), [1.0, 1.0, 1.0], rate)
            api.addInstance(f"inst{i}", name, eye4)
        api.addCamera(self.CAMERA, cam["eye"], cam["focus"], cam["up"],
                      self.fov, int(cfg["depth"]), int(cfg["samples"]),
                      float(cam["jitter"]))
        api.addFilm(self.FILM, self.width, self.height)
        api.addRenderer(self.RENDERER, int(api.Adapter.Pvol),
                        int(api.Schedule[cfg["schedule"]]), self.CAMERA,
                        self.FILM, volume=True)
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


DRIVER = ApiVolumeDriver
