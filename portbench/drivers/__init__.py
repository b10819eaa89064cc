"""The loops a window drives, one module per kind of loop, found by the
name a traffic mix gives under "driver": portbench/drivers/<driver>.py,
whose `DRIVER` is the class that runs it. A new kind of loop is a new
file here and nothing else. The kinds so far:

  resident  the scene and its BVH built once in set-up; a frame is the
            camera's rays for the pose and the tracer render_surface
            would pick (render/renderer.py:80-97), without the build
  api       the scene built through the api in set-up; a frame is
            api.modifyCamera, api.render and Renderer.framebuffer
  train     render/train.py's make_train_step over views of the scene;
            a frame is one Adam step

Each driver takes the cell, the seed and the device, builds in `setup()`
(warm-up included) and runs frame k in `frame(k)`, which returns what the
check keeps of it and does not synchronize. `check(kept)` works the kept
answers out again with the plain reference and returns the numbers
compared. What set-up spends in the plain reference (a fit's targets)
goes in `reference_s`, which `setup_s` leaves out. This package holds
what the drivers share; the program (gravit_tpu_torch) is imported by the
drivers and nowhere else in the harness.
"""

from __future__ import annotations

import importlib
import math
import time

import numpy as np
import torch

from portbench import compare
from portbench.harness import Cell, reference_of, scene_of
from portbench.orbit import Orbit


def make(cell: Cell, seed: int, device, film=None) -> "Driver":
    """The driver the cell's mix names, from its own module."""
    mod = importlib.import_module(f"{__name__}.{cell.traffic['driver']}")
    return mod.DRIVER(cell, seed, device, film)


def scene_bounds(scene) -> tuple:
    """(lo, hi) over every instance's box (two corners transformed)."""
    los, his = [], []
    for mesh_id, mat in scene.instances:
        v = np.asarray(scene.meshes[mesh_id].verts, np.float64)
        m = np.asarray(mat, np.float64)
        c0 = m[:3, :3] @ v.min(axis=0) + m[:3, 3]
        c1 = m[:3, :3] @ v.max(axis=0) + m[:3, 3]
        los.append(np.minimum(c0, c1))
        his.append(np.maximum(c0, c1))
    return np.min(los, axis=0), np.max(his, axis=0)


def port_meshes(scene) -> list:
    """The scene's meshes compiled by the program (Mesh.finish)."""
    from gravit_tpu_torch.scene.material import Material
    from gravit_tpu_torch.scene.mesh import Mesh

    out = []
    for m in scene.meshes:
        mesh = Mesh()
        mesh.add_vertices(np.asarray(m.verts, np.float32))
        mesh.add_faces(np.asarray(m.faces) + 1)
        mesh.material = Material(type=int(m.mat_type), kd=tuple(m.kd),
                                 alpha=float(m.alpha))
        out.append(mesh.finish())
    return out


def port_lights(config: dict) -> list:
    from gravit_tpu_torch.scene.light import point_light

    out = []
    for li in config["lights"]:
        if li["kind"] != "point":
            raise NotImplementedError(f"light kind {li['kind']!r}")
        out.append(point_light(li["position"], li["color"]))
    return out


class Driver:
    """What every driver shares: the configuration, the film and the
    reference's view of a camera pose."""

    def __init__(self, cell: Cell, seed: int, device, film=None):
        self.cell, self.seed = cell, int(seed)
        self.cfg, self.mix = cell.config, cell.traffic
        self.device = torch.device(device)
        self.width, self.height = film or self.cfg["film"]
        self.fov = math.radians(self.cfg["camera"]["fov_deg"])
        self.scene_data = scene_of(self.cfg)

    def ref_camera(self, pose):
        ref = reference_of(self.cfg)
        eye, focus, up = pose
        return ref.Camera(eye, focus, up, self.fov, self.width, self.height,
                          int(self.cfg["samples"]),
                          float(self.cfg["camera"]["jitter"]))

    reference_s = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""


class RenderDriver(Driver):
    """Frame k renders pose k of the seeded orbit."""

    def __init__(self, cell: Cell, seed: int, device, film=None):
        super().__init__(cell, seed, device, film)
        self.orbit = Orbit(self.cfg, self.mix, self.seed,
                           bounds=scene_bounds(self.scene_data))

    def pose(self, k: int):
        return self.orbit.pose(k)

    def warm_up(self) -> None:
        """Frames 0.. (the window's own first poses) until the mix's
        `warmup_frames` have run and `warmup_seconds` have passed."""
        t0, k = time.perf_counter(), 0
        frames = int(self.mix["warmup_frames"])
        seconds = float(self.mix.get("warmup_seconds", 0.0))
        while k < frames or time.perf_counter() - t0 < seconds:
            self.frame(k)
            self.sync()
            k += 1

    def check(self, kept: list) -> dict:
        """Worst readings over the kept frames [(k, framebuffer)]."""
        ref = reference_of(self.cfg)
        prep, params = ref.prepare(self.scene_data, self.cfg["lights"],
                                   self.device)
        readings = []
        for k, fb in kept:
            with torch.no_grad():
                want = ref.render(prep, params, self.ref_camera(self.pose(k)))
            readings.append(compare.frame_readings(fb, want))
        return compare.worst(readings)
