"""The train loop: render/train.py's single-device step over views of the
scene; a frame is one Adam step."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare
from portbench.drivers import Driver, port_lights, port_meshes
from portbench.harness import Cell, reference_of
from portbench.orbit import view_poses


class TrainDriver(Driver):
    """render/train.py's single-device step, Adam at the mix's rate, over
    `views.count` views whose targets the reference renders at the
    scene's own parameters. The fit starts from a seeded perturbation:
    each light's colour times U(perturb.light_color) per channel, each
    triangle's kd times U(perturb.kd). Set-up runs the first
    `check_steps` steps through the window's own call and keeps what the
    check compares; the window continues the same fit. The targets'
    seconds are the reference's (`reference_s`), not the program's."""

    def __init__(self, cell: Cell, seed: int, device, film=None):
        super().__init__(cell, seed, device, film)
        self.views = view_poses(self.cfg, self.mix, self.seed)
        rng = np.random.default_rng([self.seed, 1])
        pr = self.mix["perturb"]
        n_lights = len(self.cfg["lights"])
        n_tris = self.scene_data.num_triangles
        self.light_factor = rng.uniform(*pr["light_color"], (n_lights, 3))
        self.kd_factor = rng.uniform(*pr["kd"], n_tris)
        self.rounds = int(self.mix["rounds"])
        self.checked = None

    def _targets(self) -> list:
        ref = reference_of(self.cfg)
        prep, params = ref.prepare(self.scene_data, self.cfg["lights"],
                                   self.device)
        with torch.no_grad():
            return [ref.render(prep, params, self.ref_camera(v),
                               max_rounds=self.rounds) for v in self.views]

    def _perturbed(self, light_color, kd):
        f32 = dict(dtype=torch.float32, device=self.device)
        return (light_color * torch.as_tensor(self.light_factor, **f32),
                kd * torch.as_tensor(self.kd_factor, **f32)[:, None])

    def setup(self) -> None:
        from gravit_tpu_torch.render import train
        from gravit_tpu_torch.render.scene_build import Instance, build_scene
        from gravit_tpu_torch.render.tracer import make_arena
        from gravit_tpu_torch.scene.camera import PerspectiveCamera

        self.scene = build_scene(
            port_meshes(self.scene_data),
            [Instance(mesh_id=i, m=np.asarray(m, np.float32))
             for i, m in self.scene_data.instances],
            port_lights(self.cfg), device=self.device)
        cam = self.cfg["camera"]
        self.arenas = []
        for eye, focus, up in self.views:
            pc = PerspectiveCamera(
                eye=eye, focus=focus, up=up, fov=self.fov,
                film_width=self.width, film_height=self.height,
                samples=int(self.cfg["samples"]),
                max_depth=int(self.cfg["depth"]),
                jitter_window=float(cam["jitter"]))
            self.arenas.append(make_arena(pc.generate_rays(self.device),
                                          self.scene.num_lights))
        t0 = time.perf_counter()
        self.targets = self._targets()
        self.sync()
        self.reference_s = time.perf_counter() - t0
        p = train.params_from_scene(self.scene)
        lc, kd = self._perturbed(p.light_color.detach(), p.kd.detach())
        self.p = p._replace(light_color=lc.requires_grad_(True),
                            kd=kd.requires_grad_(True))
        if self.mix["optimizer"] != "adam":
            raise NotImplementedError(self.mix["optimizer"])
        self.step, make_opt = train.make_train_step(
            train.adam(float(self.mix["lr"])), self.rounds, self.width,
            self.height)
        self.opt = make_opt(list(self.p))
        # the first steps: the window's own call on the window's feed
        p0 = {k: x.detach().clone() for k, x in self.p._asdict().items()}
        losses, g1 = [], None
        for k in range(int(self.mix["check_steps"])):
            loss = self.frame(k)
            losses.append(float(loss))
            if k == 0:
                b1 = self.opt.defaults["betas"][0]
                # an optimizer that took no step holds no moment: zeros
                g1 = {name: self.opt.state.get(x, {}).get(
                    "exp_avg", torch.zeros_like(x)).detach().clone()
                    / (1.0 - b1) for name, x in self.p._asdict().items()}
        p3 = {k: x.detach().clone() for k, x in self.p._asdict().items()}
        self.checked = dict(losses=losses, grad=g1, p0=p0, p_end=p3)
        self.sync()

    def frame(self, k: int):
        v = k % len(self.views)
        self.p, self.opt, loss = self.step(self.p, self.opt, self.scene,
                                           self.arenas[v], self.targets[v])
        return loss

    def release(self) -> None:
        self.scene = self.arenas = self.opt = self.step = self.p = None

    def check(self, kept: list) -> dict:
        """The reference follows the first steps from the same start."""
        ref = reference_of(self.cfg)
        prep, params = ref.prepare(self.scene_data, self.cfg["lights"],
                                   self.device)
        lc, kd = self._perturbed(params.light_color, params.kd)
        leaves = dict(params.leaves(), light_color=lc, kd=kd)
        want = ref_steps(ref, prep, leaves, self, self.targets)
        return compare.train_readings(self.checked, want)


def ref_steps(ref, prep, leaves: dict, drv: TrainDriver, targets: list,
              ar=None) -> dict:
    """The reference's first `check_steps` steps: losses, the first
    gradient, the start and the end."""
    adam = ref.Adam(float(drv.mix["lr"]))
    p0 = {k: x.detach().clone() for k, x in leaves.items()}
    losses, g1 = [], None
    for k in range(int(drv.mix["check_steps"])):
        v = k % len(drv.views)
        req = {n: x.detach().requires_grad_(True) for n, x in leaves.items()}
        loss = ref.loss(prep, ref.Params(**req), drv.ref_camera(drv.views[v]),
                        targets[v], drv.rounds, ar)
        grads = torch.autograd.grad(loss, list(req.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(x) if g is None else g)
                 for (n, x), g in zip(req.items(), grads)}
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = {n: g.detach().clone() for n, g in grads.items()}
        leaves = adam.step({n: x.detach() for n, x in req.items()}, grads)
    return dict(losses=losses, grad=g1, p0=p0, p_end=leaves)


DRIVER = TrainDriver
