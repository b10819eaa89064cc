"""Entry points of the whole pipeline at a small size, counterpart of the
repo root's __graft_entry__.py, over the port's groups (parallel/) in
place of virtual XLA devices.

    entry()               (fn, args): a single-device forward render
    dryrun_multichip(n)   one domain-scheduled forward (brute, through the
                          traversal kernel, with replica routing), one
                          volume-domain forward, and one data-parallel
                          differentiable train step, over an n-member
                          layout ("domains", "rays")

    python -m gravit_tpu_torch.dryrun [n] [--device cpu]

The members of a LocalGroup run in this process, one after another, on
`device` (the card by default).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from gravit_tpu_torch.core.math3d import mat4_translate_scale
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.examples.simple_app import (CONE_FACES, CONE_VERTS,
                                                  CUBE_FACES, CUBE_VERTS)
from gravit_tpu_torch.parallel.distributed import global_mesh
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.render.tracer import make_arena, trace_image
from gravit_tpu_torch.render.train import (make_sharded_train_step,
                                           params_from_scene)
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import point_light
from gravit_tpu_torch.scene.material import Material
from gravit_tpu_torch.scene.mesh import Mesh
from gravit_tpu_torch.scene.volume import Volume, wavelet_volume
from gravit_tpu_torch.schedule.domain_sched import (DomainRenderer,
                                                    one_hot_residency)
from gravit_tpu_torch.schedule.volume_domain import (partition_volume_scene,
                                                     trace_volume_domain)

FILM = 16   # the dry run's film, FILM x FILM (the JAX dry run's)


def _mesh(verts, faces):
    m = Mesh()
    m.add_vertices(np.asarray(verts, np.float32).reshape(-1, 3))
    m.add_faces(np.asarray(faces).reshape(-1, 3))
    m.material = Material(kd=(1.0, 1.0, 1.0))
    return m.finish()


def simple_app(width: int = 32, height: int = 32, max_depth: int = 1):
    """SimpleApp (SimpleApp.cpp:164-186): (meshes, instances, lights,
    camera), a 5 x 5 grid of alternating cones and cubes scaled by 0.4 at
    0.5 spacing, one point light, and the camera of the JAX package's tests
    (tests/scenes.py::simple_scene, golden jitter)."""
    meshes = [_mesh(CONE_VERTS, CONE_FACES), _mesh(CUBE_VERTS, CUBE_FACES)]
    instances = [Instance(mesh_id=k % 2, m=mat4_translate_scale(
        (0.0, i * 0.5, j * 0.5), (0.4, 0.4, 0.4)))
        for k, (i, j) in enumerate((i, j) for i in range(-2, 3)
                                   for j in range(-2, 3))]
    lights = [point_light((1.0, 0.0, -1.0), (1.0, 1.0, 1.0))]
    camera = PerspectiveCamera(
        eye=(4.0, 0.0, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        fov=float(45.0 * np.pi / 180.0), film_width=width,
        film_height=height, samples=1, max_depth=max_depth,
        jitter_window=0.5, jitter_mode="golden")
    return meshes, instances, lights, camera


def bricked_wavelet(n: int = 16, parts: int = 2) -> list:
    """The wavelet of n^3 samples split along x into `parts` bricks of
    n/parts + 1 planes, neighbours sharing one sample plane; the last brick
    is padded to the others' shape by repeating its last plane (the
    two-brick scene of the JAX package's volume-domain tests at parts=2)."""
    full = wavelet_volume(n)
    s, w = full.samples, n // parts
    ones = np.ones(3, np.float32)
    out = []
    for i in range(parts):
        brick = s[:, :, i * w:i * w + w + 1]
        if brick.shape[2] < w + 1:
            brick = np.concatenate([brick, s[:, :, -1:]], axis=2)
        out.append(Volume(samples=brick.copy(),
                          origin=np.array([i * w, 0, 0], np.float32),
                          spacing=ones, tf=full.tf))
    return out


def entry(device=None):
    """(fn, args): fn(*args) is a forward render of SimpleApp at 32^2."""
    device = resolve_device(device)
    meshes, instances, lights, cam = simple_app(32, 32)
    scene = build_scene(meshes, instances, lights, device=device)
    arena = make_arena(cam.generate_rays(device), scene.num_lights)
    fn = functools.partial(trace_image, width=32, height=32, max_rounds=16)
    return fn, (scene, arena)


def dryrun_multichip(n_devices: int, device=None,
                     return_frames: bool = False):
    """The full sharded pipeline at FILM x FILM over a layout of
    n_devices members, ("domains", "rays") = (n/2, 2) for even n >= 4,
    else (1, n). Returns each forward's frame sum and the train step's
    loss (with return_frames: and a dict of the forwards' frames); raises
    if a frame or the loss is not finite."""
    device = resolve_device(device)
    shape = ((n_devices // 2, 2) if n_devices >= 4 and n_devices % 2 == 0
             else (1, n_devices))
    layout = global_mesh(("domains", "rays"), shape, device=device)
    film = FILM
    meshes, instances, lights, cam = simple_app(film, film)
    out, frames = {}, {}

    def finite(name, fb):
        if not bool(torch.isfinite(fb).all()):
            raise RuntimeError(f"dryrun: {name} frame is not finite")
        out[name] = float(fb.sum())
        frames[name] = fb

    # 1. domain-scheduled forward (the model-parallel axis)
    dr = DomainRenderer.build(meshes, instances, lights, layout,
                              axis="domains")
    finite("domain_forward", dr.render(cam, max_rounds=8))
    # 1b. the same through the traversal kernel (its plain version on the
    # CPU)
    dr_accel = DomainRenderer.build(meshes, instances, lights, layout,
                                    axis="domains", use_accel=True)
    finite("accel_domain_forward", dr_accel.render(cam, max_rounds=8))
    # 1c. multi-hot residency: domain 0 resident on every domain member,
    # its rays routed round-robin over the replicas by pixel id
    n_dom = shape[0]
    res = one_hot_residency(np.arange(len(instances)) % n_dom, n_dom)
    res[0, :] = True
    dr_rep = DomainRenderer.build(meshes, instances, lights, layout,
                                  axis="domains", resident=res)
    finite("replica_routed_forward", dr_rep.render(cam, max_rounds=8))

    # 1d. volume-domain forward (brick migration and the flag protocol)
    nvol = 16
    c = (nvol - 1) / 2.0
    vcam = PerspectiveCamera(
        eye=(4.0 * nvol,) * 3, focus=(c, c, c), up=(0.0, 0.0, 1.0),
        fov=float(30 * np.pi / 180), film_width=film, film_height=film,
        samples=1, max_depth=1)
    eye4 = np.eye(4, dtype=np.float32)
    vmesh = global_mesh(("domains",), (2,), device=device)
    stacked, owners = partition_volume_scene(
        bricked_wavelet(nvol), [(0, eye4), (1, eye4)], 2, device=device)
    varena = make_arena(vcam.generate_rays(device, volume=True), 0)
    finite("volume_domain_forward", trace_volume_domain(
        stacked, owners, varena, film, film, vmesh, max_rounds=8))

    # 2. data-parallel differentiable train step (the rays axis)
    scene = build_scene(meshes, instances, lights, device=device)
    arena = make_arena(cam.generate_rays(device), scene.num_lights)
    step, optimizer = make_sharded_train_step(layout, ray_axis="rays",
                                              rounds=3, width=film,
                                              height=film)
    p = params_from_scene(scene)
    opt = optimizer(list(p))
    target = torch.zeros((film * film, 4), dtype=torch.float32,
                         device=device)
    p, opt, loss = step(p, opt, scene, arena, target)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"dryrun: non-finite loss {float(loss)}")
    out["train_loss"] = float(loss)
    out["layout"] = layout.shape
    return (out, frames) if return_frames else out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    print(f"dryrun_multichip({args.n}):",
          dryrun_multichip(args.n, device=args.device))


if __name__ == "__main__":
    main()
