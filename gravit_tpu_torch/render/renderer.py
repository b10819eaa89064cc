"""The surface and volume branches of gravit_tpu/render/renderer.py::
Renderer.render (render/Renderer.cpp:37-115), one function each, off the
multi-device arm.

The scheduler enum, the RenderContext database and the api facade are
ROADMAP slice E; the domain and volume-domain schedulers are slice D.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from gravit_tpu_torch.accel.scene_accel import build_scene_bvh
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.render.tracer import (MAX_FAST_DEPTH, make_arena,
                                            trace_image, trace_image_fast,
                                            trace_image_fast_multi)
from gravit_tpu_torch.render.volume_scene import build_volume_scene
from gravit_tpu_torch.render.volume_tracer import (can_slice_march,
                                                   slice_axes_for,
                                                   trace_volume,
                                                   trace_volume_fast)
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import Light
from gravit_tpu_torch.scene.mesh import CompiledMesh
from gravit_tpu_torch.scene.volume import Volume

# meshes below this many triangles take the brute intersector
# (renderer.py:235-242)
BVH_MIN_TRIANGLES = 512


def render_surface(meshes: Sequence[CompiledMesh],
                   instances: Sequence[Instance], lights: Sequence[Light],
                   camera: PerspectiveCamera, device=None, impl=None):
    """Build the scene (and the BVH when the meshes hold 512 or more
    triangles), then render one frame; the single-device branch of the
    reference's Renderer (renderer.py:200-227):
      one instance, max_depth <= 6   trace_image_fast
      otherwise, max_depth <= 1      trace_image_fast_multi
      otherwise                      make_arena + trace_image (looped)
    Returns the (W*H, 4) framebuffer on `device`.

    The gate is `1 <= max_depth`: max_depth 0 raises here instead of
    reaching the reference's IndexError. The BVH path runs the traversal
    kernel on the card and its plain version on the CPU. `impl="plain"`
    forces the plain version on the card (comparisons only).
    """
    device = resolve_device(device)
    if camera.max_depth < 1:
        raise NotImplementedError(
            f"max_depth {camera.max_depth}: a frame needs max_depth >= 1")
    scene = build_scene(meshes, instances, lights, device=device)
    accel = None
    if sum(m.num_triangles for m in meshes) >= BVH_MIN_TRIANGLES:
        accel = build_scene_bvh(meshes, device=device)
    rays = camera.generate_rays(device)
    W, H = camera.film_width, camera.film_height
    if scene.num_instances == 1 and camera.max_depth <= MAX_FAST_DEPTH:
        return trace_image_fast(scene, rays, W, H, accel=accel,
                                samples=camera.samples,
                                max_depth=camera.max_depth, impl=impl)
    if camera.max_depth <= 1:
        return trace_image_fast_multi(scene, rays, W, H, accel=accel,
                                      samples=camera.samples, impl=impl)
    return trace_image(scene, make_arena(rays, scene.num_lights), W, H,
                       accel=accel, impl=impl)


def render_volume(volumes: Sequence[Volume],
                  instances: Sequence[Tuple[int, np.ndarray]],
                  camera: PerspectiveCamera, device=None, impl=None):
    """Build the volume scene and render one frame. `instances` is a list
    of (volume_id, 4x4 world transform). Returns the (W*H, 4) framebuffer
    on `device`.

    One brick in one instance whose rays pass the slice gate renders as the
    single-launch megapass (trace_volume_fast). Anything else takes the
    wavefront tracer, with the slice engine serving each qualifying brick
    and the gather march the rest. On the card the slice engine runs its
    kernels; `impl="plain"` forces its plain version (comparisons only).
    """
    device = resolve_device(device)
    scene = build_volume_scene(volumes, instances, device=device)
    rays = camera.generate_rays(device, volume=True)
    ok, axis, flip = can_slice_march(scene, rays.direction)
    if ok:
        return trace_volume_fast(scene, rays, camera.film_width,
                                 camera.film_height, axis=axis, flip=flip,
                                 impl=impl)
    return trace_volume(scene, make_arena(rays, 0), camera.film_width,
                        camera.film_height,
                        slice_axes=slice_axes_for(scene, rays.direction),
                        impl=impl)
