"""The surface branch of gravit_tpu/render/renderer.py::Renderer.render
(render/Renderer.cpp:37-115), as one function.

The scheduler enum, the RenderContext database and the api facade are
ROADMAP slice E; scenes off the single-instance megapass are slice C.
"""

from __future__ import annotations

from typing import Sequence

from gravit_tpu_torch.accel.scene_accel import build_scene_bvh
from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render.scene_build import Instance, build_scene
from gravit_tpu_torch.render.tracer import MAX_FAST_DEPTH, trace_image_fast
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import Light
from gravit_tpu_torch.scene.mesh import CompiledMesh

# meshes below this many triangles take the brute intersector
# (renderer.py:235-242)
BVH_MIN_TRIANGLES = 512


def render_surface(meshes: Sequence[CompiledMesh],
                   instances: Sequence[Instance], lights: Sequence[Light],
                   camera: PerspectiveCamera, device=None, impl=None):
    """Build the scene (and the BVH when the meshes hold 512 or more
    triangles), then render one frame with the single-instance megapass.
    Returns the (W*H, 4) framebuffer on `device`.

    The gate is `1 <= max_depth <= 6`: max_depth 0 raises here instead of
    reaching the reference's IndexError. The BVH path runs the traversal
    kernel on the card and its plain version on the CPU. `impl="plain"`
    forces the plain version on the card (comparisons only).
    """
    device = resolve_device(device)
    if len(instances) != 1:
        raise NotImplementedError(
            "multi-instance rendering (trace_image_fast_multi, trace_image) "
            "is not ported yet (ROADMAP slice C)")
    if not 1 <= camera.max_depth <= MAX_FAST_DEPTH:
        raise NotImplementedError(
            f"max_depth {camera.max_depth}: the megapass covers "
            f"1..{MAX_FAST_DEPTH}; the looped tracer is ROADMAP slice C")
    scene = build_scene(meshes, instances, lights, device=device)
    accel = None
    if sum(m.num_triangles for m in meshes) >= BVH_MIN_TRIANGLES:
        accel = build_scene_bvh(meshes, device=device)
    return trace_image_fast(scene, camera.generate_rays(device),
                            camera.film_width, camera.film_height,
                            accel=accel, samples=camera.samples,
                            max_depth=camera.max_depth, impl=impl)
