"""The port's image scheduler (gravit_tpu_torch/schedule/image_sched.py)
against the JAX package's, on the CPU: the counterparts of
tests/test_out_of_core.py (a scene of four meshes, 36 triangles, streamed
under budgets that hold one cube or two cones) and of the sharded trace
(tests/test_domain_sched.py::test_depth3_area_light_sharding_invariant's
second half), at 24^2 and 32^2 with 2-8 LocalGroup members.

Tolerances: the port's streamed frame equals the port's all-resident
looped frame bit for bit (the JAX contract for depth-1 point-light
frames); the grouping (groups, instance -> group) equals JAX's; frames
against JAX: torch_parity.assert_multi_close (XLA's CPU backend contracts
a*b+c into FMAs, the port rounds each operation); a sharded frame against
the port's resident frame: float |d| < 1e-5 (as the JAX tests bound their
sharded frames).

JAX's frames are committed (the accel runs in interpret mode); refresh
them by hand with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/test_torch_image_sched.py --write-golden
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.schedule import image_sched as jis

from gravit_tpu_torch.parallel import global_mesh
from gravit_tpu_torch.render.scene_build import build_scene
from gravit_tpu_torch.render.tracer import make_arena, trace_image
from gravit_tpu_torch.scene.camera import PerspectiveCamera
from gravit_tpu_torch.scene.light import point_light
from gravit_tpu_torch.schedule import image_sched as ims

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "data" / \
    "torch_port_image_sched_golden.npz"
FILM = 24
BPT = ims.StreamedImageRenderer.BYTES_PER_TRI
BPT_ACCEL = ims.StreamedImageRenderer.BYTES_PER_TRI_ACCEL


def scene4():
    """tests/test_out_of_core.py::_scene: cone, cube, cone, cube (36
    triangles), a 3x3 grid of instances, one point light."""
    cone, cube = chip_smoke.cone_mesh(), chip_smoke.cube_mesh()
    meshes = [cone, cube, cone, cube]
    instances = tp.grid_instances(lambda k: k % 4, n=3, spacing=0.7,
                                  scale=0.45)
    lights = [point_light((3.0, 1.0, -1.0), (1.0, 1.0, 1.0))]
    cam = PerspectiveCamera(
        eye=(4.0, 0.0, 0.0), focus=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
        fov=float(45 * np.pi / 180), film_width=FILM, film_height=FILM,
        samples=1, max_depth=1, jitter_window=0.5)
    return meshes, instances, lights, cam


def resident(meshes, instances, lights, cam, max_rounds=16):
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), scene.num_lights)
    return trace_image(scene, arena, cam.film_width, cam.film_height,
                       max_rounds=max_rounds)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.mark.parametrize("budget", [12, 18, 36])
def test_grouping_equals_jax(budget):
    meshes, instances, lights, _ = scene4()
    sr = ims.StreamedImageRenderer(meshes, instances, lights, budget,
                                   device="cpu")
    ref = jis.StreamedImageRenderer(meshes, instances, lights, budget)
    assert sr.num_groups == ref.num_groups
    np.testing.assert_array_equal(sr.inst_group, ref.inst_group)
    for got, want in zip(sr.host_scenes, ref.host_scenes):
        for name, arr in tp.leaves(want).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                          err_msg=name)
        assert got.num_meshes == want.num_meshes


def test_streamed_matches_resident(gold):
    meshes, instances, lights, cam = scene4()
    sr = ims.StreamedImageRenderer(meshes, instances, lights, 12,
                                   device="cpu")
    assert sr.num_groups >= 3        # genuinely streamed in several loads
    fb = sr.render(cam)
    np.testing.assert_array_equal(
        resident(meshes, instances, lights, cam)[:, :3].numpy(),
        fb[:, :3].numpy())
    assert float(fb[:, :3].sum()) > 0
    tp.assert_multi_close(fb.numpy(), gold["streamed"], FILM, FILM)
    st = sr.stats
    assert st["rounds"] >= 2 and st["fetches"] >= sr.num_groups
    assert st["bytes_h2d"] > 0


def test_budget_below_largest_mesh_rejected():
    meshes, instances, lights, _ = scene4()
    with pytest.raises(ValueError, match="largest mesh"):
        ims.StreamedImageRenderer(meshes, instances, lights, 4, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        ims.StreamedImageRenderer(meshes, instances, lights, device="cpu")


def test_streamed_budget_bytes_and_accel(gold):
    """A byte budget resolves to its triangle equivalent (the same groups);
    with the BVH accel every group's rounds run the traversal, and the
    frame equals the resident frame, as JAX's does within the accel's
    known ulp skew against the brute path."""
    meshes, instances, lights, cam = scene4()
    sr_b = ims.StreamedImageRenderer(meshes, instances, lights,
                                     budget_bytes=12 * BPT, device="cpu")
    sr_t = ims.StreamedImageRenderer(meshes, instances, lights, 12,
                                     device="cpu")
    assert sr_b.num_groups == sr_t.num_groups >= 3
    np.testing.assert_array_equal(sr_b.inst_group, sr_t.inst_group)
    full = resident(meshes, instances, lights, cam)
    np.testing.assert_array_equal(full[:, :3].numpy(),
                                  sr_b.render(cam)[:, :3].numpy())
    sr_a = ims.StreamedImageRenderer(
        meshes, instances, lights, budget_bytes=12 * (BPT + BPT_ACCEL),
        use_accel=True, device="cpu")
    assert sr_a.num_groups >= 3 and sr_a.host_accels is not None
    fb = sr_a.render(cam)
    np.testing.assert_array_equal(full[:, :3].numpy(), fb[:, :3].numpy())
    tp.assert_multi_close(fb.numpy(), gold["streamed_accel"], FILM, FILM)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_trace_image_sharded_matches_jax(gold, n):
    meshes, instances, lights, cam = scene4()
    scene = build_scene(meshes, instances, lights, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    assert arena.capacity % n == 0
    fb = ims.trace_image_sharded(scene, arena, FILM, FILM,
                                 global_mesh(("rays",), (n,), device="cpu"),
                                 max_rounds=16)
    tp.assert_multi_close(fb.numpy(), gold[f"sharded_{n}"], FILM, FILM)
    full = resident(meshes, instances, lights, cam)
    assert float((fb - full)[:, :3].abs().max()) < 1e-5


@pytest.mark.parametrize("n", [1, 3])
def test_render_image_scheduler(n):
    """A group of one traces the whole arena; three members do not divide
    the arena, which is padded with dead lanes."""
    meshes, instances, lights, cam = scene4()
    scene = build_scene(meshes, instances, lights, device="cpu")
    mesh = global_mesh(("rays",), (n,), device="cpu")
    assert make_arena(cam.generate_rays("cpu"), 1).capacity % 3
    fb = ims.render_image_scheduler(scene, cam, mesh, max_rounds=16)
    full = resident(meshes, instances, lights, cam)
    assert float((fb - full)[:, :3].abs().max()) < 1e-5


def test_render_image_scheduler_accel():
    """The image scheduler with the BVH accel: trace_image_sharded's
    `accel` runs every member's rounds through the traversal (its plain
    version on the CPU), the resident frame through the same accel within
    1e-5; render_image_scheduler, like the JAX function, takes none."""
    import inspect

    from gravit_tpu_torch.accel.scene_accel import build_scene_bvh

    meshes, instances, lights, cam = scene4()
    scene = build_scene(meshes, instances, lights, device="cpu")
    accel = build_scene_bvh(meshes, device="cpu")
    arena = make_arena(cam.generate_rays("cpu"), 1)
    full = trace_image(scene, arena, FILM, FILM, max_rounds=16, accel=accel)
    fb = ims.trace_image_sharded(
        scene, arena, FILM, FILM, global_mesh(("rays",), (2,), device="cpu"),
        max_rounds=16, accel=accel)
    assert float((fb - full)[:, :3].abs().max()) < 1e-5
    assert "accel" not in inspect.signature(
        ims.render_image_scheduler).parameters


def write_golden(path=GOLDEN) -> None:
    """JAX's frames for the tests above (run by hand)."""
    from gravit_tpu.render.scene_build import build_scene as jax_build
    from gravit_tpu.render.tracer import make_arena as jax_arena

    meshes, instances, lights, cam = scene4()
    jcam = tp.jax_camera(cam)
    out = {"streamed": np.asarray(jis.StreamedImageRenderer(
        meshes, instances, lights, 12).render(jcam))}
    with tp.pallas_interpret():
        out["streamed_accel"] = np.asarray(jis.StreamedImageRenderer(
            meshes, instances, lights, budget_bytes=12 * (BPT + BPT_ACCEL),
            use_accel=True).render(jcam))
    scene = jax_build(meshes, instances, lights)
    arena = jax_arena(jcam.generate_rays(), 1)
    for n in (2, 4, 8):
        out[f"sharded_{n}"] = np.asarray(jis.trace_image_sharded(
            scene, arena, FILM, FILM, tp.jax_mesh((n,), ("rays",)),
            max_rounds=16))
    np.savez_compressed(path, **out)


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        write_golden()
        print("wrote", GOLDEN)
