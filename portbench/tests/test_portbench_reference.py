"""The plain reference agrees with the program at a small film on the CPU,
on each cell's path, through the harness's own run and check."""

import math

import pytest
import torch

from portbench import compare, drivers, harness
from portbench.drivers.train import ref_steps
from portbench import run as bench

CELLS = ["bunny_standin.resident_orbit", "gvt_simple.api_orbit",
         "gvt_simple.train", "bunny_standin.api_orbit"]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_on_the_cpu(small_cell, name):
    cell = small_cell(name)
    res = bench.run_cell(cell, 2**31 + 99, 0.5, False, device="cpu",
                         film=(32, 32))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    names = {m["name"] for m in cell.end_to_end}
    # a tail needs 20 frames, more than this short window holds
    assert set(res["metrics"]) | {"frame_p95_ms"} >= names
    assert "setup_s" in res["metrics"]


def test_reference_frame_equals_the_programs(small_cell):
    """render_surface and the reference at 48^2, three poses of SimpleApp's
    orbit: equal but for float rounding."""
    from gravit_tpu_torch.render.renderer import render_surface
    from gravit_tpu_torch.render.scene_build import Instance
    from gravit_tpu_torch.scene.camera import PerspectiveCamera

    cell = small_cell("gvt_simple.api_orbit")
    drv = drivers.make(cell, 5, "cpu", (48, 48))
    ref = harness.reference_of(cell.config)
    prep, params = ref.prepare(drv.scene_data, cell.config["lights"], "cpu")
    meshes = drivers.port_meshes(drv.scene_data)
    inst = [Instance(i, m) for i, m in drv.scene_data.instances]
    for k in (0, 17, 40):
        eye, focus, up = drv.pose(k)
        fb = render_surface(meshes, inst, drivers.port_lights(cell.config),
                            PerspectiveCamera(
                                eye=eye, focus=focus, up=up, fov=drv.fov,
                                film_width=48, film_height=48,
                                jitter_window=0.5), device="cpu")
        want = ref.render(prep, params, drv.ref_camera(drv.pose(k)))
        r = compare.frame_readings(fb, want)
        assert r["px_off"] == 0.0 and r["sum_rel"] < 1e-5, r
        assert float(want[:, 3].sum()) > 0


def test_reference_train_steps_follow_the_programs(small_cell):
    cell = small_cell("gvt_simple.train")
    drv = drivers.make(cell, 21, "cpu", (32, 32))
    drv.setup()
    ref = harness.reference_of(cell.config)
    prep, params = ref.prepare(drv.scene_data, cell.config["lights"], "cpu")
    lc, kd = drv._perturbed(params.light_color, params.kd)
    want = ref_steps(ref, prep, dict(params.leaves(), light_color=lc, kd=kd),
                     drv, drv.targets)
    r = compare.train_readings(drv.checked, want)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4, r
    assert r["change_gap"] < 0.01, r
    assert all(math.isfinite(x) for x in want["losses"])
    # the fit moves: the reference's loss falls from its start
    assert want["losses"][-1] < want["losses"][0]


def test_culling_skips_only_what_no_ray_reaches(small_cell, monkeypatch):
    """The reference with its triangle boxes gives the brute-force frame,
    bit for bit, at a pose and scene where the boxes skip most blocks."""
    from portbench.reference import surface as S

    cell = small_cell("bunny_standin.resident_orbit")
    cell.config = dict(cell.config, scene_args={"seed": 2, "bands": 60})
    drv = drivers.make(cell, 8, "cpu", (48, 48))
    prep, params = S.prepare(drv.scene_data, cell.config["lights"], "cpu")
    lit = 0
    for k in range(4):
        cam = drv.ref_camera(drv.pose(k))
        monkeypatch.setattr(S, "CULL_MIN", 256)
        monkeypatch.setattr(S, "RAY_GROUP", 64)
        culled = S.render(prep, params, cam)
        monkeypatch.setattr(S, "CULL_MIN", 10**9)
        brute = S.render(prep, params, cam)
        assert torch.equal(culled, brute)
        lit += float(brute[:, 3].sum()) > 0
    assert lit >= 2
