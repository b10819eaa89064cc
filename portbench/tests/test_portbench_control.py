"""The control fails every cell's check: the plain reference put in the
program's place and computed in TF32 (the step below the configurations'
float32 with TF32 off), at a small film on the CPU. portbench/
calibrate.py reads the same control on the card at the cells' own
size."""

import pytest

from portbench import compare, drivers, harness
from portbench.drivers.train import ref_steps
from portbench.reference.precision import Arith

RENDER = ["bunny_standin.resident_orbit", "gvt_simple.api_orbit",
          "bunny_standin.api_orbit"]


@pytest.mark.parametrize("name", RENDER)
def test_render_control_fails(small_cell, name):
    cell = small_cell(name)
    drv = drivers.make(cell, 2**31 + 17, "cpu", (48, 48))
    ref = harness.reference_of(cell.config)
    prep, params = ref.prepare(drv.scene_data, cell.config["lights"], "cpu")
    readings = []
    for k in range(3):
        cam = drv.ref_camera(drv.pose(k))
        low = ref.render(prep, params, cam, Arith("tf32"))
        readings.append(compare.frame_readings(low, ref.render(prep, params,
                                                               cam)))
    ok, checks = compare.judge(compare.worst(readings), cell.limits)
    assert not ok, checks


def test_train_control_fails(small_cell):
    cell = small_cell("gvt_simple.train")
    drv = drivers.make(cell, 2**31 + 17, "cpu", (32, 32))
    ref = harness.reference_of(cell.config)
    prep, params = ref.prepare(drv.scene_data, cell.config["lights"], "cpu")
    targets = drv._targets()
    lc, kd = drv._perturbed(params.light_color, params.kd)
    leaves = dict(params.leaves(), light_color=lc, kd=kd)
    want = ref_steps(ref, prep, leaves, drv, targets)
    low = ref_steps(ref, prep, leaves, drv, targets, Arith("tf32"))
    ok, checks = compare.judge(compare.train_readings(low, want),
                               cell.limits)
    assert not ok, checks
