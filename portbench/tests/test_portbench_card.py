"""On the card (skipped without one): each cell's run at its own size is
correct for a short window, and the control fails its check there
(portbench/calibrate.py, one seed)."""

import json
import pathlib
import subprocess
import sys

import pytest

from portbench import calibrate, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_json(harness.BENCHMARK)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 1234), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    cell = harness.load_cell(name)
    if cell.traffic["driver"] == "train":
        rows = calibrate.train_cell(cell, [], [2**31 + 55], False, card)
    else:
        rows = calibrate.render_cell(cell, [2**31 + 54], [2**31 + 55], card)
    control = [r for kind, _, r in rows if kind == "control"]
    from portbench import compare

    ok, checks = compare.judge(control[0], cell.limits)
    assert not ok, checks
