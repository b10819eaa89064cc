"""The harness finds configurations, traffic, limits and metric readers by
name: a new cell, mix and metric are new files and nothing else."""

import importlib
import json
import pathlib
import shutil
import subprocess
import sys

from portbench import drivers, harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_every_entry_resolves():
    bench = harness.load_json(harness.BENCHMARK)
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert cell.limits
        assert issubclass(importlib.import_module(
            f"portbench.drivers.{cell.traffic['driver']}").DRIVER,
            drivers.Driver)
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            reader = harness.metric_reader(m["name"])
            assert callable(reader.read) and reader.NEEDS
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_new_cell_mix_driver_and_metric_are_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a mix with a new kind of
    loop (its driver), the cell's limits and a metric reader as new files
    plus their BENCHMARK.json entries, and run the new cell (CPU, small
    film, traced): every addition is picked up by name."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(ROOT / "gravit_tpu_torch", tmp_path / "gravit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    bench = harness.load_json(harness.BENCHMARK)
    cfg = harness.load_json(BENCH / "configs" / "bunny_standin.json")
    cfg["scene_args"] = {"seed": 4, "bands": 20}
    pb = tmp_path / "portbench"
    (pb / "configs" / "bunny_small.json").write_text(json.dumps(cfg))
    mix = harness.load_json(BENCH / "traffic" / "resident_orbit.json")
    mix.update(orbit=dict(mix["orbit"], cycle=8), trace_frames=2,
               warmup_frames=1, warmup_seconds=0.0, check_frames=2,
               driver="resident_twice")
    (pb / "drivers" / "resident_twice.py").write_text(
        "from portbench.drivers.resident import ResidentDriver\n\n\n"
        "class ResidentTwice(ResidentDriver):\n"
        "    \"\"\"Each pose's frame twice; the second is the answer.\"\"\"\n\n"
        "    def frame(self, k):\n"
        "        super().frame(k)\n"
        "        return super().frame(k)\n\n\n"
        "DRIVER = ResidentTwice\n")
    (pb / "traffic" / "short_orbit.json").write_text(json.dumps(mix))
    (pb / "limits" / "bunny_small.short_orbit.json").write_text(
        json.dumps({"px_off": 0.001, "sum_rel": 0.001}))
    (pb / "metrics" / "frames_traced.py").write_text(
        'NEEDS = ("profile",)\n\n\ndef read(trace):\n'
        '    return float(trace.frames)\n')
    bench["configs"].append(dict(bench["configs"][0], name="bunny_small",
                                 file="portbench/configs/bunny_small.json"))
    bench["workloads"].append(dict(name="bunny_small.short_orbit",
                                   config="bunny_small",
                                   traffic="short_orbit", chips=1,
                                   why="a test cell"))
    bench["per_layer"].append(dict(
        name="frames_traced", unit="frames", better="higher",
        source="device_trace", layer="device", moves="frame_ms",
        workloads=["bunny_small.short_orbit"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "frame_ms":
            m["workloads"].append("bunny_small.short_orbit")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from portbench import harness, run\n"
        "cell = harness.load_cell('bunny_small.short_orbit')\n"
        "out = [run.run_cell(cell, 9, s, t, device='cpu', film=(32, 32))"
        " for t, s in ((False, 2.0), (True, 120.0))]\n"
        "print(json.dumps([dict(correct=o['correct'], metrics=o['metrics'])"
        " for o in out]))\n"
        "print(type(run.drivers.make(cell, 9, 'cpu')).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ResidentTwice"
    e2e, traced = json.loads(lines[-2])
    assert e2e["correct"] and traced["correct"]
    assert "frame_ms" in e2e["metrics"]
    assert traced["metrics"]["frames_traced"]["value"] == 2.0
