"""What a cell is, found by name: BENCHMARK.json's entry, the
configuration's file, the traffic mix's file, the limits of its check and
the readers of its per-layer metrics. Nothing here names a cell, a
configuration or a metric: a later cell, mix or metric is new files."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the
    cell, or, without the key, the cell reports the end-to-end metric it
    moves (end-to-end metrics without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def load_cell(name: str, benchmark: dict = None) -> Cell:
    bench = benchmark if benchmark is not None else load_json(BENCHMARK)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], config=config,
                traffic_name=entry["traffic"], traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def scene_of(config: dict):
    """The configuration's scene, from its frozen generator."""
    mod = importlib.import_module(f"portbench.scenes.{config['scene']}")
    return mod.scene(**config.get("scene_args", {}))


def reference_of(config: dict):
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def metric_reader(name: str):
    """portbench/metrics/<name>.py: NEEDS (the trace data it reads) and
    read(trace) -> number or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
