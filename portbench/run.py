"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's scene and warms up every shape its traffic uses;
then the window runs frames (or train steps) for `--seconds`, closed loop.
With --trace 0 the line carries the cell's end-to-end metrics; with
--trace 1 a shorter window runs under the profiler and the line carries
its per-layer metrics, the device's busy time and a breakdown. Either way,
once the window has closed and the program's state is freed, the plain
reference works a seeded sample of the window's answers out again, and
`correct` says whether each number compared stays within its limit. The
numbers compared are the last lines on standard error and the last key of
the result line.

Exit codes: 0 with a result line; 2 without a card (or fewer than the cell
asks for); 3 if the process holds jax, jaxlib, flax or the JAX package
once the window has closed; 1 on any other failure.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import compare, drivers, harness, trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gravit_tpu")
BREAKDOWN_ENTRIES = 10
HOST_THREADS = 4      # torch's CPU threads: the same on every machine


@dataclasses.dataclass
class Window:
    seconds: float
    count: int
    latencies: list
    setup_s: float


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (gravit_tpu_torch is not gravit_tpu)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(**fields) -> None:
    print(json.dumps(fields), file=sys.stderr, flush=True)


class Reservoir:
    """A uniform sample of `size` of the window's answers, drawn from the
    seed (reservoir sampling): the answers the check compares."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)
        self.n, self.kept = 0, []

    def offer(self, k: int, answer) -> None:
        if self.n < self.size:
            self.kept.append((k, answer))
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.size:
                self.kept[j] = (k, answer)
        self.n += 1


def nvidia_smi(fields: str) -> str:
    """The card's `fields` as nvidia-smi reads them (name, power limit,
    clocks, temperature, power draw)."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def readers(metrics: list) -> dict:
    return {m["name"]: harness.metric_reader(m["name"]) for m in metrics}


def _number(v):
    return v if v is None or math.isfinite(v) else None


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", film=None) -> dict:
    """Set up, run the window, check; the result's dict (without the
    device's identity where the device is not a card)."""
    dev = torch.device(device)
    drv = drivers.make(cell, seed, dev, film)
    check_n = int(cell.traffic.get("check_frames", 0))
    sample = Reservoir(check_n, seed)
    first = int(cell.traffic.get("check_steps", 0))  # steps set-up ran
    drv.setup()
    # the reference's share of set-up (a fit's targets) is not the program's
    setup_s = time.perf_counter() - T0 - drv.reference_s
    log(setup_s=setup_s, reference_s=drv.reference_s)
    mets = readers(cell.per_layer if trace else cell.end_to_end)
    out = {}
    # no collector pauses in the window: what set-up left is frozen out of
    # every collection, and the collector is off; a frame frees its
    # tensors by reference count and leaves few cycles (the api loop: a
    # handful of ctypes pointers a frame), collected once it closes
    gc.collect()
    gc.freeze()
    gc.disable()
    if not trace:
        lat, k = [], first
        t_start = time.perf_counter()
        while True:
            f0 = time.perf_counter()
            answer = drv.frame(k)
            drv.sync()
            f1 = time.perf_counter()
            lat.append(f1 - f0)
            if check_n:
                sample.offer(k, answer)
            k += 1
            if f1 - t_start >= seconds:
                break
        window = Window(f1 - t_start, len(lat), lat, setup_s)
        tenth = max(1, len(lat) // 10)
        log(ms_by_tenth=[1e3 * sum(lat[i:i + tenth]) / len(lat[i:i + tenth])
                         for i in range(0, len(lat), tenth)][:10],
            card_after=nvidia_smi("clocks.sm,clocks.mem,temperature.gpu,"
                                  "power.draw,pstate")
            if dev.type == "cuda" else None)
        values = {n: r.read(window) for n, r in mets.items()}
        attempted = len(lat)
        trace_data = None
    else:
        needs = set().union(*(getattr(r, "NEEDS", ()) for r in mets.values()))

        def traced_frame(i):
            answer = drv.frame(first + i)
            if check_n:
                sample.offer(first + i, answer)

        frames = int(cell.traffic.get("trace_frames",
                                      cell.traffic.get("trace_steps", 1)))
        trace_data = tr.profile_window(traced_frame, frames, seconds,
                                       drv.sync)
        attempted = trace_data.frames
        base = first + trace_data.frames
        if "syncs" in needs and dev.type == "cuda":
            n_sync = min(frames, 5)
            trace_data.syncs_per_frame = tr.count_syncs(
                lambda i: drv.frame(base + i), n_sync, drv.sync)
            base += n_sync
        targets = {}
        for r in mets.values():
            targets.update(getattr(r, "SPANS", {}))
        if "spans" in needs and targets:
            resolved = {n: (importlib.import_module(m), a)
                        for n, (m, a) in targets.items()}
            n_span = min(frames, 5)
            with tr.Spans(resolved, drv.sync) as spans:
                for i in range(n_span):
                    drv.frame(base + i)
                    drv.sync()
            trace_data.spans = {n: s / n_span
                                for n, s in spans.totals.items()}
        values = None
    gc.enable()
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    out["attempted"] = attempted
    out["trace"] = trace_data
    # the program's state goes before the reference runs
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        if "walk" in needs and hasattr(drv, "pose"):
            from portbench.reference import walk
            n_walk = min(trace_data.frames,
                         int(cell.traffic.get("roofline_frames", 1)))
            trace_data.walk = walk.frame_work(
                drv.scene_data, cell.config["lights"],
                [drv.ref_camera(drv.pose(first + i)) for i in range(n_walk)],
                dev)
            log(walk=trace_data.walk)
        values = {n: r.read(trace_data) for n, r in mets.items()}
    out["metrics"] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = _number(values[m["name"]])
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    t_check = time.perf_counter()
    readings = drv.check(sample.kept)
    log(readings=readings, kept=[k for k, _ in sample.kept],
        check_s=time.perf_counter() - t_check)
    correct, checks = compare.judge(readings, cell.limits)
    out["correct"] = correct
    out["checks"] = checks
    return out


def breakdown(trace_data) -> dict:
    ops = {}
    for name, s, e in trace_data.device_ops:
        ops[name[:160]] = ops.get(name[:160], 0.0) + (e - s)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n[:160], v] for n, v in
                          trace_data.idle_gaps[:BREAKDOWN_ENTRIES]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} once the window has "
              f"closed", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]), "failed": 0,
            "metrics": res["metrics"], "device": device}
    if args.trace:
        t = res["trace"]
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = breakdown(t)
    log(card=nvidia_smi("name,power.limit,clocks.max.sm"), cell=cell.name,
        seed=args.seed,
        attempted=res["attempted"])
    checks = {n: {"value": _number(c["value"]), "limit": c["limit"]}
              for n, c in res["checks"].items()}
    line["checks"] = checks
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
