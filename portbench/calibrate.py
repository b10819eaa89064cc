"""The readings a cell's limits are set from, on the card at the cell's
own size, many seeds in one process (the benchmark's own runs do not run
this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults]

  program  the program's answers on each seed, through the driver's own
           frame (render cells: `check_frames` poses of the seed's orbit;
           the train cell: its checked first steps), against the plain
           reference: the lower readings
  control  the reference in TF32 in the program's place, against the
           reference in float32, on each control seed: the upper readings
  fault    (train cell, --faults) the train step with half of the batch
           left out, and with its answer altered (the loss 2% higher),
           on each control seed
One JSON line per reading; the last line sums them up: the largest
program reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import random
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import compare, drivers, harness  # noqa: E402
from portbench.drivers.train import ref_steps  # noqa: E402
from portbench.orbit import Orbit  # noqa: E402
from portbench.reference.precision import Arith  # noqa: E402


FRAMES = 300          # the program's frames are drawn from the first ones


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def render_cell(cell, seeds, control_seeds, dev) -> list:
    out = []
    drv = drivers.make(cell, seeds[0], dev)
    drv.setup()
    ref = harness.reference_of(cell.config)
    prep, params = ref.prepare(drv.scene_data, cell.config["lights"], dev)
    bounds = drivers.scene_bounds(drv.scene_data)
    n = int(cell.traffic["check_frames"])

    def poses_of(seed):
        drv.orbit = Orbit(cell.config, cell.traffic, seed, bounds)
        return sorted(random.Random(seed).sample(range(FRAMES), n))

    for seed in seeds:
        readings = []
        for k in poses_of(seed):
            fb = drv.frame(k)
            drv.sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                want = ref.render(prep, params, drv.ref_camera(drv.pose(k)))
            readings.append(compare.frame_readings(fb, want))
            ref_s = time.perf_counter() - t0
        out.append(("program", seed, compare.worst(readings)))
        emit(kind="program", seed=seed, ref_s_per_frame=ref_s,
             readings=out[-1][2])
    for seed in control_seeds:
        readings = []
        for k in poses_of(seed):
            cam = drv.ref_camera(drv.pose(k))
            with torch.no_grad():
                low = ref.render(prep, params, cam, Arith("tf32"))
                want = ref.render(prep, params, cam)
            readings.append(compare.frame_readings(low, want))
        out.append(("control", seed, compare.worst(readings)))
        emit(kind="control", seed=seed, readings=out[-1][2])
    return out


def _train_readings(cell, seed, dev) -> dict:
    drv = drivers.make(cell, seed, dev)
    drv.setup()
    readings = drv.check([])
    drv.release()
    return readings


def train_cell(cell, seeds, control_seeds, faults: bool, dev) -> list:
    out = []
    for seed in seeds:
        out.append(("program", seed, _train_readings(cell, seed, dev)))
        emit(kind="program", seed=seed, readings=out[-1][2])
    ref = harness.reference_of(cell.config)
    for seed in control_seeds:
        drv = drivers.make(cell, seed, dev)
        prep, params = ref.prepare(drv.scene_data, cell.config["lights"], dev)
        targets = drv._targets()
        lc, kd = drv._perturbed(params.light_color, params.kd)
        leaves = dict(params.leaves(), light_color=lc, kd=kd)
        want = ref_steps(ref, prep, leaves, drv, targets)
        low = ref_steps(ref, prep, leaves, drv, targets, Arith("tf32"))
        out.append(("control", seed, compare.train_readings(low, want)))
        emit(kind="control", seed=seed, readings=out[-1][2])
    if not faults:
        return out
    from gravit_tpu_torch.render import train

    orig = train.loss_fn

    def half(p, scene, arena, target, w, h, rounds=4):
        fb = train.render_with_params(scene, p, arena, w, h, rounds)
        m = fb.shape[0] // 2
        return torch.mean((fb[:m, :3] - target[:m, :3]) ** 2)

    def altered(*a, **kw):
        return orig(*a, **kw) * 1.02

    for name, fn in (("half_batch", half), ("altered", altered)):
        train.loss_fn = fn
        try:
            for seed in control_seeds:
                out.append((f"fault.{name}", seed,
                            _train_readings(cell, seed, dev)))
                emit(kind=f"fault.{name}", seed=seed, readings=out[-1][2])
        finally:
            train.loss_fn = orig
    return out


def summary(rows: list) -> dict:
    kinds = {}
    for kind, _, r in rows:
        agg = kinds.setdefault(kind, {})
        for k, v in r.items():
            v = v if math.isfinite(v) else math.inf
            if kind == "program":
                agg[k] = max(agg.get(k, -math.inf), v)
            else:
                agg[k] = min(agg.get(k, math.inf), v)
    return kinds


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if cell.traffic["driver"] == "train":
        rows = train_cell(cell, seeds, control, args.faults, dev)
    else:
        rows = render_cell(cell, seeds, control, dev)
    emit(workload=cell.name, seconds=time.perf_counter() - t0,
         summary=summary(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
