"""The readings a volume cell's limits are set from, on the card at the
cell's own size, many seeds in one process (the benchmark's own runs do
not run this):

    python3 portbench/calibrate_volume.py --workload <cell> \
        --seeds 1,2,... --control-seeds 7,8,9

  program  the program's frames through the driver's own frame, at the
           `check_frames` poses of each seed's orbit that calibrate.py
           draws, against the plain reference: the lower readings
  control  for each control of portbench/reference/volume.py (the bricks
           in bfloat16, no opacity correction, no shared layer), the
           reference so made against the reference, at the same poses of
           each control seed: the upper readings
One JSON line per reading; the last line sums them up as calibrate.py's
does: the largest program reading and the smallest reading of each
control.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import compare, drivers, harness  # noqa: E402
from portbench.calibrate import FRAMES, emit, summary  # noqa: E402
from portbench.orbit import Orbit  # noqa: E402


def poses(cell, drv, seed) -> list:
    """The frames calibrate.py draws for `seed`, the driver's orbit turned
    to the seed's."""
    drv.orbit = Orbit(cell.config, cell.traffic, seed,
                      drv.scene_data.bounds())
    n = int(cell.traffic["check_frames"])
    return sorted(random.Random(seed).sample(range(FRAMES), n))


def volume_cell(cell, seeds, control_seeds, dev) -> list:
    out = []
    ref = harness.reference_of(cell.config)
    drv = drivers.make(cell, seeds[0], dev)
    rate = float(cell.config["sampling_rate"])

    def prepared(control=None):
        return ref.prepare(drv.scene_data, cell.config["transfer"], dev,
                           control=control, sampling_rate=rate)

    drv.setup()
    prep = prepared()
    for seed in seeds:
        readings = []
        for k in poses(cell, drv, seed):
            fb = drv.frame(k)
            drv.sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                want = ref.render(prep, drv.ref_camera(drv.pose(k)))
            readings.append(compare.frame_readings(fb, want))
            ref_s = time.perf_counter() - t0
        out.append(("program", seed, compare.worst(readings)))
        emit(kind="program", seed=seed, ref_s_per_frame=ref_s,
             readings=out[-1][2])
    drv.release()
    del prep
    want = {}
    prep = prepared()
    for seed in control_seeds:
        for k in poses(cell, drv, seed):
            with torch.no_grad():
                want[seed, k] = ref.render(prep,
                                           drv.ref_camera(drv.pose(k)))
    del prep
    for control in ref.CONTROLS:
        prep = prepared(control)
        for seed in control_seeds:
            readings = []
            for k in poses(cell, drv, seed):
                with torch.no_grad():
                    low = ref.render(prep, drv.ref_camera(drv.pose(k)))
                readings.append(compare.frame_readings(low, want[seed, k]))
            out.append((f"control.{control}", seed,
                        compare.worst(readings)))
            emit(kind=f"control.{control}", seed=seed, readings=out[-1][2])
        del prep
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_volume: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    t0 = time.perf_counter()
    rows = volume_cell(cell, seeds, control, torch.device("cuda"))
    emit(workload=cell.name, seconds=time.perf_counter() - t0,
         summary=summary(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
