"""Interactive trace viewer on the port's api, counterpart of
examples/trace_view_app.py: the GLTrace analog (apps/render/GLTrace.cpp).

The reference's GLTrace is a GLUT window with mouse-drag rotation and
keyboard zoom re-rendering every event (GLTrace.cpp:330, bit-rotted and OFF
in its build, CMakeLists.txt:77-80). A service on the card has no GL
surface, so the same capability, camera manipulation driving continuous
re-renders of a resident scene, is exposed two ways:

  interactive:  commands on stdin   a/d orbit +-  w/s zoom  r reset
                p write PPM  q quit
  scripted:     --orbit N           render N frames of a full turntable
                                    (writes frame_###.ppm, prints fps)

    python -m gravit_tpu_torch.examples.trace_view_app --orbit 8
"""

import argparse
import math
import sys
import time

import numpy as np

from gravit_tpu_torch import api
from gravit_tpu_torch.examples.simple_app import build_scene


class OrbitCamera:
    """Spherical camera rig around a focus point (GLTrace's trackball)."""

    def __init__(self, focus=(0.0, 0.0, 0.0), radius=4.0, fov_deg=45.0):
        self.focus = np.asarray(focus, np.float64)
        self.radius0 = self.radius = float(radius)
        self.fov = math.radians(fov_deg)
        self.theta = 0.0    # azimuth, radians
        self.phi = 0.0      # elevation, radians

    def reset(self):
        self.radius = self.radius0
        self.theta = self.phi = 0.0

    def eye(self):
        ct, st = math.cos(self.theta), math.sin(self.theta)
        cp, sp = math.cos(self.phi), math.sin(self.phi)
        offset = np.asarray([ct * cp, sp, st * cp]) * self.radius
        return self.focus + offset

    def apply(self, name="conecam", fov=None):
        api.modifyCamera(name, list(self.eye()), list(self.focus),
                         [0.0, 1.0, 0.0], self.fov if fov is None else fov)


def frame(renderer, output, write=False):
    t0 = time.time()
    api.render(renderer)
    dt = time.time() - t0
    if write:
        api.writeimage(renderer, output)
    return dt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--wsize", type=int, nargs=2, default=[256, 256])
    p.add_argument("--orbit", type=int, default=0,
                   help="scripted turntable: render N frames over 360 deg")
    p.add_argument("--write-frames", action="store_true",
                   help="write frame_###.ppm for each turntable frame")
    p.add_argument("--output", default="traceview")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args()

    build_scene(int(api.Schedule.Image), tuple(args.wsize), args.output,
                device=args.device)
    rig = OrbitCamera(radius=4.0)
    renderer = "Enzoschedule"

    if args.orbit > 0:
        times = []
        for i in range(args.orbit):
            rig.theta = 2.0 * math.pi * i / args.orbit
            rig.apply()
            dt = frame(renderer, f"{args.output}_frame_{i:03d}",
                       write=args.write_frames)
            times.append(dt)
            print(f"frame {i:3d}  {dt * 1e3:8.1f} ms", flush=True)
        steady = sorted(times[1:] or times)[len(times[1:] or times) // 2]
        print(f"turntable: {args.orbit} frames, first {times[0]:.2f}s "
              f"(kernel builds), steady {steady * 1e3:.1f} ms/frame "
              f"({1.0 / steady:.1f} fps)")
        return

    print("interactive: a/d orbit  w/s zoom  r reset  p write ppm  q quit",
          flush=True)
    rig.apply()
    dt = frame(renderer, args.output)
    print(f"ready ({dt:.2f}s first frame)", flush=True)
    for line in sys.stdin:
        for c in line.strip():
            if c == "q":
                return
            elif c == "a":
                rig.theta -= math.radians(10)
            elif c == "d":
                rig.theta += math.radians(10)
            elif c == "w":
                rig.radius = max(0.5, rig.radius * 0.9)
            elif c == "s":
                rig.radius *= 1.1
            elif c == "r":
                rig.reset()
            elif c == "p":
                api.writeimage(renderer, args.output)
                print(f"wrote {args.output}.ppm", flush=True)
                continue
            else:
                continue
            rig.apply()
            dt = frame(renderer, args.output)
            print(f"{c}: eye={np.round(rig.eye(), 3).tolist()} "
                  f"{dt * 1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
