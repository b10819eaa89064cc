"""What a `--trace 1` run reads, from the benchmark's side of the program:

  profile  torch.profiler (CUPTI) over `trace_frames` frames: the device
           operations and their intervals, the kernels launched under the
           autograd engine's backward, the host operations (for the idle
           gaps' causes), each frame's interval; the window is the span
           "portbench.window"
  syncs    host syncs per frame, by torch.cuda's sync debug mode (a copy
           of chip_smoke.observe_frame's count)
  spans    host-clock spans the benchmark wraps around the program's
           calls (facade: build_scene and build_scene_bvh where
           render/renderer.py calls them), each ending in a sync
  walk     the work the first `roofline_frames` traced frames' rays need
           in the traversal kernels, counted by portbench/reference/walk.py
A metric's reader (portbench/metrics/<name>.py) names what it needs and
reads it from the Trace; a reader that finds nothing returns None.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
import warnings

import torch

HOST_RUNTIME = ("Runtime Triggered Module Loading", "Lazy Function Loading",
                "Activity Buffer Request")
BACKWARD = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class Trace:
    frames: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list = None        # [(name, start_s, end_s)] in the window
    frame_spans: list = None       # [(start_s, end_s)] per frame
    backward_s: float = 0.0        # device time of kernels under backward
    idle_gaps: list = None         # [(host op, seconds)], longest first
    syncs_per_frame: float = None
    spans: dict = None             # {name: seconds per frame}
    walk: list = None              # the first frames' work, walk.py's


def _busy_intervals(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_window(run_frame, frames: int, seconds: float, sync) -> Trace:
    """Run frames 0.. under the profiler, `frames` of them or until
    `seconds` have passed, each frame in a span that ends with its sync."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    n = 0
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        with record_function("portbench.window"):
            t0 = time.perf_counter()
            while n < frames and (n == 0 or time.perf_counter() - t0
                                  < seconds):
                with record_function("portbench.frame"):
                    run_frame(n)
                    sync()
                n += 1
    events = prof.events()
    win = next(e for e in events if e.name == "portbench.window")
    w0, w1 = win.time_range.start, win.time_range.end
    frame_spans = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                         for e in events if e.name == "portbench.frame")
    # the spans above show on the device's timeline too: not operations
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA
           and not e.name.startswith("portbench.")
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _busy_intervals([(max(s, w0), min(e, w1)) for _, s, e in dev])
    backward = 0.0
    host = []
    for e in events:
        if e.device_type != DeviceType.CPU or e.name.startswith("portbench."):
            continue
        host.append((e.time_range.start, e.time_range.end, e.name))
        if e.kernels and e.name not in HOST_RUNTIME:
            p = e.cpu_parent
            while p is not None and not p.name.startswith(BACKWARD):
                p = p.cpu_parent
            if p is not None:
                backward += sum(k.duration for k in e.kernels) * 1e-6
    return Trace(
        frames=n, window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_ops=[(name, s * 1e-6, e * 1e-6) for name, s, e in dev],
        frame_spans=frame_spans, backward_s=backward,
        idle_gaps=_idle_gaps(busy, w0, w1, host))


def _idle_gaps(busy: list, w0: float, w1: float, host: list) -> list:
    """The window's idle time by the innermost host operation under way
    at each gap's middle, longest total first."""
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    by = collections.defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host, between operations"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by[label] += (e - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])


def count_syncs(run_frame, frames: int, sync) -> float:
    """Host syncs per frame: sync debug mode's warnings over `frames`
    frames (the frames' own closing syncs are outside it)."""
    n = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            for k in range(frames):
                run_frame(k)
                n += 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync()
    return sum("synchroniz" in str(w.message) for w in caught) / max(n, 1)


class Spans:
    """Host-clock spans around module attributes the program calls: each
    call's time, ended by a sync, summed by span name."""

    def __init__(self, targets: dict, sync):
        self.targets, self.sync = targets, sync
        self.totals = collections.defaultdict(float)
        self._saved = []

    def __enter__(self):
        for name, (module, attr) in self.targets.items():
            orig = getattr(module, attr)

            def timed(*a, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                self.sync()
                self.totals[_name] += time.perf_counter() - t0
                return out

            self._saved.append((module, attr, orig))
            setattr(module, attr, timed)
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()
