"""Phase timer, counters and wavefront occupancy, counterpart of
gravit_tpu/core/timing.py.

Reference: gvt::core::time::timer (core/utils/timer.h:38-194) accumulates
per-phase wall time. Here a host wall-clock Timer times eager calls
(trace_image_stepped's `timer` times each round; a round ends with its
host sync, so the span covers the card's work). global_counter
(core/utils/global_counter.h:34-54) sums named counts across ranks: here
GlobalCounter.device_sum all-reduces over a group (parallel/).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict


class Timer:
    """Accumulating named phase timer (timer.h semantics: start/stop
    accumulate; print per frame)."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        # the rank-0 per-phase print (DomainTracer.h:187-196)
        return "\n".join(f"{k:>16s}: {v*1000:9.2f} ms  ({self.counts[k]}x)"
                         for k, v in sorted(self.totals.items()))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class GlobalCounter:
    """Named host counters; `device_sum` all-reduces device values over a
    group (global_counter.h:41-54)."""

    def __init__(self):
        self.values: Dict[str, int] = collections.defaultdict(int)

    def add(self, name: str, n: int) -> None:
        self.values[name] += int(n)

    @staticmethod
    def device_sum(value, group=None):
        """The sum of `value` over the members of `group`: a tensor when
        this process holds one member, else the list of the local members'
        tensors (one result each). With no group, `value` itself."""
        if group is None:
            return value
        if isinstance(value, (list, tuple)):
            return group.all_reduce(list(value))
        return group.all_reduce([value])[0]

    def report(self) -> str:
        return "\n".join(f"{k:>24s}: {v}" for k, v in
                         sorted(self.values.items()))


def count_rays(arena) -> dict:
    """Wavefront occupancy: live lanes, queued lanes, capacity."""
    active = arena.active
    queued = active & (arena.inst >= 0)
    return {"active": int(active.sum()), "queued": int(queued.sum()),
            "capacity": int(active.shape[0])}
