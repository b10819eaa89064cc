"""Phase spans, counters and wavefront occupancy, counterpart of
gravit_tpu/core/timing.py.

Reference: gvt::core::time::timer (core/utils/timer.h:38-194) accumulates
per-phase wall time and DomainTracer prints it per frame
(DomainTracer.h:187-196). Here one recorder serves both: the program
enters `span(name)` at the boundaries of its layers (the facade, the
camera, the tracer's phases, the train step), and a span records only
while someone listens:

  * inside `recording()`, the operator's entry, whose `report()` prints
    each name's total ms, count and self ms;
  * while a torch.profiler session is active; each span then also opens a
    profiler host event of its name, so the spans sit on the device
    trace's timeline and clock. The event is a function-scope record, not
    a user annotation (record_function's kind), which the profiler would
    mirror onto the device's timeline.

Otherwise `span` returns one shared no-op context: a flag check, no
allocation, no sync. A span never waits for the card either: its times
are the host's (time.perf_counter_ns), which is what paces an eager
frame. Records stay in memory until `clear()`: `recorded()` reads them,
each (name, start_ns, end_ns, parent, root), parent and root being
indices into the same list (None and its own index for a root), so the
root says which frame or step a span belongs to. Spans nest on the
thread that renders.

A count is the span's companion for a quantity: `count(name, value)`
records `value` under `name` while someone listens, as `span` does, and
keeps it as given, a device scalar included: no `.item()`, no sync.
`counted()` sums each name's values on the host once the work is done
(a read of a device value waits for the card there). A caller whose value
would cost a launch tests `listening()` before it computes it, so that
nothing runs while no one listens.

global_counter (core/utils/global_counter.h:34-54) sums named counts
across ranks: here GlobalCounter.device_sum all-reduces over a group
(parallel/).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import List, NamedTuple, Optional

import torch

_profiler_on = torch._C._autograd._profiler_enabled
_ProfilerEvent = torch._C._profiler._RecordFunctionFast   # function scope


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]   # index of the enclosing span, None for a root
    root: int               # index of the outermost enclosing span

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_records: list = []     # [name, start_ns, end_ns, parent, root], preorder
_open: List[int] = []   # indices of the spans entered and not yet left
_counts: list = []      # [(name, value)] in the order recorded
_listeners = 0          # recording() contexts open


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "index", "event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.event = None
        if _profiler_on():
            self.event = _ProfilerEvent(self.name)
            self.event.__enter__()
        self.index = len(_records)
        parent = _open[-1] if _open else None
        root = self.index if parent is None else _records[parent][4]
        _open.append(self.index)
        _records.append([self.name, time.perf_counter_ns(), 0, parent, root])
        return None

    def __exit__(self, *exc):
        _records[self.index][2] = time.perf_counter_ns()
        _open.pop()
        if self.event is not None:
            self.event.__exit__(None, None, None)
        return False


def listening() -> bool:
    """Whether a recording() or a torch.profiler session is active: what
    span and count record under."""
    return bool(_listeners) or _profiler_on()


def span(name: str):
    """A context that records the host time spent inside it under `name`
    while a recording() or a torch.profiler session is active, and does
    nothing otherwise."""
    if _listeners or _profiler_on():
        return _On(name)
    return _OFF


def count(name: str, value) -> None:
    """Record `value` (a number or a 0-d tensor) under `name` while someone
    listens; nothing otherwise. The value is kept as given: no copy to the
    host, no sync."""
    if _listeners or _profiler_on():
        _counts.append((name, value))


def counted() -> dict:
    """{name: the sum of its recorded values} over the counts not cleared,
    as Python numbers; reads device values, so it waits for the card."""
    out = {}
    for name, value in _counts:
        v = value.item() if isinstance(value, torch.Tensor) else value
        out[name] = out.get(name, 0) + v
    return out


def spanned(name: str):
    """Decorator: every call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def recorded(since: int = 0) -> List[Span]:
    """The spans recorded (from index `since` on) and not cleared; a span
    still open has end_ns 0."""
    return [Span(*r) for r in _records[since:]]


def clear() -> None:
    """Forget every recorded span and count; not inside an open span, whose
    index would dangle."""
    if _open:
        raise RuntimeError("clear() inside an open span")
    _records.clear()
    _counts.clear()


def _by_name(spans: List[Span], since: int) -> dict:
    """{name: [total ms, count, self ms]} over `spans` (recorded(since)):
    self ms is a span's time less its children's."""
    out = collections.defaultdict(lambda: [0.0, 0, 0.0])
    for s in spans:
        row = out[s.name]
        row[0] += s.ms
        row[1] += 1
        row[2] += s.ms
        if s.parent is not None and s.parent >= since:
            out[spans[s.parent - since].name][2] -= s.ms
    return dict(out)


class Recording:
    """What one recording() saw: the spans from `since` on."""

    def __init__(self, since: int):
        self.since = since

    def spans(self) -> List[Span]:
        return recorded(self.since)

    def report(self) -> str:
        """One line per span name: total ms, count and self ms (the
        rank-0 per-phase print of DomainTracer.h:187-196)."""
        rows = _by_name(self.spans(), self.since)
        return "\n".join(f"{k:>24s}: {v[0]:10.2f} ms  ({v[1]}x)  self "
                         f"{v[2]:10.2f} ms"
                         for k, v in sorted(rows.items()))


@contextlib.contextmanager
def recording():
    """Record every span entered inside, with no profiler:
        with timing.recording() as rec:
            api.render("Enzoschedule")
        print(rec.report())"""
    global _listeners
    rec = Recording(len(_records))
    _listeners += 1
    try:
        yield rec
    finally:
        _listeners -= 1


class GlobalCounter:
    """`device_sum` all-reduces device values over a group
    (global_counter.h:41-54)."""

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


def count_rays(arena) -> dict:
    """Wavefront occupancy: live lanes, queued lanes, capacity."""
    active = arena.active
    queued = active & (arena.inst >= 0)
    return {"active": int(active.sum()), "queued": int(queued.sum()),
            "capacity": int(active.shape[0])}
