"""What the readers of the program's own spans share. The program
(gravit_tpu_torch/core/timing.py) records a span while a torch.profiler
session is active, and in a run only the traced window is profiled (set-up,
the sync-count frames and the Spans frames run with the profiler off), so
the spans held in this process are the window's. Each function returns
None where the program holds no recorder (a commit before it), where it
recorded nothing, or where its frames do not match the trace's."""

from __future__ import annotations

import importlib

UNATTRIBUTED = "host, between operations"   # trace._idle_gaps' label


def recorded():
    """The program's spans, or None."""
    try:
        timing = importlib.import_module("gravit_tpu_torch.core.timing")
    except ImportError:
        return None
    read = getattr(timing, "recorded", None)
    spans = read() if callable(read) else None
    return spans or None


def frame_spans(trace, frame: str):
    """Every span, when the window recorded one span named `frame` per
    traced frame; else None."""
    spans = recorded()
    if spans is None or not trace.frames:
        return None
    if sum(s.name == frame for s in spans) != trace.frames:
        return None
    return spans


def inside(spans, s, name: str) -> bool:
    """Whether span `s` lies inside a span named `name`."""
    p = s.parent
    while p is not None:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def ms_per_frame(trace, frame: str, name: str, less: str = None):
    """ms per traced frame in the spans named `name`, less the spans named
    `less` inside them; None as frame_spans says."""
    spans = frame_spans(trace, frame)
    if spans is None:
        return None
    ms = sum(s.ms for s in spans if s.name == name)
    if less is not None:
        ms -= sum(s.ms for s in spans
                  if s.name == less and inside(spans, s, name))
    return ms / trace.frames
