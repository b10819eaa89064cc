"""Share of the lanes the megapass's bounce generations trace that carry a
live ray: 100 x the sum of the program's `tracer.bounce_live` counts (the
lanes queued in a generation g >= 1) over the sum of its
`tracer.bounce_lanes` counts (the arena's width, which each such
generation traces under its mask). The counts are the traced window's
(the program counts only while the profiler or a recording listens). None
where the program holds no counter (a commit before it) or counted no
bounce lane."""

import importlib

NEEDS = ("profile",)


def read(trace):
    try:
        timing = importlib.import_module("gravit_tpu_torch.core.timing")
    except ImportError:
        return None
    counted = getattr(timing, "counted", None)
    sums = counted() if callable(counted) else {}
    lanes = sums.get("tracer.bounce_lanes", 0)
    if not lanes:
        return None
    return 100.0 * sums.get("tracer.bounce_live", 0) / lanes
