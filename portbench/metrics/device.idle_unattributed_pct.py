"""The share of the traced window in which the card was idle and no host
event, the program's spans included, was under way: the idle seconds the
trace's gaps credit to "host, between operations", over the window. Read
only where the program records spans (without them nearly every gap is
unattributed)."""

from portbench.metrics._spans import UNATTRIBUTED, recorded

NEEDS = ("profile",)


def read(trace):
    if recorded() is None or not trace.window_s or trace.idle_gaps is None:
        return None
    idle = sum(s for label, s in trace.idle_gaps if label == UNATTRIBUTED)
    return 100.0 * idle / trace.window_s
