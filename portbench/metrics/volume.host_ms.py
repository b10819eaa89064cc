"""Host ms per frame inside the volume tracer, waits for the card left
out: the program's `volume.frame` spans less the `tracer.sync` spans
inside them (the round tests, the gates' reductions)."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "volume.frame", "volume.frame",
                        less="tracer.sync")
