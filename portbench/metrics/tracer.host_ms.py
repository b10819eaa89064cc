"""Host ms per frame inside the tracer call, waits for the card left out:
the program's `tracer.frame` spans less the `tracer.sync` spans inside
them."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "tracer.frame", "tracer.frame",
                        less="tracer.sync")
