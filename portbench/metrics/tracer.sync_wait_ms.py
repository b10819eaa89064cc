"""Host ms per frame the tracer waits for the card's answer (hop-loop and
round tests, the instance walk's pointer tests): the program's
`tracer.sync` spans."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "tracer.frame", "tracer.sync")
