"""Host ms per frame in the next-instance query of the shuffle and the hop
loops (the instance tree's walk included): the program's
`tracer.instance_search` spans."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "tracer.frame", "tracer.instance_search")
