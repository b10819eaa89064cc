"""Host ms per step in the train step's forward (the unrolled looped
tracer and the loss): the program's `train.forward` spans."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "train.forward", "train.forward")
