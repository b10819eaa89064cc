"""Wavefront rounds per frame of the volume tracer: the program's
`volume.round` spans over its `volume.frame` spans (one a frame)."""

from portbench.metrics._spans import frame_spans

NEEDS = ("profile",)


def read(trace):
    spans = frame_spans(trace, "volume.frame")
    if spans is None:
        return None
    return sum(s.name == "volume.round" for s in spans) / trace.frames
