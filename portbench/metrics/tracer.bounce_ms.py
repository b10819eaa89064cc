"""Host ms per frame in the megapass's bounce generations, waits for the
card left out: the program's `tracer.bounce` spans (one a generation
g >= 1 of trace_image_fast: its object-space transform, hit query and
shading) less the `tracer.sync` spans inside them, over the `tracer.frame`
count. None where the program records no `tracer.bounce` span (a commit
before it, or a depth-1 frame)."""

from portbench.metrics._spans import frame_spans, ms_per_frame

NEEDS = ("profile",)


def read(trace):
    spans = frame_spans(trace, "tracer.frame")
    if spans is None or not any(s.name == "tracer.bounce" for s in spans):
        return None
    return ms_per_frame(trace, "tracer.frame", "tracer.bounce",
                        less="tracer.sync")
