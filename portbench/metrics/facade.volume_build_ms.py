"""Host ms per frame of the facade's volume build: the program's
`facade.volume_build` spans (the volume arm's read of the bricks from the
database and render_volume's build_volume_scene, the bricks' upload
included). None where the program records no such span (a program
without it)."""

from portbench.metrics._spans import frame_spans, ms_per_frame

NEEDS = ("profile",)
SPAN = "facade.volume_build"


def read(trace):
    spans = frame_spans(trace, "facade.render")
    if spans is None or not any(s.name == SPAN for s in spans):
        return None
    return ms_per_frame(trace, "facade.render", SPAN)
