"""Host ms per frame in Renderer.render outside its tracer call: the
program's `facade.render` spans less the `tracer.frame` spans inside them
(the meshes' compile, the builds with their uploads, the camera, the
facade's own Python)."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "facade.render", "facade.render",
                        less="tracer.frame")
