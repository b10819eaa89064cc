"""Host ms per frame compiling the api's meshes for the render: the
program's `facade.compile_meshes` spans."""

from portbench.metrics._spans import ms_per_frame

NEEDS = ("profile",)


def read(trace):
    return ms_per_frame(trace, "facade.render", "facade.compile_meshes")
