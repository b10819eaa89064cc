"""Share of the brick passes that the slice engine marched: 100 x
`volume.march_slice` spans / (`volume.march_slice` +
`volume.march_gather` spans) inside the frames' `volume.frame` spans."""

from portbench.metrics._spans import frame_spans

NEEDS = ("profile",)


def read(trace):
    spans = frame_spans(trace, "volume.frame")
    if spans is None:
        return None
    sliced = sum(s.name == "volume.march_slice" for s in spans)
    gathered = sum(s.name == "volume.march_gather" for s in spans)
    if sliced + gathered == 0:
        return None
    return 100.0 * sliced / (sliced + gathered)
