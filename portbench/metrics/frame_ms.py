"""Wall time of the whole window over the frames completed in it (each
frame ends with its framebuffer synchronized on the card)."""

NEEDS = ("window",)


def read(window):
    if not window.count:
        return None
    return 1e3 * window.seconds / window.count
