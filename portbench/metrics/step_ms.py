"""Wall time of the whole window over the Adam steps completed in it (each
step ends synchronized on the card)."""

NEEDS = ("window",)


def read(window):
    if not window.count:
        return None
    return 1e3 * window.seconds / window.count
