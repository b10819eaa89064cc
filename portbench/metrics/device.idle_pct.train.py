"""The share of the traced window in which no operation ran on the card
(1 - union of device intervals / window), in the train cells."""

from portbench.metrics._device import idle_pct

NEEDS = ("profile",)


def read(trace):
    return idle_pct(trace)
