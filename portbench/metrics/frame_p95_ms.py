"""The 95th percentile of the latency of every frame of the window, from
setting its pose to its framebuffer synchronized on the card."""

import statistics

NEEDS = ("window",)


def read(window):
    if len(window.latencies) < 20:
        return None
    return 1e3 * statistics.quantiles(window.latencies, n=100,
                                      method="inclusive")[94]
