"""The traversal kernels' share of their roofline over the first
`roofline_frames` traced frames: the least time the card could take for
the work those frames' rays need (portbench/reference/walk.py: per frame
max(ops / peak fp32 rate, bytes / peak bandwidth), portbench/peaks.py),
over the device time of those frames' traversal kernels, in %."""

from portbench.metrics._device import is_traversal
from portbench.peaks import roofline_s

NEEDS = ("profile", "walk")


def read(trace):
    if not trace.walk or not trace.frame_spans:
        return None
    bound = kernel_s = 0.0
    for work, (s0, s1) in zip(trace.walk, trace.frame_spans):
        bound += roofline_s(work["ops"], work["bytes"])
        kernel_s += sum(e - s for n, s, e in trace.device_ops or ()
                        if is_traversal(n) and s >= s0 and e <= s1)
    if kernel_s <= 0.0:
        return None
    return 100.0 * bound / kernel_s
