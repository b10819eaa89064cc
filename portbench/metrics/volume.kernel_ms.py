"""Device ms per frame of the slice engine's kernels (K4 and K5, the
template `slice_kernel` of csrc/slice_march.cu), found by name in the
profiler's trace."""

NEEDS = ("profile",)
KERNEL = "slice_kernel"


def read(trace):
    if not trace.frames:
        return None
    ms = [e - s for n, s, e in trace.device_ops or () if KERNEL in n]
    if not ms:
        return None
    return 1e3 * sum(ms) / trace.frames
