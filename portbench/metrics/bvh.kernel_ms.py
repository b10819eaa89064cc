"""Device ms per frame of the traversal kernels (bvh_traverse_kernel and
the packets' direction-sign kernel it launches first), found by name in
the profiler's trace."""

from portbench.metrics._device import is_traversal

NEEDS = ("profile",)


def read(trace):
    if not trace.frames:
        return None
    ms = [e - s for n, s, e in trace.device_ops or () if is_traversal(n)]
    if not ms:
        return None
    return 1e3 * sum(ms) / trace.frames
