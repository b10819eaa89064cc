"""Kernel launches per frame: the device kernels torch.profiler saw in the
traced window (copies and fills not counted), over the frames."""

from portbench.metrics._device import is_kernel

NEEDS = ("profile",)


def read(trace):
    if not trace.device_ops or not trace.frames:
        return None
    return sum(is_kernel(n) for n, _, _ in trace.device_ops) / trace.frames
