"""Device ms per step of the kernels launched under the autograd engine's
backward (a host operation inside autograd::engine::evaluate_function
launched them), from the profiler's trace."""

NEEDS = ("profile",)


def read(trace):
    if not trace.frames or not trace.device_ops or trace.backward_s <= 0.0:
        return None
    return 1e3 * trace.backward_s / trace.frames
