"""Helpers the readers share: which device operations are kernels, and
which belong to the traversal."""

TRAVERSAL = ("bvh_traverse_kernel", "packet_dpos_kernel")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_traversal(name: str) -> bool:
    return any(k in name for k in TRAVERSAL)


def idle_pct(trace):
    if not trace.window_s or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
