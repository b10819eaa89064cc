"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): what a roofline share is taken against.
A run prints the card's name and power limit beside the share."""

FP32_FLOPS = 67e12            # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # 80 GB HBM3


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time for `ops` fp32 operations moving `nbytes` bytes."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
