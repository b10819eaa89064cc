"""Device resolution and float32 precision switches.

fp32 means fp32: TF32 matmuls/convolutions keep ~3 decimal digits, the
card's form of the MXU-bf16 trap the JAX package documents (3x3 transforms
lowered as low-precision matmuls put 13% of pixels off by up to 127
bytes). The port writes its 3x3 transforms as broadcast-multiply + sums
anyway; the switches guard any matmul that appears later.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda (raises if CUDA is absent); otherwise the named device.
    Also turns TF32 off for matmuls and convolutions.

    Never drops to the CPU on its own: a CPU run is always the caller's
    explicit choice (`device="cpu"`, as the tests pass).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gravit_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the plain PyTorch path explicitly")
        return torch.device("cuda")
    return torch.device(device)
