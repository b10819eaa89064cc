"""gravit_tpu_torch: the PyTorch + CUDA port of gravit_tpu for NVIDIA Hopper.

The package mirrors gravit_tpu's layout (core/, scene/, accel/, ops/,
render/) so each module's counterpart is found under the same name. It
imports torch, never jax, and nothing of gravit_tpu: numpy host code it
needs is copied, not shared.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
device given and no CUDA present they raise (see `device.resolve_device`).
The one hand-written kernel (`csrc/bvh_traverse.cu`) is built with nvcc at
first use; on CPU tensors its plain PyTorch twin runs instead.
"""

from gravit_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
