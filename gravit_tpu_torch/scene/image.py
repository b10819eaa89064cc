"""Framebuffer + PPM output, counterpart of gravit_tpu/scene/image.py.

Reference semantics: composite/IceTComposite.cpp:103-157 (localAdd clamps
each channel at 1.0; PPM written bottom-to-top with byte = trunc(c*255)).
The framebuffer is a flat `(W*H, 4)` float32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def new_framebuffer(width: int, height: int, device) -> torch.Tensor:
    return torch.zeros((width * height, 4), dtype=torch.float32,
                       device=device)


def local_add(fb: torch.Tensor, pixel_id, color, alpha, mask) -> torch.Tensor:
    """Accumulate masked per-ray contributions, clamping rgb at 1.0.

    `pixel_id (N,) int32`, `color (N,3)`, `alpha (N,)`, `mask (N,) bool`.
    On the card `index_add_` sums duplicate pixels with atomics, so their
    order (and the last float bit) varies from run to run.
    """
    rgba = torch.cat([color, alpha[:, None]], dim=-1)
    fb = fb.index_add(0, pixel_id[mask].to(torch.int64), rgba[mask])
    return clamp_rgb(fb)


def clamp_rgb(fb: torch.Tensor) -> torch.Tensor:
    """Clamp rgb channels at 1.0."""
    return torch.cat([torch.clamp(fb[:, :3], max=1.0), fb[:, 3:]], dim=-1)


def to_rgb8(fb, width: int, height: int) -> np.ndarray:
    """Flat rgba float framebuffer -> (H, W, 3) uint8, top row first.

    Truncating byte conversion and bottom-to-top row flip replicate
    IceTComposite::write (IceTComposite.cpp:144-153).
    """
    if isinstance(fb, torch.Tensor):
        fb = fb.detach().cpu().numpy()
    img = np.asarray(fb)[:, :3].reshape(height, width, 3)
    img = np.clip(img, 0.0, 1.0)
    img = (img * 255.0).astype(np.uint8)
    return img[::-1]


def write_ppm(path: str, fb, width: int, height: int) -> None:
    rgb = to_rgb8(fb, width, height)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (width, height))
        f.write(rgb.tobytes())
