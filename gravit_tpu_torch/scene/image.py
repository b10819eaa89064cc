"""Framebuffer + PPM output, counterpart of gravit_tpu/scene/image.py.

Reference semantics: composite/IceTComposite.cpp:103-157 (localAdd clamps
each channel at 1.0; PPM written bottom-to-top with byte = trunc(c*255)).
The framebuffer is a flat `(W*H, 4)` float32 tensor.
"""

from __future__ import annotations

import pathlib

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


def composite(fb, group=None):
    """Cross-device framebuffer reduction (the IceT replacement): the
    members' framebuffers summed over `group` (parallel/), then clamped.
    `fb` is a tensor when this process holds one member of the group, else
    the list of the local members' framebuffers (one result each). Each
    member deposits disjoint or nonnegative-additive pixels, so this is
    IceT's BLEND for the surface path."""
    if group is None:
        return clamp_rgb(fb)
    if isinstance(fb, (list, tuple)):
        return [clamp_rgb(x) for x in group.all_reduce(list(fb))]
    return clamp_rgb(group.all_reduce([fb])[0])


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


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM -> (H, W, 3) uint8, top row first (no comment
    support: the reference writer emits none)."""
    data = pathlib.Path(path).read_bytes()
    parts = data.split(maxsplit=4)
    if parts[0] != b"P6":
        raise ValueError(f"not a binary PPM: {path}")
    w, h, maxval = int(parts[1]), int(parts[2]), int(parts[3])
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}, expected 255")
    raw = parts[4][: w * h * 3]
    return np.frombuffer(raw, dtype=np.uint8).reshape(h, w, 3)


def image_diff(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of differing pixel bytes, the ImageDiff.cpp metric."""
    if a.shape != b.shape:
        return 1.0
    return float(np.mean(a.astype(np.int32) != b.astype(np.int32)))


def max_byte_error(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))
