"""Transfer functions: .cmap/.omap loading + 256-entry LUT resampling,
counterpart of gravit_tpu/scene/transfer.py.

Parity target: TransferFunction::load (TransferFunction.cpp:91-136): both
maps resample onto 256 entries at x = xmin + (i/255)*(xmax-xmin) by
piecewise-linear interpolation; the LUT is then applied over a [low, high]
value range (OSPRay "piecewise_linear" semantics, set() at :76-86).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _resample_256(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Reference resampling loop (TransferFunction.cpp:116-135)."""
    out = np.zeros((256,) + ys.shape[1:], np.float32)
    xmin, xmax = xs[0], xs[-1]
    i0, i1 = 0, 1
    for i in range(256):
        x = min(xmin + (i / 255.0) * (xmax - xmin), xmax)
        while xs[i1] < x:
            i0 += 1
            i1 += 1
        d = (x - xs[i0]) / (xs[i1] - xs[i0])
        out[i] = ys[i0] + d * (ys[i1] - ys[i0])
    return out


@dataclasses.dataclass
class TransferFunction:
    color_lut: np.ndarray    # (256, 3)
    opacity_lut: np.ndarray  # (256,)
    low: float = 0.0
    high: float = 1.0

    @classmethod
    def from_files(cls, cmap_path: str, omap_path: str,
                   low: float = 0.0, high: float = 1.0):
        cdata = _read_table(cmap_path)
        odata = _read_table(omap_path)
        color = _resample_256(cdata[:, 0], cdata[:, 1:4])
        # an .omap is (scalar, opacity); if handed a 4-col .cmap (as
        # gvtVol_serial.py does) use its 2nd column as opacity
        opacity = _resample_256(odata[:, 0], odata[:, 1])
        return cls(color, opacity, float(low), float(high))

    @classmethod
    def gray_ramp(cls, low: float = 0.0, high: float = 1.0,
                  max_opacity: float = 1.0):
        ramp = np.linspace(0.0, 1.0, 256, dtype=np.float32)
        color = np.stack([ramp] * 3, axis=-1)
        return cls(color, (ramp * max_opacity).astype(np.float32),
                   float(low), float(high))

    def device_luts(self, device):
        """(color (256, 3), opacity (256,), vrange (2,)) tensors."""
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.tensor(np.asarray(self.color_lut), **f32),
                torch.tensor(np.asarray(self.opacity_lut), **f32),
                torch.tensor([self.low, self.high], **f32))


def _read_table(path: str) -> np.ndarray:
    """First token = row count, then rows of floats (cmap: 4, omap: 2)."""
    with open(path) as f:
        toks = f.read().split()
    n = int(toks[0])
    vals = np.asarray([float(t) for t in toks[1:]], np.float64)
    cols = len(vals) // n
    return vals[: n * cols].reshape(n, cols)


def tf_span(low, high, like: torch.Tensor) -> torch.Tensor:
    """max(high - low, 1e-30) as a 0-d tensor beside `like`. low/high are
    0-d tensors or Python floats (then the difference is taken in double
    before it is rounded to float32, as the reference's static floats are).
    A tensor, because on the card PyTorch turns a division by a Python
    scalar into a multiply by its reciprocal."""
    span = high - low
    if torch.is_tensor(span):
        return torch.clamp(span, min=1e-30)
    return torch.tensor(max(span, 1e-30), dtype=like.dtype,
                        device=like.device)


def tf_lookup(rgba: torch.Tensor, low, span: torch.Tensor,
              scalar: torch.Tensor):
    """Piecewise-linear lookup of `scalar (...,)` in a `(256, 4)` rgba table
    over [low, low + span]; returns (rgb (..., 3), a (...)). Two row
    gathers and one lerp, the arithmetic of the reference's packed-pair
    lookup. `span` comes from tf_span."""
    x = (scalar - low) / span
    x = torch.clamp(x, 0.0, 1.0) * 255.0
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, 254)
    frac = (x - i0)[..., None]
    v = rgba[i0] * (1 - frac) + rgba[i0 + 1] * frac
    return v[..., 0:3], v[..., 3]


def apply_tf(color_lut, opacity_lut, vrange, scalar):
    """Piecewise-linear LUT lookup over [vrange[0], vrange[1]];
    scalar (...,) -> rgb (..., 3), a (...). Differentiable wrt both LUTs."""
    rgba = torch.cat([color_lut, opacity_lut[:, None]], dim=1)
    return tf_lookup(rgba, vrange[0], tf_span(vrange[0], vrange[1], scalar),
                     scalar)
