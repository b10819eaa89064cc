"""Arithmetic of the reference in the precision a run asks for.

"float32" is the configurations' stated precision. "tf32" is the control:
the step below float32 with TF32 off, as a tensor core takes a float32
product (each operand rounded to 10 mantissa bits, the sum kept in
float32). It is applied to every product the reference forms, and passes
gradients straight through.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even); the gradient is
    the identity. For finite float32 values below 2^127."""
    b = x.detach().contiguous().view(torch.int32)
    r = ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class Arith:
    """mul / dot / cross in the run's precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision: {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self._q = tf32_round if precision == "tf32" else None

    def mul(self, a, b):
        if self._q is None:
            return a * b
        a = self._q(a) if torch.is_tensor(a) else a
        b = self._q(b) if torch.is_tensor(b) else b
        return a * b

    def dot(self, a, b):
        m = self.mul(a, b)
        return m[..., 0] + m[..., 1] + m[..., 2]

    def cross(self, a, b):
        m = self.mul
        return torch.stack([m(a[..., 1], b[..., 2]) - m(a[..., 2], b[..., 1]),
                            m(a[..., 2], b[..., 0]) - m(a[..., 0], b[..., 2]),
                            m(a[..., 0], b[..., 1]) - m(a[..., 1], b[..., 0])],
                           dim=-1)

    def norm(self, a):
        """sqrt(max(|a|^2, 1e-30)) over the last axis."""
        return torch.sqrt(torch.clamp(self.dot(a, a), min=1e-30))

    def transform(self, m3, x):
        """(3, 3) matrix times (..., 3) vectors, as sums of products."""
        return torch.stack([self.mul(x[..., 0], m3[r, 0])
                            + self.mul(x[..., 1], m3[r, 1])
                            + self.mul(x[..., 2], m3[r, 2])
                            for r in range(3)], dim=-1)
