"""Small-vector math, counterpart of gravit_tpu/core/math3d.py.

The 3-vector helpers work on `(..., 3)` tensors and write their sums out
left to right (the order XLA's reduce takes), so results do not depend on a
backend's reduction order. The transform builders are host-side numpy.
Reference semantics: src/gvt/core/Math.h; instance transforms as
SimpleApp.cpp:170-172 and api.cpp:303-306 build them.
"""

from __future__ import annotations

import numpy as np
import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last (size-3) axis of a * b, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def norm3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(a, a))


def mat4_translate_scale(t, s):
    """T @ S composite, matching glm::scale(glm::translate(I, t), s)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag(np.asarray(s, dtype=np.float32))
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def normal_matrix(m):
    """transpose(inverse(mat3(m))) as in reference api.cpp:303-306."""
    m = np.asarray(m, dtype=np.float32)
    return np.transpose(np.linalg.inv(m[:3, :3])).astype(np.float32)
