"""Counter-based per-ray RNG (sharding-invariant sampling), bit-exact with
gravit_tpu/core/rng.py.

The reference hashes in uint32. PyTorch has no `>>` on uint32 tensors on the
CPU, so the hash runs in int64 holding values in [0, 2^32). Products by the
32-bit constants would overflow int64, so `_mul32` multiplies in 16-bit
halves: every intermediate stays below 2^49 and the low 32 bits are exact on
any device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """xxhash/murmur-style avalanche on uint32 values held in int64."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def round_extra(round_idx, depth: torch.Tensor) -> torch.Tensor:
    """uint32(round) * 2654435761 + uint32(depth) * 40503, wrapped to 32
    bits: the per-generation decorrelation counter of the tracer.
    `round_idx` is an int (the wavefront round) or a per-lane tensor (the
    multi-instance megapass passes each ray's freeze round)."""
    if isinstance(round_idx, torch.Tensor):
        r = _mul32(round_idx.to(torch.int64) & MASK32, 2654435761)
    else:
        r = (int(round_idx) * 2654435761) & MASK32
    return (r + _mul32(depth.to(torch.int64) & MASK32, 40503)) & MASK32


def hash_uniform(ray_id: torch.Tensor, salt: int, extra=None) -> torch.Tensor:
    """Uniform [0,1) float32 per lane from (ray_id, salt[, extra])."""
    h = _mix((ray_id.to(torch.int64) & MASK32)
             ^ ((salt * 0x9E3779B9) & MASK32))
    if extra is not None:
        h = _mix(h ^ (extra.to(torch.int64) & MASK32))
    # 24-bit mantissa like the reference's (seed & 0xFFFFFF)/0x1000000
    return (h >> 8).to(torch.float32) / float(1 << 24)


def hash_uniform2(ray_id: torch.Tensor, salt: int, extra=None) -> torch.Tensor:
    """(N, 2) uniforms."""
    u1 = hash_uniform(ray_id, salt * 2 + 1, extra)
    u2 = hash_uniform(ray_id, salt * 2 + 2, extra)
    return torch.stack([u1, u2], dim=-1)
