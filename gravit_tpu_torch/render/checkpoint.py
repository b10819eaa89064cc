"""Checkpoint and resume of the training state, counterpart of
gravit_tpu/render/checkpoint.py's `.npz` fallback.

The file is the JAX package's npz: one array `leaf_i` per leaf of
{"opt_state": ..., "params": ..., "step": ...} in the pytree's flatten
order (keys sorted), an empty float32 array for a None. The optimiser
state is Adam's, laid out as optax's ScaleByAdamState(count, mu, nu), so
a file written by either package restores in the other: the leaves are
count, mu's four params, nu's four params, then the four params, then
the step. The port writes no orbax checkpoint (orbax is not a dependency
of the port); the JAX package writes one when orbax imports, and its
npz only when it does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gravit_tpu_torch.device import resolve_device
from gravit_tpu_torch.render.train import (AdamState, TrainParams,
                                           adam_state, adam_state_from_leaves)

_N_PARAMS = len(TrainParams._fields)
_N_ADAM = 1 + 2 * _N_PARAMS


def _npz_path(path) -> str:
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save(path, params: TrainParams, opt_state=None, step: int = 0) -> None:
    """Write (params, opt_state, step). `opt_state` is an AdamState, a
    torch.optim.Adam over `params`, or None."""
    if isinstance(opt_state, torch.optim.Adam):
        opt_state = adam_state(opt_state, params)
    if opt_state is None:
        leaves = [np.array([], np.float32)]
    else:
        leaves = [_host(opt_state.count).astype(np.int32),
                  *map(_host, opt_state.mu), *map(_host, opt_state.nu)]
    leaves += [*map(_host, params), np.asarray(int(step))]
    np.savez(_npz_path(path),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def restore(path, device=None
            ) -> Tuple[TrainParams, Optional[AdamState], int]:
    """Read (params, opt_state, step) back onto `device`: params as leaf
    tensors that require grad, opt_state an AdamState (None if none was
    saved)."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(leaves) not in (_N_ADAM + _N_PARAMS + 1, 1 + _N_PARAMS + 1):
        raise ValueError(f"{path}: {len(leaves)} leaves is no training "
                         "state of (Adam | None, 4 params, step)")

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    opt_state = None
    rest = leaves[1:]
    if len(leaves) == _N_ADAM + _N_PARAMS + 1:
        opt_state = adam_state_from_leaves(leaves[:_N_ADAM], device)
        rest = leaves[_N_ADAM:]
    params = TrainParams(*(tensor(a).requires_grad_(True)
                           for a in rest[:_N_PARAMS]))
    return params, opt_state, int(rest[_N_PARAMS])
