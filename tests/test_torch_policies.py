"""The port's hybrid scheduling policies (gravit_tpu_torch/schedule/
policies.py, a numpy copy) against the JAX package's, on seeded pending-ray
histograms: every policy's residency matrix and primary_owner are equal
(integer logic: no tolerance), and every domain keeps a home."""

import numpy as np
import pytest

import torch_parity  # noqa: F401 (puts the repo root on sys.path)
from gravit_tpu.schedule import policies as jax_policies

from gravit_tpu_torch.schedule import policies


@pytest.mark.parametrize("name", sorted(policies.POLICIES) + ["primary_owner"])
def test_policy_equals_jax(name):
    assert sorted(policies.POLICIES) == sorted(jax_policies.POLICIES)
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n_inst, n_dev = int(rng.integers(1, 12)), int(rng.integers(1, 6))
        # zeros, ties and one hot domain among the seeds
        pending = rng.integers(0, 4, n_inst) * rng.integers(0, 60, n_inst)
        owners = rng.integers(0, n_dev, n_inst).astype(np.int32)
        if name == "primary_owner":
            res = rng.uniform(size=(n_inst, n_dev)) < 0.5
            res[np.arange(n_inst), owners] = True
            np.testing.assert_array_equal(policies.primary_owner(res),
                                          jax_policies.primary_owner(res))
            continue
        got = policies.POLICIES[name](pending.copy(), owners.copy(), n_dev)
        want = jax_policies.POLICIES[name](pending.copy(), owners.copy(),
                                           n_dev)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert got.shape == (n_inst, n_dev) and got.any(axis=1).all()
