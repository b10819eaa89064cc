"""Hybrid scheduling policies — domain->device (re)assignment heuristics.
A copy of gravit_tpu/schedule/policies.py (numpy only).

Reference: schedule/hybrid/*.h — pluggable policies the HybridScheduler
used to remap domains to ranks between frames from gathered (domain,
#pending-rays) maps (algorithm/HybridTracer.h:223-299):
  Greedy              first-come assignment           (GreedySchedule.h:55-78)
  Spread              only to idle procs              (SpreadSchedule.h)
  RayWeightedSpread   sort by pending rays, balance   (EGPGV 2012)
  LoadOnce            stable data, balance once       (TVCG 2013)
  LoadAnyOnce         reassign hot domains once       (TVCG 2013)
  LoadAnother         add one replica for hot domains (TVCG 2013)
  LoadMany            replicate until devices full    (TVCG 2013)
  AdaptiveSend        demand-driven replication       (AdaptiveSendSchedule.h)

Here a policy maps `pending[I]` (rays queued per domain, summed across the
group) to a residency matrix `resident[I, D]` (bool: domain i has its data
on device d). Single-owner policies return one-hot rows; replication
policies return multi-hot rows. The domain scheduler repartitions between
frames from this matrix (the analog of loading a domain on another
rank).
"""

from __future__ import annotations

import numpy as np


def _one_hot(owner: np.ndarray, n_dev: int) -> np.ndarray:
    out = np.zeros((owner.shape[0], n_dev), bool)
    out[np.arange(owner.shape[0]), owner] = True
    return out


def greedy(pending: np.ndarray, owners: np.ndarray, n_dev: int) -> np.ndarray:
    """First-come: walk domains in id order, assign each nonempty domain to
    the next device round-robin; empty domains keep their owner."""
    new = owners.copy()
    d = 0
    for i in np.argsort(-pending, kind="stable"):
        if pending[i] > 0:
            new[i] = d % n_dev
            d += 1
    return _one_hot(new, n_dev)


def spread(pending: np.ndarray, owners: np.ndarray, n_dev: int) -> np.ndarray:
    """Assign nonempty domains only to devices that have no work yet; the
    rest keep their owner."""
    load = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        load[d] = pending[owners == d].sum()
    new = owners.copy()
    idle = [d for d in range(n_dev) if load[d] == 0]
    for i in np.argsort(-pending, kind="stable"):
        if pending[i] > 0 and idle:
            new[i] = idle.pop(0)
    return _one_hot(new, n_dev)


def ray_weighted_spread(pending: np.ndarray, owners: np.ndarray,
                        n_dev: int) -> np.ndarray:
    """Sort domains by pending rays desc, place each on the least-loaded
    device (the EGPGV'12 policy; longest-processing-time balancing)."""
    load = np.zeros(n_dev, np.int64)
    new = owners.copy()
    for i in np.argsort(-pending, kind="stable"):
        d = int(np.argmin(load))
        new[i] = d
        load[d] += pending[i]
    return _one_hot(new, n_dev)


def load_once(pending: np.ndarray, owners: np.ndarray,
              n_dev: int) -> np.ndarray:
    """Keep data where it is (loads are expensive): identity assignment."""
    return _one_hot(owners, n_dev)


def load_any_once(pending: np.ndarray, owners: np.ndarray,
                  n_dev: int) -> np.ndarray:
    """Move only the single hottest domain to the least-loaded device."""
    load = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        load[d] = pending[owners == d].sum()
    new = owners.copy()
    if pending.size and pending.max() > 0:
        hot = int(np.argmax(pending))
        cold = int(np.argmin(load))
        new[hot] = cold
    return _one_hot(new, n_dev)


def load_another(pending: np.ndarray, owners: np.ndarray,
                 n_dev: int) -> np.ndarray:
    """Replicate: hottest domain gains ONE extra replica on the
    least-loaded other device."""
    res = _one_hot(owners, n_dev)
    if pending.size and pending.max() > 0:
        hot = int(np.argmax(pending))
        load = res.T @ pending
        order = np.argsort(load)
        for d in order:
            if not res[hot, d]:
                res[hot, d] = True
                break
    return res


def load_many(pending: np.ndarray, owners: np.ndarray, n_dev: int,
              budget_per_dev: int = 2) -> np.ndarray:
    """Replicate hot domains breadth-first until every device holds up to
    `budget_per_dev` domains."""
    res = _one_hot(owners, n_dev)
    slots = budget_per_dev - res.sum(axis=0)
    for i in np.argsort(-pending, kind="stable"):
        if pending[i] <= 0:
            break
        for d in np.argsort(-(slots)):
            if slots[d] > 0 and not res[i, d]:
                res[i, d] = True
                slots[d] -= 1
                break
    return res


def adaptive_send(pending: np.ndarray, owners: np.ndarray, n_dev: int,
                  threshold: float = 2.0) -> np.ndarray:
    """Demand-driven: replicate any domain whose pending load exceeds
    `threshold` x the mean onto the least-loaded device."""
    res = _one_hot(owners, n_dev)
    if pending.size == 0:
        return res
    mean = max(pending.mean(), 1.0)
    load = res.T @ pending
    for i in np.where(pending > threshold * mean)[0]:
        d = int(np.argmin(load))
        if not res[i, d]:
            res[i, d] = True
            load[d] += pending[i]
    return res


POLICIES = {
    "Greedy": greedy,
    "Spread": spread,
    "RayWeightedSpread": ray_weighted_spread,
    "LoadOnce": load_once,
    "LoadAnyOnce": load_any_once,
    "LoadAnother": load_another,
    "LoadMany": load_many,
    "AdaptiveSend": adaptive_send,
}


def primary_owner(resident: np.ndarray) -> np.ndarray:
    """Collapse a residency matrix to a single owner per domain (first
    resident device) for the single-owner scheduler path."""
    return np.argmax(resident, axis=1).astype(np.int32)
