"""The numbers that decide `correct`, and the judgement against a cell's
limits (portbench/limits/<cell>.json, each limit set from the readings
PERF.md gives).

A frame (render cells), against the reference's frame of the same pose:
  px_off   the share of pixels whose rgba differs from the reference's by
           more than PX_TOL in some channel (alpha counts the deposits)
  sum_rel  sum |rgb - reference rgb| over sum |reference rgb|
The worst kept frame's are compared.

The first steps of a fit (the train cell), against the reference's steps
from the same start, each number the worst case:
  loss_gap        |loss - reference loss| / reference loss of the first
                  step
  loss_gap_later  the same of the later checked steps, the worst; wider
                  by nature: a vertex whose gradient is nought by symmetry
                  reads exactly 0 on one side and +-1e-11 on the other,
                  Adam moves it by up to lr * 1e-3 on that side alone,
                  and the broken symmetry gives it a true gradient of
                  1e-8 to 1e-7 at the next step, which Adam steps at most
                  of its rate (PERF.md)
  grad_gap        per leaf, | |g| - |g_ref| | / max(|g_ref|, median
                  leaf's |g_ref|), g the first step's gradient as Adam's
                  first moment holds it
  change_gap      the same of the change of each leaf over the steps, over
                  the coordinates whose first reference gradient is at
                  least GRAD_FLOOR of the median leaf's root-mean-square
                  gradient (the others are the ones above)
"""

from __future__ import annotations

import math

import torch

PX_TOL = 2.0 / 255.0
GRAD_FLOOR = 1e-3


def frame_readings(fb: torch.Tensor, want: torch.Tensor) -> dict:
    fb = fb.detach().to(want.device, torch.float32)
    if fb.shape != want.shape:
        return dict(px_off=1.0, sum_rel=math.inf)
    d = (fb - want).abs()
    bad = ~torch.isfinite(fb).all(dim=1) | (d.amax(dim=1) > PX_TOL)
    ref_sum = float(want[:, :3].abs().sum())
    return dict(px_off=float(bad.float().mean()),
                sum_rel=float(d[:, :3].sum()) / max(ref_sum, 1e-30))


def worst(readings: list) -> dict:
    out = {}
    for r in readings:
        for k, v in r.items():
            v = math.inf if not math.isfinite(v) else v
            out[k] = max(out.get(k, -math.inf), v)
    return out


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double().cpu()))
            for k, v in d.items()}


def _gap(prog: dict, ref: dict, keys) -> float:
    med = sorted(ref[k] for k in keys)[len(keys) // 2] if keys else 0.0
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return max(gaps) if gaps else 0.0


def train_readings(prog: dict, ref: dict) -> dict:
    """prog and ref: losses [..], grad {leaf: g}, p0 and p_end {leaf: x}."""
    losses = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
              else math.inf for a, b in zip(prog["losses"], ref["losses"])]
    g_p, g_r = _norms(prog["grad"]), _norms(ref["grad"])
    leaves = sorted(g_r)
    rms = sorted(g_r[k] / max(ref["grad"][k].numel(), 1) ** 0.5
                 for k in leaves)[len(leaves) // 2]
    moves = {k: (ref["grad"][k].abs() >= GRAD_FLOOR * rms).cpu()
             for k in leaves}
    moving = [k for k in leaves if bool(moves[k].any())]

    def change(side, k):
        d = (side["p_end"][k].detach().cpu()
             - side["p0"][k].detach().cpu())
        return d[moves[k]]

    ch_p = _norms({k: change(prog, k) for k in moving})
    ch_r = _norms({k: change(ref, k) for k in moving})
    return dict(loss_gap=losses[0], grad_gap=_gap(g_p, g_r, leaves),
                change_gap=_gap(ch_p, ch_r, moving),
                loss_gap_later=max(losses[1:], default=0.0))


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number read and at or under its
    limit; checks {name: {"value", "limit"}} in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        v = v if math.isfinite(v) else math.inf
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks
