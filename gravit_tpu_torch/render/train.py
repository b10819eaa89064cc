"""Differentiable rendering and the training steps, counterpart of
gravit_tpu/render/train.py.

The parameters {vertices, kd, light_pos, light_color} are leaf tensors;
the looped wavefront tracer runs a fixed number of rounds (`unroll=True`,
brute intersection, no accel) so that autograd flows through every round:
the brute Möller-Trumbore scan keeps the winning triangle's t, u, v, the
shading, the spawn append and the deposits are out-of-place tensor ops.

Optimisers are `torch.optim` factories (a callable from the parameter list
to an optimiser), the counterpart of an optax transformation: `step`
zeroes the gradients, runs the forward and the backward and calls
`opt.step()`, which updates the leaves in place: the spans
`train.forward`, `train.backward` and `train.update` (core/timing.py).

A deliberate difference from the JAX package: `make_sharded_train_step`
returns the gradient of the loss it reports. The JAX step's gradient is n
times that (the psum inside its loss transposes to another psum under
shard_map(check_vma=False), and the gradients are psummed again).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.core.timing import span
from gravit_tpu_torch.parallel.distributed import DistGroup, Mesh
from gravit_tpu_torch.render.scene_build import SceneData, refresh_geometry
from gravit_tpu_torch.render.tracer import trace_image


class TrainParams(NamedTuple):
    vertices: torch.Tensor     # (V, 3)
    kd: torch.Tensor           # (T, 3) per-triangle diffuse
    light_pos: torch.Tensor    # (L, 3)
    light_color: torch.Tensor  # (L, 3)


class AdamState(NamedTuple):
    """Adam's moments laid out as optax's ScaleByAdamState(count, mu, nu),
    so that a checkpoint means the same thing in both packages."""
    count: torch.Tensor        # () int32, steps taken
    mu: TrainParams            # first moments
    nu: TrainParams            # second moments


def adam_state_from_leaves(leaves: Sequence, device=None) -> AdamState:
    """optax Adam's state leaves in flatten order (count, mu's four params,
    nu's four params), as numpy arrays, as an AdamState on `device`."""
    n = len(TrainParams._fields)
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"optax Adam has {1 + 2 * n} state leaves "
                         f"(count, mu, nu), got {len(leaves)}")
    moments = [torch.as_tensor(np.asarray(a, np.float32), device=device)
               for a in leaves[1:]]
    return AdamState(torch.tensor(int(np.asarray(leaves[0])),
                                  dtype=torch.int32),
                     TrainParams(*moments[:n]), TrainParams(*moments[n:]))


def params_from_scene(scene: SceneData) -> TrainParams:
    """The scene's trainable fields as fresh leaf tensors that require
    grad."""
    return TrainParams(*(x.detach().clone().requires_grad_(True) for x in (
        scene.vertices, scene.tri_kd, scene.lights_pos, scene.lights_color)))


def apply_params(scene: SceneData, p: TrainParams) -> SceneData:
    scene = refresh_geometry(scene, p.vertices)
    return dataclasses.replace(scene, tri_kd=p.kd, lights_pos=p.light_pos,
                               lights_color=p.light_color)


def render_with_params(scene: SceneData, p: TrainParams, arena: RayArena,
                       width: int, height: int,
                       rounds: int = 4) -> torch.Tensor:
    scene = apply_params(scene, p)
    return trace_image(scene, arena, width, height, max_rounds=rounds,
                       unroll=True)


def loss_fn(p: TrainParams, scene: SceneData, arena: RayArena,
            target_fb: torch.Tensor, width: int, height: int,
            rounds: int = 4) -> torch.Tensor:
    fb = render_with_params(scene, p, arena, width, height, rounds)
    return torch.mean((fb[:, :3] - target_fb[:, :3]) ** 2)


def adam(lr: float = 1e-3):
    """optax.adam(lr)'s counterpart: torch.optim.Adam with optax's betas
    (0.9, 0.999) and eps 1e-8."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                           eps=1e-8)


def make_train_step(optimizer=None, rounds: int = 4, width: int = 64,
                    height: int = 64):
    """Single-device differentiable train step. Returns (step, optimizer):
    `opt = optimizer(list(p))` takes optax's `init`; then
    `p, opt, loss = step(p, opt, scene, arena, target_fb)` updates the
    leaves of `p` in place and returns the loss before the update."""
    if optimizer is None:
        optimizer = adam(1e-3)

    def step(p: TrainParams, opt, scene: SceneData, arena: RayArena,
             target_fb: torch.Tensor):
        with span("train.forward"):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(p, scene, arena, target_fb, width, height, rounds)
        with span("train.backward"):
            loss.backward()
        with span("train.update"):
            opt.step()
        return p, opt, loss.detach()

    return step, optimizer


class _SumReplicated(torch.autograd.Function):
    """The sum over a process group whose result every member then uses
    alike: forward all-reduces, backward passes the (replicated) cotangent
    through unchanged. torch.distributed.nn's all_reduce would sum the
    cotangent over the ranks in its backward: n times the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce([x])[0]

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def shard_arena(arena: RayArena, n: int) -> list:
    """The arena in n contiguous lane ranges (the JAX package's P(ray_axis)
    split), padded with dead lanes to a multiple of n first."""
    pad = -arena.capacity % n
    if pad:
        empty = RayArena.zeros(pad, arena.origin.device)
        arena = RayArena(**{f.name: torch.cat([getattr(arena, f.name),
                                               getattr(empty, f.name)])
                            for f in dataclasses.fields(RayArena)})
    c = arena.capacity // n
    return [arena.map(lambda a, i=i: a[i * c:(i + 1) * c]) for i in range(n)]


def make_sharded_train_step(group_or_mesh, ray_axis: str = "rays",
                            optimizer=None, rounds: int = 4,
                            width: int = 64, height: int = 64):
    """Data-parallel train step: the arena split over the group's members,
    the parameters replicated, the members' framebuffers summed inside the
    loss, the parameter gradients summed over the group.

    `group_or_mesh` is a group (parallel/) or a Mesh, whose `ray_axis`
    group is taken. The members of a LocalGroup run one after another in
    this process on one set of leaf tensors, so autograd sums their
    contributions once; a DistGroup member renders its own shard, sums the
    framebuffers with a reduce whose backward passes the cotangent through,
    and all-reduces its parameter gradients. The gradient is the one of
    the loss returned: for the same arena, make_train_step's gradient up
    to summation order (the JAX step's is n times it).
    """
    group = (group_or_mesh.groups[ray_axis]
             if isinstance(group_or_mesh, Mesh) else group_or_mesh)
    if optimizer is None:
        optimizer = adam(1e-3)
    dist_group = isinstance(group, DistGroup)

    def step(p: TrainParams, opt, scene: SceneData, arena: RayArena,
             target_fb: torch.Tensor):
        with span("train.forward"):
            opt.zero_grad(set_to_none=True)
            shards = shard_arena(arena, group.size)
            s = apply_params(scene, p)
            fbs = [trace_image(s, shards[m], width, height,
                               max_rounds=rounds, unroll=True)
                   for m in group.local]
            if dist_group:
                fb = _SumReplicated.apply(fbs[0], group)
            else:
                fb = group.all_reduce(fbs)[0]
            loss = torch.mean((fb[:, :3] - target_fb[:, :3]) ** 2)
        with span("train.backward"):
            loss.backward()
            if dist_group:
                # every member reduces every leaf, in one order (a leaf no
                # ray of this member reached has no grad here)
                for x in p:
                    g = torch.zeros_like(x) if x.grad is None else x.grad
                    x.grad = group.all_reduce([g])[0]
        with span("train.update"):
            opt.step()
        return p, opt, loss.detach()

    return step, optimizer


def adam_state(opt: torch.optim.Adam, p: TrainParams) -> AdamState:
    """A torch Adam's moments over `p` as optax's layout (zeros and count
    0 before its first step)."""
    st = [opt.state.get(x, {}) for x in p]
    count = int(st[0]["step"]) if "step" in st[0] else 0
    mu = TrainParams(*(s.get("exp_avg", torch.zeros_like(x)).detach()
                       for s, x in zip(st, p)))
    nu = TrainParams(*(s.get("exp_avg_sq", torch.zeros_like(x)).detach()
                       for s, x in zip(st, p)))
    return AdamState(torch.tensor(count, dtype=torch.int32), mu, nu)


def load_adam_state(opt: torch.optim.Adam, p: TrainParams,
                    state: AdamState) -> torch.optim.Adam:
    """Prime a torch Adam over `p` with optax-layout moments, so that its
    next step continues as the saved optimiser's would."""
    count = int(state.count)
    for x, m, v in zip(p, state.mu, state.nu):
        opt.state[x] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.detach().to(x.device, x.dtype).clone(),
            "exp_avg_sq": v.detach().to(x.device, x.dtype).clone()}
    return opt
