"""The closest instance box along each ray: the kernel wrapper and its plain
PyTorch version.

BVH::intersect's leaf with `update=true` (BVH.h:61-135) over a flat list of
boxes, the search both tracers make for a ray's next instance (the surface
shuffle and hop loops, render/tracer.py::_next_instance; the volume shuffle,
render/volume_tracer.py::_instance_bvh_hit). Scenes with an instance tree
walk it instead (accel/instance_bvh.py), with the same leaf predicate.

Per lane and box i: a = (lo_i - o) * inv and b = (hi_i - o) * inv per axis
(inv from `inverse_direction`), tn the max over the axes of min(a, b), tf the
min of max(a, b); box i is hit iff tf > tn, tn > RAY_EPSILON, tn < t_max and
i != exclude. The answer is the hit with the least tn, the lowest index on
equal tn; no hit gives found False, index 0 and t_entry FLT_MAX. The JAX
package computes it as a loop over the instances with a running strict-<
minimum; `csrc/instance_slab.cu` does the same in one launch, a thread a
lane. The plain version computes all boxes at once as an (n, I, 3)
broadcast and an argmin (the first minimum): the same answers, bit for bit,
since min, max and the compares are exact and every lane whose broadcast
tn or tf differs from the loop's (an infinity against +-FLT_MAX) fails
the test either way.

`closest_box` runs the plain version for CPU tensors and the kernel for
CUDA tensors; `impl="plain"` runs the plain version on the card, for
comparisons. Neither search carries a gradient: where autograd records
through the boxes or the rays, `t_entry` is recomputed from the winner's box
by the JAX loop's own chain of minimum and maximum, so its value and its
gradient (split evenly where two axes tie) are the loop's.
"""

from __future__ import annotations

import ctypes

import torch

from gravit_tpu_torch.core.rays import FLT_MAX, RAY_EPSILON
from gravit_tpu_torch.core.timing import span
from gravit_tpu_torch.ops import _build

BIG = 1e30

# kernel launches since the last reset_launch_counts(); counted where the
# kernel is launched and nowhere else
launches_instance_slab = 0


def reset_launch_counts() -> None:
    global launches_instance_slab
    launches_instance_slab = 0


def inverse_direction(direction: torch.Tensor) -> torch.Tensor:
    """1 / direction per component, with +-1e30 (by the sign) where
    |d| < 1e-30. The divisor is masked too, so that reverse-mode AD stays
    NaN-free (the double-where pattern)."""
    small = torch.abs(direction) < 1e-30
    big = torch.where(direction < 0, -BIG, BIG).to(direction.dtype)
    return torch.where(small, big,
                       1.0 / torch.where(small, 1.0, direction))


def _check(lo, hi, origin, direction, t_max, exclude) -> None:
    n, num = origin.shape[0], lo.shape[0]
    want = {
        "lo": (lo, torch.float32, (num, 3)),
        "hi": (hi, torch.float32, (num, 3)),
        "origin": (origin, torch.float32, (n, 3)),
        "direction": (direction, torch.float32, (n, 3)),
        "t_max": (t_max, torch.float32, (n,)),
        "exclude": (exclude, torch.int32, (n,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != origin.device:
            raise ValueError(f"{name} is on {x.device}, rays on "
                             f"{origin.device}")


def closest_box_plain(lo, hi, origin, direction, t_max, exclude):
    """The search as one (n, I, 3) broadcast and an argmin. Returns
    (found (n,) bool, nxt (n,) i32, t_entry (n,) f32)."""
    _check(lo, hi, origin, direction, t_max, exclude)
    inv = inverse_direction(direction)[:, None]
    a = (lo[None] - origin[:, None]) * inv
    b = (hi[None] - origin[:, None]) * inv
    tn = torch.minimum(a, b).max(dim=-1).values
    tf = torch.maximum(a, b).min(dim=-1).values
    ids = torch.arange(lo.shape[0], device=origin.device)
    hit = ((tf > tn) & (tn > RAY_EPSILON) & (tn < t_max[:, None])
           & (ids[None, :] != exclude[:, None]))
    tn = torch.where(hit, tn, FLT_MAX)
    nxt = torch.argmin(tn, dim=1)
    t_entry = torch.gather(tn, 1, nxt[:, None])[:, 0]
    return t_entry < FLT_MAX, nxt.to(torch.int32), t_entry


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("instance_slab")
    lib.instance_slab_launch.argtypes = _ARGTYPES
    lib.instance_slab_launch.restype = ctypes.c_int
    lib.instance_slab_error_string.argtypes = [ctypes.c_int]
    lib.instance_slab_error_string.restype = ctypes.c_char_p
    return lib


def closest_box_kernel(lo, hi, origin, direction, t_max, exclude):
    """Launch `csrc/instance_slab.cu` on the current stream; raises if the
    launch is refused. CUDA tensors only. The rays may be row slices of a
    wider table (a row stride, unit stride within a row); the boxes are
    made contiguous."""
    global launches_instance_slab
    _check(lo, hi, origin, direction, t_max, exclude)
    if origin.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got "
                         f"{origin.device}")
    if origin.stride(1) != 1 or direction.stride(1) != 1:
        raise ValueError("origin and direction need unit stride in a row")
    lo, hi = lo.contiguous(), hi.contiguous()
    n = origin.shape[0]
    out = lambda dtype: torch.empty((n,), dtype=dtype,  # noqa: E731
                                    device=origin.device)
    found, nxt, t_entry = out(torch.bool), out(torch.int32), out(torch.float32)
    lib = _library()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    with torch.cuda.device(origin.device):  # the launch targets this device
        stream = torch.cuda.current_stream(origin.device).cuda_stream
        err = lib.instance_slab_launch(
            ptr(lo), ptr(hi), lo.shape[0], ptr(origin), origin.stride(0),
            ptr(direction), direction.stride(0), ptr(t_max), t_max.stride(0),
            ptr(exclude), exclude.stride(0), n, ptr(found), ptr(nxt),
            ptr(t_entry), ctypes.c_void_p(stream))
    if err:
        msg = lib.instance_slab_error_string(err).decode()
        raise RuntimeError(f"instance_slab launch failed: {msg} ({err})")
    if n:
        launches_instance_slab += 1
    return found, nxt, t_entry


def entry_distance(lo, hi, origin, direction, nxt) -> torch.Tensor:
    """tn of box nxt per lane, by the JAX loop's chain:
    max(max(m0, m1), m2), m_k = min(a_k, b_k). Differentiable."""
    inv = inverse_direction(direction)
    idx = nxt.to(torch.int64)
    blo, bhi = lo.index_select(0, idx), hi.index_select(0, idx)
    m = [torch.minimum((blo[:, k] - origin[:, k]) * inv[:, k],
                       (bhi[:, k] - origin[:, k]) * inv[:, k])
         for k in range(3)]
    return torch.maximum(torch.maximum(m[0], m[1]), m[2])


def closest_box(lo, hi, origin, direction, t_max, exclude, impl=None):
    """The closest box (I, 3) lo / hi that each of n rays enters: returns
    (found (n,) bool, nxt (n,) i32, t_entry (n,) f32), as the module
    docstring says. t_max (n,) f32, exclude (n,) i32 (-1: none). Every
    lane is computed; callers mask by the lanes they search for. CPU
    tensors run the plain version, CUDA tensors the kernel;
    impl="plain" runs the plain version on any device."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    run = (closest_box_plain if impl == "plain"
           or origin.device.type == "cpu" else closest_box_kernel)
    with span("tracer.instance_slab"):
        found, nxt, t_entry = run(lo.detach(), hi.detach(), origin.detach(),
                                  direction.detach(), t_max, exclude)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (lo, hi, origin, direction)):
        t_entry = torch.where(
            found, entry_distance(lo, hi, origin, direction, nxt), FLT_MAX)
    return found, nxt, t_entry
