"""The traversal kernel's plain version (gravit_tpu_torch bvh_intersect on
CPU tensors) against the JAX package's Pallas kernel in interpret mode, and
the brute-force intersector against the JAX one.

Both trace the SAME flat BVH arrays. prim must be identical. t, u and v are
not bit-equal: XLA's CPU backend contracts the Möller-Trumbore a*b+c terms
into fused multiply-adds, the port rounds each operation, and thin random
triangles (small determinants) magnify the difference. Tolerances: t within
rtol 1e-5, u and v within 1e-4 (measured: relative t 2.7e-6, u/v 2.6e-5).
On the card the CUDA kernel is built with --fmad=false and matches the
plain version bit for bit (chip_smoke.py phases 3-5).
"""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gravit_tpu.accel.bvh import _build_bvh_py as jax_build_py  # noqa: E402
from gravit_tpu.accel.scene_accel import build_scene_bvh as jax_scene_bvh  # noqa: E402
from gravit_tpu.ops import intersect as jax_intersect  # noqa: E402
from gravit_tpu.ops import pallas_bvh  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from gravit_tpu_torch.ops.intersect import intersect_closest  # noqa: E402
from test_torch_scene import random_mesh  # noqa: E402

torch.set_num_threads(2)

T_RTOL = 1e-5              # relative, on the hit distance t
UV_ATOL = 1e-4              # absolute, on the barycentrics u and v
NB = 4                      # blocks per test wavefront


def assert_close_hits(got, ref, hit):
    (t1, u1, v1), (t0, u0, v0) = got, ref
    dt = np.abs(t1[hit] - t0[hit]) / t0[hit]
    duv = max(np.abs(u1[hit] - u0[hit]).max(), np.abs(v1[hit] - v0[hit]).max())
    assert dt.max() <= T_RTOL and duv <= UV_ATOL


def wavefront(seed: int, lo, hi, live_frac: float = 0.8):
    """NB*PACKET rays from a sphere around the box [lo, hi], aimed at random
    points inside it; a random `live_frac` of lanes valid, and block 2
    skipped (root -1)."""
    rng = np.random.default_rng(seed)
    n = NB * bt.PACKET
    c, r = (lo + hi) / 2, np.linalg.norm(hi - lo)
    o = rng.normal(size=(n, 3))
    o = c + 1.5 * r * o / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(lo, hi, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = (rng.uniform(size=n) < live_frac).astype(np.int32)
    return o.astype(np.float32), d.astype(np.float32), valid


def tables_jax(cm, max_leaf=None):
    """(bounds, meta, tri) numpy arrays: the JAX scene bundle, or a
    single-mesh table built with a larger leaf size (deep leaves)."""
    if max_leaf is None:
        acc = jax_scene_bvh([cm])
        return (np.asarray(acc.bounds), np.asarray(acc.meta),
                np.asarray(acc.tri))
    b = jax_build_py(cm.v0, cm.e1, cm.e2, max_leaf)
    tri = np.zeros((cm.num_triangles + 8, 12), np.float32)
    tri[:-8, 0:3], tri[:-8, 3:6] = cm.v0[b.order], cm.e1[b.order]
    tri[:-8, 6:9] = cm.e2[b.order]
    return b.bounds, b.meta, tri


def run_both(o, d, valid, roots, tables, any_hit):
    bounds, meta, tri = tables
    ref = pallas_bvh.bvh_intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        jnp.asarray(roots), jnp.asarray(bounds), jnp.asarray(meta),
        jnp.asarray(tri), interpret=True, any_hit=any_hit)
    t = lambda a: torch.tensor(a)  # noqa: E731
    got = bt.bvh_intersect(t(o), t(d), t(valid), t(roots), t(bounds),
                           t(meta), t(tri), any_hit=any_hit)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


CASES = [  # n_tris, max_leaf (None: the scene bundle's leaves of <= 8)
    (37, None), (400, None), (400, 24)]


@pytest.mark.parametrize("n_tris,max_leaf", CASES)
def test_plain_closest_matches_pallas_interpret(n_tris, max_leaf):
    cm = random_mesh(n_tris, n_tris)
    tables = tables_jax(cm, max_leaf)
    if max_leaf:
        leaf = tables[1][:, 2] > 0
        assert tables[1][leaf, 1].max() > 8          # a multi-chunk leaf
    o, d, valid = wavefront(n_tris, cm.bounds_min, cm.bounds_max)
    roots = np.array([0, 0, -1, 0], np.int32)
    (t0, p0, u0, v0), (t1, p1, u1, v1) = run_both(o, d, valid, roots,
                                                  tables, any_hit=False)
    hit = p0 >= 0
    assert hit.sum() > 200
    assert not hit[2 * bt.PACKET:3 * bt.PACKET].any()   # skipped block
    assert not hit[valid == 0].any()
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(t1[~hit], t0[~hit])   # FLT_MAX
    assert_close_hits((t1, u1, v1), (t0, u0, v0), hit)


@pytest.mark.parametrize("n_tris", [37, 400])
def test_plain_any_hit_matches_pallas_interpret(n_tris):
    cm = random_mesh(n_tris + 1, n_tris)
    o, d, valid = wavefront(n_tris + 1, cm.bounds_min, cm.bounds_max)
    roots = np.array([0, -1, 0, 0], np.int32)
    (_, p0, _, _), (_, p1, _, _) = run_both(o, d, valid, roots,
                                            tables_jax(cm), any_hit=True)
    assert (p0 >= 0).sum() > 200
    np.testing.assert_array_equal(p1 >= 0, p0 >= 0)    # occluded flags


def test_plain_matches_numpy_oracle():
    """Per-ray closest hits against the scalar traversal of accel/bvh.py."""
    from gravit_tpu_torch.accel.bvh import build_bvh, bvh_intersect_numpy

    cm = random_mesh(3, 120)
    flat = build_bvh(cm.v0, cm.e1, cm.e2)
    order = flat.order
    v0, e1, e2 = cm.v0[order], cm.e1[order], cm.e2[order]
    tri = np.zeros((len(order) + 8, 12), np.float32)
    tri[:-8, 0:3], tri[:-8, 3:6], tri[:-8, 6:9] = v0, e1, e2
    o, d, valid = wavefront(3, cm.bounds_min, cm.bounds_max, live_frac=1.0)
    t = lambda a: torch.tensor(a)  # noqa: E731
    tt, pp, _, _ = bt.bvh_intersect(
        t(o), t(d), t(valid), t(np.zeros(NB, np.int32)), t(flat.bounds),
        t(flat.meta), t(tri))
    for i in range(0, NB * bt.PACKET, 97):
        ts, ps, _, _ = bvh_intersect_numpy(flat, v0, e1, e2, o[i], d[i])
        assert int(pp[i]) == ps
        if ps >= 0:
            assert abs(float(tt[i]) - ts) <= 1e-5 * max(1.0, ts)


def test_brute_intersect_matches_jax():
    cm = random_mesh(11, 300)
    o, d, valid = wavefront(11, cm.bounds_min, cm.bounds_max)
    mesh_id = np.zeros(o.shape[0], np.int32)
    mesh_id[::7] = -1                    # lanes with no local mesh skip
    tri_mesh = np.zeros(cm.num_triangles, np.int32)
    ref = jax_intersect.intersect_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(mesh_id),
        jnp.asarray(valid > 0), jnp.asarray(cm.v0), jnp.asarray(cm.e1),
        jnp.asarray(cm.e2), jnp.asarray(tri_mesh), tile=128)
    t = torch.from_numpy
    got = intersect_closest(t(o), t(d), t(mesh_id), t(valid > 0),
                            t(cm.v0), t(cm.e1), t(cm.e2), t(tri_mesh),
                            tile=128)
    hit = np.asarray(ref.prim) >= 0
    assert hit.sum() > 200
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    assert_close_hits([got[k].numpy() for k in (0, 2, 3)],
                      [np.asarray(ref[k]) for k in (0, 2, 3)], hit)


def test_kernel_route_checks():
    """The kernel takes only CUDA tensors of the documented layout; the
    plain version runs on the card only when asked (impl='plain')."""
    cm = random_mesh(2, 37)
    bounds, meta, tri = (torch.tensor(a) for a in tables_jax(cm))
    o, d, valid = (torch.from_numpy(a) for a in
                   wavefront(2, cm.bounds_min, cm.bounds_max))
    roots = torch.zeros(NB, dtype=torch.int32)
    # t_far at the box centre's distance: hits in the near half only
    far = float(1.5 * np.linalg.norm(cm.bounds_max - cm.bounds_min))
    t_far = torch.full((o.shape[0],), far, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        bt.bvh_intersect_kernel(o, d, valid, roots, bounds, meta, tri, t_far)
    with pytest.raises(ValueError, match="impl"):
        bt.bvh_intersect(o, d, valid, roots, bounds, meta, tri,
                         impl="kernel")
    with pytest.raises(ValueError, match="valid"):
        bt.bvh_intersect(o, d, valid.to(torch.int64), roots, bounds, meta,
                         tri)
    with pytest.raises(ValueError, match="multiple"):
        bt.bvh_intersect(o[:100], d[:100], valid[:100], roots[:1], bounds,
                         meta, tri)
    # t_far seeds the closest distance: nothing beyond it is reported
    r = bt.bvh_intersect_plain(o, d, valid, roots, bounds, meta, tri, t_far)
    assert (r.t <= far).all() and bool((r.prim >= 0).any())
    assert int(r.node_visits.sum()) > 0 and int(r.tri_rows.sum()) > 0


def test_interop_bvh_roundtrip():
    cm = random_mesh(4, 64)
    acc = jax_scene_bvh([cm])
    arrays = {f.name: np.asarray(getattr(acc, f.name))
              for f in dataclasses.fields(acc) if f.name != "num_meshes"}
    got = interop.bvh_from_numpy(arrays, acc.num_meshes, "cpu")
    for name, a in arrays.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), a)
