"""The port's multi-mesh `_intersect_bvh` against the JAX package's, on the
CPU: the in-place per-(mesh, shadow) passes and the segment-aligned pack,
on sparse scattered queues with mixed shadow lanes; all-dead and
shadow-free wavefronts. The port's pack orders lanes by a stable sort; it
is held against both of the JAX package's branches: the one-hot prefix
ranks (forced by INPLACE_MESH_LIMIT = 0 on three meshes) and the stable
argsort (nine meshes). JAX runs its
Pallas kernel in interpret mode, the port its plain traversal, on the SAME
flat BVH arrays.

Tolerances: primary lanes' prim identical and t within rtol 1e-5 (XLA's
CPU backend contracts the Möller-Trumbore a*b+c terms into fused
multiply-adds, the port rounds each operation: tests/test_torch_bvh.py);
shadow lanes run the any-hit pass, where only the occlusion verdict
(prim >= 0) is defined, and those verdicts must be identical. Inside the
port the packed and in-place paths agree bit for bit on primary lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.render import tracer as jax_tracer
from gravit_tpu_torch.render import tracer

import jax.numpy as jnp

torch.set_num_threads(2)

T_RTOL = 1e-5


def _meshes(count: int):
    """Three meshes of SimpleApp shapes (cone, cube, small cone), or
    `count` small displaced spheres of different seeds."""
    if count == 3:
        cone = chip_smoke.cone_mesh()
        small = dataclasses.replace(cone, v0=cone.v0 * 0.6, e1=cone.e1 * 0.6,
                                    e2=cone.e2 * 0.6)
        return [cone, chip_smoke.cube_mesh(), small]
    return [chip_smoke.compiled_mesh(*chip_smoke.displaced_sphere(k, 6))
            for k in range(count)]


def _wavefront(seed: int, n: int, meshes: int, queued_frac=0.35,
               shadow_frac=0.5, center=(0.0, 0.0, 0.0), radius=2.0):
    """Rays from a shell around `center` aimed roughly at it; random mesh
    per lane, a sparse scattered queue, random shadow lanes."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = radius * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + 0.3 * radius * rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = o + np.asarray(center)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32),
                mesh=rng.integers(0, meshes, n).astype(np.int32),
                queued=rng.random(n) < queued_frac,
                shadow=rng.random(n) < shadow_frac)


def _run(jacc, tacc, w, is_shadow, limit=None):
    """(jax Hit as numpy, port Hit as numpy) with INPLACE_MESH_LIMIT set to
    `limit` in both packages for the call."""
    jlim, tlim = jax_tracer.INPLACE_MESH_LIMIT, tracer.INPLACE_MESH_LIMIT
    if limit is not None:
        jax_tracer.INPLACE_MESH_LIMIT = tracer.INPLACE_MESH_LIMIT = limit
    try:
        sh = None if not is_shadow else w["shadow"]
        with tp.pallas_interpret():
            j = jax_tracer._intersect_bvh(
                None, jacc, jnp.asarray(w["o"]), jnp.asarray(w["d"]),
                jnp.asarray(w["mesh"]), jnp.asarray(w["queued"]),
                is_shadow=None if sh is None else jnp.asarray(sh))
        t = tracer._intersect_bvh(
            None, tacc, torch.tensor(w["o"]), torch.tensor(w["d"]),
            torch.tensor(w["mesh"]), torch.tensor(w["queued"]),
            is_shadow=None if sh is None else torch.tensor(sh))
    finally:
        jax_tracer.INPLACE_MESH_LIMIT, tracer.INPLACE_MESH_LIMIT = jlim, tlim
    return ([np.asarray(a) for a in j], [a.numpy() for a in t])


def _assert_match(j, t, w, is_shadow):
    q = w["queued"]
    sh = w["shadow"] if is_shadow else np.zeros_like(q)
    prim_q, shadow_q = q & ~sh, q & sh
    np.testing.assert_array_equal(t[1][prim_q], j[1][prim_q])
    hit = prim_q & (j[1] >= 0)
    assert np.all(np.abs(t[0][hit] - j[0][hit]) <= T_RTOL * j[0][hit])
    np.testing.assert_array_equal(t[0][prim_q & (j[1] < 0)],
                                  j[0][prim_q & (j[1] < 0)])
    np.testing.assert_array_equal((t[1] >= 0)[shadow_q],
                                  (j[1] >= 0)[shadow_q])
    # unqueued lanes come back as misses
    assert np.all(t[1][~q] == -1) and np.all(t[0][~q] >= tracer.FLT_MAX)
    return hit, shadow_q


@pytest.mark.parametrize("path,meshes,limit", [
    ("inplace", 3, None), ("pack_onehot", 3, 0), ("pack_argsort", 9, None)])
def test_dispatch_matches_jax(path, meshes, limit):
    ms = _meshes(meshes)
    jacc, tacc = tp.bvh_pair(ms)
    center = (0.0, 0.0, 0.0) if meshes == 3 else chip_smoke.SPHERE_CENTER
    radius = 2.0 if meshes == 3 else 0.3
    w = _wavefront(7 + meshes, 2048, meshes, center=center, radius=radius)
    j, t = _run(jacc, tacc, w, True, limit)
    hit, shadow_q = _assert_match(j, t, w, True)
    # every mesh's primary lanes and the shadow lanes saw hits
    for m in range(meshes):
        assert hit[w["mesh"] == m].any(), m
    assert (j[1][shadow_q] >= 0).any() and (j[1][shadow_q] < 0).any()


@pytest.mark.parametrize("limit", [None, 0])
def test_dispatch_no_shadow_and_all_dead(limit):
    ms = _meshes(3)
    jacc, tacc = tp.bvh_pair(ms)
    w = _wavefront(11, 1024, 3, queued_frac=0.5)
    j, t = _run(jacc, tacc, w, False, limit)
    hit, _ = _assert_match(j, t, w, False)
    assert hit.any()
    dead = dict(w, queued=np.zeros(1024, bool))
    j, t = _run(jacc, tacc, dead, True, limit)
    assert np.all(t[1] == -1) and np.all(t[0] >= tracer.FLT_MAX)
    assert np.all(j[1] == -1)


@pytest.mark.parametrize("meshes", [3, 9])
def test_pack_equals_inplace_in_the_port(meshes):
    """The pack (limit 0) and the in-place passes (limit 16) of the port:
    primary t / prim / u / v bit-equal, shadow verdicts identical."""
    _, tacc = tp.bvh_pair(_meshes(meshes))
    center = (0.0, 0.0, 0.0) if meshes == 3 else chip_smoke.SPHERE_CENTER
    w = _wavefront(23, 2048, meshes, queued_frac=0.4, center=center,
                   radius=2.0 if meshes == 3 else 0.3)
    args = [torch.tensor(w[k]) for k in ("o", "d", "mesh", "queued")]
    sh = torch.tensor(w["shadow"])
    lim = tracer.INPLACE_MESH_LIMIT
    try:
        tracer.INPLACE_MESH_LIMIT = 16
        ip = tracer._intersect_bvh(None, tacc, *args, is_shadow=sh)
        tracer.INPLACE_MESH_LIMIT = 0
        pk = tracer._intersect_bvh(None, tacc, *args, is_shadow=sh)
    finally:
        tracer.INPLACE_MESH_LIMIT = lim
    q, s = w["queued"], w["shadow"]
    prim = torch.tensor(q & ~s)
    for a, b in zip(ip, pk):
        assert torch.equal(a[prim], b[prim])
    occ = torch.tensor(q & s)
    assert torch.equal((ip.prim >= 0)[occ], (pk.prim >= 0)[occ])
    assert bool((ip.prim[prim] >= 0).any())


@pytest.mark.parametrize("limit", [None, 0])
def test_all_shadow_marker(limit, monkeypatch):
    """`is_shadow=True` (every lane a shadow lane) gives the same hits as
    an all-true mask, bit for bit; in place it makes one any-hit launch
    per mesh and no closest launch, the pack both of its launches."""
    _, tacc = tp.bvh_pair(_meshes(3))
    w = _wavefront(31, 2048, 3, queued_frac=0.4)
    args = [torch.tensor(w[k]) for k in ("o", "d", "mesh", "queued")]
    launches = []
    orig = tracer.bvh_intersect

    def counted(*a, any_hit=False, **kw):
        launches.append(any_hit)
        return orig(*a, any_hit=any_hit, **kw)

    monkeypatch.setattr(tracer, "bvh_intersect", counted)
    if limit is not None:
        monkeypatch.setattr(tracer, "INPLACE_MESH_LIMIT", limit)
    mask = tracer._intersect_bvh(None, tacc, *args,
                                 is_shadow=torch.ones(2048, dtype=torch.bool))
    n_mask = len(launches)
    marked = tracer._intersect_bvh(None, tacc, *args, is_shadow=True)
    for a, b in zip(mask, marked):
        assert torch.equal(a, b)
    assert bool((marked.prim >= 0).any())
    if limit is None:
        assert launches[:n_mask] == [False, True] * 3
        assert launches[n_mask:] == [True] * 3
    else:
        assert launches == [False, True] * 2
