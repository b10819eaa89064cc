"""The port's instance BVH (gravit_tpu_torch/accel/instance_bvh.py) against
the JAX package's, on the CPU.

Bit-equal throughout: the build is numpy in both packages; the walk's slab
test is a subtraction and a product per axis (no a*b+c for XLA to fuse)
followed by min/max, so JAX and the port compute the same floats; the
scan and the tree share the leaf predicate and the lowest-index tie-break.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp  # noqa: I001 (puts the repo root on sys.path)
import chip_smoke
from gravit_tpu.accel import instance_bvh as jax_ibvh

from gravit_tpu_torch.accel.instance_bvh import (build_instance_arrays,
                                                 build_instance_bvh,
                                                 closest_instance)
from gravit_tpu_torch.core.rays import FLT_MAX
from gravit_tpu_torch.render import tracer
from gravit_tpu_torch.render.scene_build import build_scene

torch.set_num_threads(2)


def random_boxes(seed: int, n_box: int):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5, 4, (n_box, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.5, (n_box, 3)).astype(np.float32)
    return lo, hi


def grid_boxes(side: int = 16, seed: int = 3):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3).astype(np.float32)
    lo = g + rng.uniform(0.1, 0.3, g.shape).astype(np.float32)
    return lo, lo + 0.5


def random_rays(seed: int, n_ray: int, n_box: int):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n_ray, 3)).astype(np.float32)
    d = rng.normal(size=(n_ray, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16, 1:] = 0.0                    # axis-aligned rays: inv_dir 1e30
    t_max = np.where(rng.random(n_ray) < 0.3, 3.0, FLT_MAX).astype(np.float32)
    exclude = rng.integers(-1, n_box, n_ray).astype(np.int32)
    active = rng.random(n_ray) < 0.9
    return o, d, t_max, exclude, active


def inv_dir(d):
    small = np.abs(d) < 1e-30
    return np.where(small, np.where(d < 0, -1e30, 1e30),
                    1.0 / np.where(small, 1.0, d)).astype(np.float32)


@pytest.mark.parametrize("boxes", ["random300", "grid4096", "simple25",
                                   "multi80"])
def test_tree_arrays_equal_jax(boxes):
    if boxes == "random300":
        lo, hi = random_boxes(7, 300)
    elif boxes == "grid4096":
        lo, hi = grid_boxes()
    else:
        spec = (chip_smoke.simple_app(32, 32) if boxes == "simple25"
                else chip_smoke.make_multi_scene(0, 32, 32, bands=4))
        scene = build_scene(spec.meshes, spec.instances, spec.lights,
                            device="cpu", instance_bvh=True)
        lo, hi = scene.inst_lo.numpy(), scene.inst_hi.numpy()
        assert torch.equal(scene.inst_bvh.miss,
                           torch.tensor(build_instance_arrays(lo, hi)["miss"]))
    ref = jax_ibvh.build_instance_bvh(lo, hi)
    got = build_instance_arrays(lo, hi)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), k)
    assert got["inst_id"].shape[0] == 2 * lo.shape[0] - 1


@pytest.mark.parametrize("boxes", ["random300", "grid4096"])
def test_closest_instance_equals_jax_and_scan(boxes):
    lo, hi = random_boxes(7, 300) if boxes == "random300" else grid_boxes()
    o, d, t_max, exclude, active = random_rays(5, 1024, lo.shape[0])
    inv = inv_dir(d)
    ref = jax_ibvh.build_instance_bvh(lo, hi)
    jf, ji, jt = (np.asarray(a) for a in jax_ibvh.closest_instance(
        ref, jnp.asarray(o), jnp.asarray(inv), jnp.asarray(t_max),
        jnp.asarray(exclude), jnp.asarray(active)))
    bvh = build_instance_bvh(lo, hi, device="cpu")
    tt = [torch.tensor(a) for a in (o, inv, t_max, exclude, active)]
    found, inst, t = closest_instance(bvh, *tt)
    np.testing.assert_array_equal(found.numpy(), jf)
    np.testing.assert_array_equal(inst.numpy(), ji)
    np.testing.assert_array_equal(t.numpy(), jt)
    assert found.sum() > 50

    # the port's scan over the same boxes: the same winners and t_entry
    def scene(tree):
        return types.SimpleNamespace(
            inst_bvh=tree, num_instances=lo.shape[0],
            inst_lo=torch.tensor(lo), inst_hi=torch.tensor(hi))

    args = (tt[0], torch.tensor(d), tt[2], tt[3], tt[4])
    s_found, s_inst, s_t = tracer._next_instance(scene(None), *args)
    b_found, b_inst, b_t = tracer._next_instance(scene(bvh), *args)
    # the scan has no `active` input: compare where the walk ran
    act = tt[4]
    assert torch.equal(s_found & act, b_found)
    assert torch.equal(s_inst[b_found], b_inst[b_found])
    assert torch.equal(s_t[b_found], b_t[b_found])
    assert torch.equal(b_t[b_found], t[b_found])


def test_check_every_8_equals_every_step():
    """The walk tests for a live pointer once every 8 steps; the steps
    after the last pointer ended change nothing."""
    lo, hi = random_boxes(9, 200)
    o, d, t_max, exclude, active = random_rays(6, 2048, 200)
    bvh = build_instance_bvh(lo, hi, device="cpu")
    tt = [torch.tensor(a) for a in (o, inv_dir(d), t_max, exclude, active)]
    every = closest_instance(bvh, *tt, check_every=1)
    for k in (8, 3):
        got = closest_instance(bvh, *tt, check_every=k)
        for a, b in zip(every, got):
            assert torch.equal(a, b)


def test_render_tree_equals_scan():
    """SimpleApp through the looped tracer, the instance shuffle by the tree
    and by the scan: bit-equal frames (and fast-multi too)."""
    spec = chip_smoke.simple_app(32, 32)
    scan = build_scene(spec.meshes, spec.instances, spec.lights,
                       device="cpu")
    tree = build_scene(spec.meshes, spec.instances, spec.lights,
                       device="cpu", instance_bvh=True)
    assert scan.inst_bvh is None and tree.inst_bvh is not None
    rays = spec.camera.generate_rays("cpu")
    arena = tracer.make_arena(rays, 1)
    a = tracer.trace_image(scan, arena, 32, 32, max_rounds=16)
    b = tracer.trace_image(tree, arena, 32, 32, max_rounds=16)
    assert torch.equal(a, b) and tp.lit(a) > 0.1
    assert torch.equal(tracer.trace_image_fast_multi(scan, rays, 32, 32),
                       tracer.trace_image_fast_multi(tree, rays, 32, 32))


def test_tree_threshold():
    """64 instances build the tree on their own, 63 do not, one never."""
    spec = chip_smoke.make_multi_scene(0, 16, 16, bands=4, grid=(8, 8))
    s64 = build_scene(spec.meshes, spec.instances, spec.lights, device="cpu")
    s63 = build_scene(spec.meshes, spec.instances[:63], spec.lights,
                      device="cpu")
    one = build_scene(spec.meshes, spec.instances[:1], spec.lights,
                      device="cpu", instance_bvh=True)
    assert s64.inst_bvh is not None and s64.inst_bvh.num_nodes == 127
    assert s63.inst_bvh is None and one.inst_bvh is None
