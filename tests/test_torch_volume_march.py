"""The port's gather march (gravit_tpu_torch/ops/volume_march.py) against the
JAX package's, on the CPU, on the same seeded inputs.

Tolerances, and why:
- trilinear, sample_amr, field_gradient on a seeded field in [0, 1]:
  <= 1e-5 absolute (XLA's CPU backend contracts a*b+c into fused
  multiply-adds, the port rounds each operation); with and without the
  corner table the port gives the same bits.
- march_brick (plain, iso, slice plane, AMR, all together; early_exit on and
  off): color and w <= 1e-5, flags equal. A ray whose w lands within 1e-5 of
  the 0.99 termination threshold, or whose iso / slice crossing moves by a
  step, is an event ray: counted, and at most 0.1% of rays.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gravit_tpu.ops import volume_march as jvm  # noqa: E402
from gravit_tpu_torch.ops import volume_march as tvm  # noqa: E402
from gravit_tpu_torch.scene.volume import wavelet_volume  # noqa: E402

torch.set_num_threads(2)


def both(x):
    x = np.asarray(x)
    return jnp.asarray(x), torch.tensor(x)


def seeded_field(seed=21, shape=(12, 14, 16)):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(0, 1, shape).astype(np.float32)
    origin = np.asarray([0.5, -1.0, 2.0], np.float32)
    spacing = np.asarray([0.5, 1.0, 0.25], np.float32)
    hi = origin + (np.asarray(shape[::-1]) - 1) * spacing
    pos = rng.uniform(origin - 1.0, hi + 1.0, (500, 3)).astype(np.float32)
    sub = (rng.uniform(0, 1, (6, 6, 6)).astype(np.float32),
           np.asarray([2.0, 2.0, 3.0], np.float32),
           np.asarray([0.25, 0.5, 0.125], np.float32),
           np.asarray([2.0, 2.0, 3.0], np.float32),
           np.asarray([3.25, 4.5, 3.625], np.float32))
    pos[:60] = rng.uniform(sub[3], sub[4], (60, 3))     # inside the subgrid
    return samples, origin, spacing, pos, sub


def test_trilinear_and_corner_table():
    samples, origin, spacing, pos, _ = seeded_field()
    (js, ts), (jo, to), (jsp, tsp), (jp, tp) = map(
        both, (samples, origin, spacing, pos))
    ref = np.asarray(jvm.trilinear(js, jo, jsp, jp))
    got = tvm.trilinear(ts, to, tsp, tp)
    assert np.abs(got.numpy() - ref).max() <= 1e-5
    table = tvm.corner_table(ts)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jvm.corner_table(js)))
    np.testing.assert_array_equal(
        tvm.trilinear(ts, to, tsp, tp, corners=table).numpy(), got.numpy())


def test_sample_amr_and_field_gradient():
    samples, origin, spacing, pos, sub = seeded_field(22)
    (js, ts), (jo, to), (jsp, tsp), (jp, tp) = map(
        both, (samples, origin, spacing, pos))
    jsub = tuple(jnp.asarray(x) for x in sub)
    tsub = tuple(torch.tensor(x) for x in sub)
    inside = np.all((pos >= sub[3]) & (pos <= sub[4]), axis=-1)
    assert inside.sum() > 3          # the override is exercised
    ref = np.asarray(jvm.sample_amr(js, jo, jsp, jp, (jsub,)))
    got = tvm.sample_amr(ts, to, tsp, tp, (tsub,)).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    plain = tvm.sample_amr(ts, to, tsp, tp).numpy()
    assert np.abs(got - plain)[inside].max() > 1e-3
    # batched positions of rank 3, as the march passes them
    jp3, tp3 = both(pos[:480].reshape(60, 8, 3))
    ref = np.asarray(jvm.field_gradient(js, jo, jsp, jp3, (jsub,)))
    got = tvm.field_gradient(ts, to, tsp, tp3, (tsub,)).numpy()
    assert got.shape == (60, 8, 3)
    assert np.abs(got - ref).max() <= 1e-5


def march_inputs(n=24, n_rays=1536, seed=23):
    """Rays from a sphere around the wavelet brick towards points inside
    it, a share of them inactive, carrying seeded color and opacity."""
    rng = np.random.default_rng(seed)
    vol = wavelet_volume(n)
    c = (n - 1) / 2.0
    o = rng.normal(size=(n_rays, 3))
    o = c + 2.5 * n * o / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(0.15 * n, 0.85 * n, (n_rays, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n_rays // 8] *= 0.5            # t in units of |d|
    active = rng.uniform(size=n_rays) < 0.9
    color = rng.uniform(0, 0.2, (n_rays, 3))
    w = rng.uniform(0, 0.3, n_rays)
    arrays = dict(o=o, d=d, color=color, w=w)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    sub = wavelet_volume(n // 2)
    subgrid = (sub.samples, np.full(3, n / 4.0, np.float32),
               np.full(3, 0.5, np.float32), np.full(3, n / 4.0, np.float32),
               np.full(3, n / 4.0 + 0.5 * (n // 2 - 1), np.float32))
    return vol, arrays, active, subgrid


CASES = {
    "plain": {},
    "iso": dict(iso=True),
    "slice": dict(slices=True),
    "amr": dict(amr=True),
    "all": dict(iso=True, slices=True, amr=True),
}


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_march_brick_matches_jax(case, early_exit):
    n = 24
    vol, a, active, subgrid = march_inputs(n)
    feat = CASES[case]
    isovalues = (float(vol.samples.mean()),) if feat.get("iso") else ()
    slices = ((1.0, 0.2, 0.1, -0.5625 * n),) if feat.get("slices") else ()
    vrange = np.asarray([vol.tf.low, vol.tf.high], np.float32)

    def run(march, conv):
        subs = (tuple(conv(x) for x in subgrid),) if feat.get("amr") else ()
        return march(
            conv(a["o"]), conv(a["d"]), conv(active), conv(a["color"]),
            conv(a["w"]), conv(vol.samples), conv(vol.origin),
            conv(vol.spacing), conv(vol.bounds_min), conv(vol.bounds_max),
            conv(vol.tf.color_lut), conv(vol.tf.opacity_lut), conv(vrange),
            float(vol.step_size()), vol.max_steps(), subgrids=subs,
            isovalues=isovalues, slices=slices, early_exit=early_exit)

    jc, jw, jf = (np.asarray(x) for x in run(jvm.march_brick, jnp.asarray))
    tc, tw, tf_ = (x.numpy() for x in run(tvm.march_brick, torch.tensor))
    err = np.maximum(np.abs(tc - jc).max(axis=1), np.abs(tw - jw))
    near = (np.abs(jw - 0.99) <= 1e-5) | (np.abs(tw - 0.99) <= 1e-5)
    event = near | (err > 1e-5)
    assert event.sum() <= 1e-3 * len(err), (int(event.sum()), err.max())
    np.testing.assert_array_equal(tf_[~event], jf[~event])
    assert (tf_[~active] == 0).all()
    np.testing.assert_array_equal(tc[~active], a["color"][~active])
    if feat.get("iso") or feat.get("slices"):
        assert (tw > 0.99).sum() > 50         # crossings fire
    if case == "amr":
        base = tvm.march_brick(
            *(torch.tensor(x) for x in (
                a["o"], a["d"], active, a["color"], a["w"], vol.samples,
                vol.origin, vol.spacing, vol.bounds_min, vol.bounds_max,
                vol.tf.color_lut, vol.tf.opacity_lut, vrange)),
            float(vol.step_size()), vol.max_steps())[0].numpy()
        assert np.abs(base - tc).max() > 1e-3    # the subgrid is seen


def test_march_brick_chunk_does_not_change_the_result():
    """chunk=3 against chunk=8: identical (the chunk only batches the
    sampling; the alive check runs at chunk boundaries)."""
    vol, a, active, _ = march_inputs(16, 256)
    vrange = np.asarray([vol.tf.low, vol.tf.high], np.float32)
    args = [torch.tensor(x) for x in (
        a["o"], a["d"], active, a["color"], a["w"], vol.samples, vol.origin,
        vol.spacing, vol.bounds_min, vol.bounds_max, vol.tf.color_lut,
        vol.tf.opacity_lut, vrange)]
    r8 = tvm.march_brick(*args, float(vol.step_size()), vol.max_steps())
    r3 = tvm.march_brick(*args, float(vol.step_size()), vol.max_steps(),
                         chunk=3)
    for x, y in zip(r8, r3):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_march_brick_is_differentiable():
    """Gradients reach the samples and the opacity LUT through the gather
    march (early_exit=False, the gradient path's form)."""
    vol, a, active, _ = march_inputs(12, 64)
    vrange = torch.tensor([vol.tf.low, vol.tf.high])
    samples = torch.tensor(vol.samples, requires_grad=True)
    opacity = torch.tensor(vol.tf.opacity_lut, requires_grad=True)
    color, w, _ = tvm.march_brick(
        torch.tensor(a["o"]), torch.tensor(a["d"]), torch.tensor(active),
        torch.tensor(a["color"]), torch.tensor(a["w"]), samples,
        torch.tensor(vol.origin), torch.tensor(vol.spacing),
        torch.tensor(vol.bounds_min), torch.tensor(vol.bounds_max),
        torch.tensor(vol.tf.color_lut), opacity, vrange,
        float(vol.step_size()), vol.max_steps(), early_exit=False)
    (color.sum() + w.sum()).backward()
    assert torch.isfinite(samples.grad).all() and samples.grad.abs().sum() > 0
    assert torch.isfinite(opacity.grad).all() and opacity.grad.abs().sum() > 0
