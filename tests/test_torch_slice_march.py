"""The port's slice engine on the CPU (its plain version,
gravit_tpu_torch/ops/slice_march.py) against the JAX package's
`slice_march_reference` AND its Pallas kernel in interpret mode, on the same
camera rays and the same seeded bricks.

Tolerance, and why: color and w <= 1e-5, flags equal. The port gathers the
hat weights' two nonzero taps where the reference multiplies by the dense
hat matrix (the skipped terms are exact zeros), and XLA's CPU backend
contracts a*b+c into fused multiply-adds where the port rounds each
operation, so single results differ by ulps (measured: <= 1.2e-6). Three
discrete events can turn an ulp into a large difference for a single ray:
saturation (w >= 0.99), an isosurface crossing and a slice-plane crossing
can each move by one plane. Such EVENT rays (w within 1e-5 of 0.99 on either
side, or a crossing on one side only, or a crossing ray whose color differs
by more than the tolerance) are counted and limited to 0.1% of the rays,
never dropped silently; every other ray must be within the tolerance.
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

import chip_smoke  # noqa: E402
from gravit_tpu.ops import slice_march as jsm  # noqa: E402
from gravit_tpu_torch.ops import slice_march as tsm  # noqa: E402
from gravit_tpu_torch.scene.volume import wavelet_volume  # noqa: E402
from test_torch_volume_scene import jax_camera, ray_leaves  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def setup(n=24, film=32, eye=(4.4, 4.0, 4.0), spacing=(1.0, 1.0, 1.0),
          rate=1.0, features=()):
    """Numpy inputs of one slice march: JAX camera rays around a wavelet
    brick of n^3 samples with the given grid spacing, plus the feature
    arguments named in `features` ("iso", "amr", "slice")."""
    vol = wavelet_volume(n, sampling_rate=rate)
    vol.spacing = np.asarray(spacing, np.float32)
    spec = chip_smoke.make_volume_scene("plain", n=n, width=film, height=film,
                                        eye=eye)
    c = tuple(float(x) for x in (n - 1) / 2.0 * vol.spacing)
    cam = dataclasses.replace(
        spec.camera, focus=c,
        eye=tuple(e * n * s for e, s in zip(eye, spacing)))
    rays = ray_leaves(jax_camera(cam).generate_rays(volume=True))
    axis, flip = jsm.choose_slice_axis(rays["direction"].mean(0))
    nrays = rays["origin"].shape[0]
    rng = np.random.default_rng(31)
    arrays = [rays["origin"], rays["direction"],
              rng.uniform(size=nrays) < 0.95,
              rng.uniform(0, 0.1, (nrays, 3)).astype(np.float32),
              rng.uniform(0, 0.2, nrays).astype(np.float32),
              vol.samples, vol.tf.color_lut, vol.tf.opacity_lut]
    meta = dict(axis=axis, flip=flip, step=float(vol.step_size()),
                base_step=float(vol.spacing.min()),
                low=float(vol.tf.low), high=float(vol.tf.high),
                origin=tuple(float(x) for x in vol.origin),
                spacing=tuple(float(x) for x in vol.spacing))
    feat = {}
    if "iso" in features:
        feat["isovalues"] = (float(vol.samples.mean()),)
    if "slice" in features:
        # through the brick's centre, in object space
        nrm = np.asarray([1.0, 0.2, 0.1])
        feat["slices"] = ((1.0, 0.2, 0.1, -float(nrm @ np.asarray(c))),)
    if "amr" in features:
        # a level-1 subgrid with half the spacing over the central octant;
        # its cell counts stay within the main grid's
        sub = wavelet_volume(n // 2)
        sp = 0.5 * vol.spacing
        lo = n / 4.0 * vol.spacing
        feat["subgrids"] = ((sub.samples, lo.astype(np.float32),
                             sp.astype(np.float32), lo.astype(np.float32),
                             (lo + (n // 2 - 1) * sp).astype(np.float32)),)
    return arrays, meta, feat


def run_jax(fn, arrays, meta, feat, **kw):
    feat = dict(feat)
    if "subgrids" in feat:
        feat["subgrids"] = tuple(tuple(jnp.asarray(x) for x in sub)
                                 for sub in feat["subgrids"])
    out = fn(*(jnp.asarray(a) for a in arrays), **meta, **feat, **kw)
    return tuple(np.asarray(x) for x in out)


def run_port(fn, arrays, meta, feat, **kw):
    feat = dict(feat)
    if "subgrids" in feat:
        feat["subgrids"] = tuple(tuple(torch.tensor(x) for x in sub)
                                 for sub in feat["subgrids"])
    out = fn(*(torch.tensor(a) for a in arrays), **meta, **feat, **kw)
    return tuple(x.numpy() for x in out)


def assert_same_march(got, ref, featured: bool, what: str) -> int:
    """Hold (color, w, flags) of two marches to TOL apart from counted event
    rays; returns the number of event rays."""
    (gc, gw, gf), (rc, rw, rf) = got, ref
    err = np.maximum(np.abs(gc - rc).max(axis=1), np.abs(gw - rw))
    event = (np.abs(gw - 0.99) <= 1e-5) | (np.abs(rw - 0.99) <= 1e-5)
    if featured:       # a crossing sets w to exactly 1
        gx, rx = gw == 1.0, rw == 1.0
        event |= (gx != rx) | (gx & rx & (err > TOL))
    n_event = int(event.sum())
    assert n_event <= 1e-3 * len(err), (what, n_event)
    assert err[~event].max() <= TOL, (what, float(err[~event].max()))
    np.testing.assert_array_equal(gf[~event], rf[~event], err_msg=what)
    return n_event


FEATURE_CASES = {
    "plain": (),
    "iso": ("iso",),
    "amr": ("amr",),
    "slice": ("slice",),
    "all": ("iso", "amr", "slice"),
}


@pytest.mark.parametrize("case", list(FEATURE_CASES))
def test_reference_matches_jax_reference_and_kernel(case):
    arrays, meta, feat = setup(features=FEATURE_CASES[case])
    got = run_port(tsm.slice_march_reference, arrays, meta, feat)
    ref = run_jax(jsm.slice_march_reference, arrays, meta, feat)
    kern = run_jax(jsm.slice_march, arrays, meta, feat, interpret=True)
    assert_same_march(got, ref, bool(feat), "jax reference")
    assert_same_march(got, kern, bool(feat), "jax kernel (interpret)")
    active = arrays[2]
    assert (got[2][~active] == 0).all()
    np.testing.assert_array_equal(got[0][~active], arrays[3][~active])
    assert (got[1][active] > arrays[4][active]).mean() > 0.1   # brick is seen
    if "iso" in feat or "slice" in feat:
        assert (got[1] == 1.0).sum() > 50                      # crossings fire
    if case == "amr":
        base = run_port(tsm.slice_march_reference, arrays, meta, {})
        assert np.abs(base[0] - got[0]).max() > 1e-3    # the subgrid is seen
    # the dispatching wrapper runs the plain version for CPU tensors
    wrapped = run_port(tsm.slice_march, arrays, meta, feat)
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a, b)


VIEWS = {
    # eye, in grid cells times n           -> expected (axis, flip)
    "x_flip": ((5.0, 0.6, 0.3), (0, True)),
    "x_noflip": ((-5.0, -0.6, -0.3), (0, False)),
    "y_flip": ((0.6, 3.0, 0.3), (1, True)),
    "z_noflip": ((-0.5, 1.0, -2.0), (2, False)),
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_axes_flips_and_spacing_match_jax(view):
    """Every feature at once, on a grid with spacing (0.5, 1, 2) and a
    sampling rate of 2, from four sides: both flips, all three axes."""
    eye, expect = VIEWS[view]
    arrays, meta, feat = setup(n=16, film=24, eye=eye,
                               spacing=(0.5, 1.0, 2.0), rate=2.0,
                               features=("iso", "amr", "slice"))
    assert (meta["axis"], meta["flip"]) == expect
    got = run_port(tsm.slice_march_reference, arrays, meta, feat)
    ref = run_jax(jsm.slice_march_reference, arrays, meta, feat)
    assert_same_march(got, ref, True, view)
    assert (got[1] == 1.0).sum() > 20


def test_slab_windows_match_the_whole_brick():
    """slab_bytes=16 KiB on a 32^3 brick (4 rows per window, 11 windows),
    64^2 film: the window ladder must match the whole-brick march (the
    reference holds its two kernels to 1e-6 here; the port's plain versions
    agree to the bit) and the JAX package's slab kernel."""
    arrays, meta, _ = setup(n=32, film=64)
    whole = run_port(tsm.slice_march, arrays, meta, {})
    slab = run_port(tsm.slice_march, arrays, meta, {}, slab_bytes=16 * 1024)
    for a, b in zip(slab, whole):
        np.testing.assert_array_equal(a, b)
    kern = run_jax(jsm.slice_march, arrays, meta, {}, interpret=True,
                   slab_bytes=16 * 1024)
    assert_same_march(slab, kern, False, "jax slab kernel (interpret)")
    assert tsm._windows(32, 4) == [(3 * s, min(3 * s + 3, 31))
                                   for s in range(11)]


@pytest.mark.parametrize("feature", ["iso", "amr", "slice"])
def test_features_on_an_oversize_brick_raise(feature):
    arrays, meta, feat = setup(n=16, film=32, features=(feature,))
    with pytest.raises(ValueError):
        run_jax(jsm.slice_march, arrays, meta, feat, interpret=True,
                slab_bytes=4 * 1024)
    with pytest.raises(ValueError, match="slab_bytes"):
        run_port(tsm.slice_march, arrays, meta, feat, slab_bytes=4 * 1024)


def test_wrapper_refuses_what_it_cannot_run():
    arrays, meta, feat = setup(n=16, film=8)
    with pytest.raises(ValueError, match="impl"):
        run_port(tsm.slice_march, arrays, meta, feat, impl="triton")
    t = [torch.tensor(a) for a in arrays]
    plan = tsm._prepare(t[0], t[1], t[2], t[5], t[6], t[7], **meta,
                        isovalues=(), subgrids=(), slices=())
    before = (tsm.launches_slice, tsm.launches_slab)
    with pytest.raises(ValueError, match="CUDA"):
        tsm._run_kernel(plan, t[3], t[4], 64)
    assert (tsm.launches_slice, tsm.launches_slab) == before


def test_hat_taps_equal_the_dense_hat_product():
    """The two gathered taps against sum_y Wy[y] * (Sz @ Wx)[y] with the
    dense hat matrices, for coordinates on and between the grid lines and
    half a cell outside it (the iso gradient taps reach there): the
    skipped columns weigh exactly 0, so the results are equal up to the
    order of two additions (<= 1e-6 on values in [0, 1])."""
    rng = np.random.default_rng(32)
    nS, nL = 9, 13
    Sz = torch.tensor(rng.uniform(0, 1, (nS, nL)).astype(np.float32))
    gx = torch.tensor(np.concatenate([
        rng.uniform(-0.5, nL - 0.5, 200), [0.0, nL - 1.0, -0.5, nL - 0.5, 3.0]
    ]).astype(np.float32))
    gy = torch.tensor(np.concatenate([
        rng.uniform(-0.5, nS - 0.5, 200), [nS - 1.0, 0.0, nS - 0.5, -0.5, 4.0]
    ]).astype(np.float32))
    Wx = torch.clamp(1.0 - torch.abs(gx[:, None] - torch.arange(nL)), min=0)
    Wy = torch.clamp(1.0 - torch.abs(gy[:, None] - torch.arange(nS)), min=0)
    dense = ((Wx @ Sz.T) * Wy).sum(dim=1)
    taps = tsm._bilinear(Sz.reshape(-1), nL, tsm._hat_taps(gx, nL),
                         tsm._hat_taps(gy, nS))
    assert float((taps - dense).abs().max()) <= 1e-6


def test_choose_slice_axis():
    for d in ([0.1, -0.9, 0.3], [0.5, 0.5, 0.6], [-1.0, 0.0, 0.0]):
        assert tsm.choose_slice_axis(d) == jsm.choose_slice_axis(d)


def test_gradients_flow_through_the_reference():
    arrays, meta, feat = setup(n=12, film=8, features=("amr",))
    t = [torch.tensor(a) for a in arrays]
    samples = t[5].clone().requires_grad_(True)
    opacity = t[7].clone().requires_grad_(True)
    subs = tuple(tuple(torch.tensor(x) for x in s) for s in feat["subgrids"])
    color, w, _ = tsm.slice_march_reference(
        t[0], t[1], t[2], t[3], t[4], samples, t[6], opacity, **meta,
        subgrids=subs)
    (color.sum() + w.sum()).backward()
    assert torch.isfinite(samples.grad).all() and samples.grad.abs().sum() > 0
    assert torch.isfinite(opacity.grad).all() and opacity.grad.abs().sum() > 0
