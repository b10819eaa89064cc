"""The port's volume scene pieces against the JAX package's, on the CPU:
wavelet_volume, the transfer function, build_volume_scene (through
interop.volume_scene_from_numpy) and the volume camera rays.

Tolerances, and why:
- wavelet_volume, gray_ramp, _resample_256: the same numpy code, bit-equal.
- apply_tf: <= 1e-6 absolute on values in [0, 1] (XLA's CPU backend
  contracts a*b+c into fused multiply-adds, the port rounds each operation).
- build_volume_scene: every tensor bit-equal (numpy on both sides), every
  static field equal.
- generate_rays(volume=True): directions <= 1e-6, every other field equal.

The helpers below (to_jax_volume, jax_volume_scene, port_scene_of) are shared
with the other tests/test_torch_volume_*.py and test_torch_slice_march.py.
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
from gravit_tpu.render.volume_scene import build_volume_scene as jax_build  # noqa: E402
from gravit_tpu.scene import transfer as jax_transfer  # noqa: E402
from gravit_tpu.scene import volume as jax_volume  # noqa: E402
from gravit_tpu.scene.camera import PerspectiveCamera as JaxCamera  # noqa: E402

from gravit_tpu_torch import interop  # noqa: E402
from gravit_tpu_torch.render import volume_scene as vs  # noqa: E402
from gravit_tpu_torch.scene import transfer, volume  # noqa: E402

torch.set_num_threads(2)


def to_jax_volume(v: volume.Volume) -> jax_volume.Volume:
    """The JAX package's Volume with the port Volume's numpy fields."""
    tf = jax_transfer.TransferFunction(v.tf.color_lut, v.tf.opacity_lut,
                                       v.tf.low, v.tf.high)
    out = jax_volume.Volume(
        samples=v.samples, origin=v.origin, spacing=v.spacing,
        sampling_rate=v.sampling_rate, tf=tf, level=v.level,
        isovalues=tuple(v.isovalues), slices=tuple(v.slices))
    out.subgrids = [to_jax_volume(dataclasses.replace(s, tf=v.tf))
                    for s in v.subgrids]
    return out


def jax_volume_scene(spec: chip_smoke.VolumeSpec):
    return jax_build([to_jax_volume(v) for v in spec.volumes],
                     spec.instances)


def jax_camera(cam) -> JaxCamera:
    return JaxCamera(**dataclasses.asdict(cam))


def scene_leaves(jscene) -> tuple:
    """(arrays, static) of a JAX VolumeSceneData, as interop takes them."""
    arrays = {n: [np.asarray(x) for x in getattr(jscene, n)]
              for n in vs.VOLUME_TENSOR_FIELDS}
    arrays.update({n: np.asarray(getattr(jscene, n))
                   for n in vs.INSTANCE_TENSOR_FIELDS})
    arrays["vol_subgrids"] = tuple(
        tuple(tuple(np.asarray(x) for x in sub) for sub in subs)
        for subs in jscene.vol_subgrids)
    static = {n: getattr(jscene, n) for n in vs.STATIC_FIELDS}
    return arrays, static


def port_scene_of(jscene) -> vs.VolumeSceneData:
    arrays, static = scene_leaves(jscene)
    return interop.volume_scene_from_numpy(arrays, device="cpu", **static)


def ray_leaves(jrays) -> dict:
    return {f.name: np.asarray(getattr(jrays, f.name))
            for f in dataclasses.fields(jrays)}


# ---------------------------------------------------------------------------


def test_wavelet_volume_is_the_same_numpy():
    a, b = volume.wavelet_volume(20, 2.0), jax_volume.wavelet_volume(20, 2.0)
    np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_array_equal(a.tf.opacity_lut, b.tf.opacity_lut)
    np.testing.assert_array_equal(a.tf.color_lut, b.tf.color_lut)
    assert (a.tf.low, a.tf.high) == (b.tf.low, b.tf.high)
    assert a.step_size() == b.step_size() and a.max_steps() == b.max_steps()
    np.testing.assert_array_equal(a.bounds_max, b.bounds_max)
    np.testing.assert_array_equal(a.counts, b.counts)
    flat = a.samples.reshape(-1)
    c = volume.Volume.from_flat(flat, (20, 20, 20), (1, 2, 3), (1, 1, 2))
    d = jax_volume.Volume.from_flat(flat, (20, 20, 20), (1, 2, 3), (1, 1, 2))
    np.testing.assert_array_equal(c.samples, d.samples)
    np.testing.assert_array_equal(c.bounds_max, d.bounds_max)


def test_resample_256_and_gray_ramp():
    rng = np.random.default_rng(11)
    xs = np.sort(rng.uniform(0.0, 10.0, 9))
    ys = rng.uniform(0.0, 1.0, (9, 3))
    np.testing.assert_array_equal(transfer._resample_256(xs, ys),
                                  jax_transfer._resample_256(xs, ys))
    np.testing.assert_array_equal(transfer._resample_256(xs, ys[:, 0]),
                                  jax_transfer._resample_256(xs, ys[:, 0]))
    a = transfer.TransferFunction.gray_ramp(-2.0, 5.0, 0.3)
    b = jax_transfer.TransferFunction.gray_ramp(-2.0, 5.0, 0.3)
    np.testing.assert_array_equal(a.color_lut, b.color_lut)
    np.testing.assert_array_equal(a.opacity_lut, b.opacity_lut)


def test_from_files(tmp_path):
    rng = np.random.default_rng(12)
    xs = np.sort(rng.uniform(0.0, 10.0, 6))
    cmap = np.concatenate([xs[:, None], rng.uniform(0, 1, (6, 3))], axis=1)
    omap = np.stack([xs, rng.uniform(0, 1, 6)], axis=1)
    for name, table in (("c.cmap", cmap), ("o.omap", omap)):
        rows = "\n".join(" ".join(repr(float(x)) for x in r) for r in table)
        (tmp_path / name).write_text(f"{len(table)}\n{rows}\n")
    args = (str(tmp_path / "c.cmap"), str(tmp_path / "o.omap"), 1.0, 7.0)
    a = transfer.TransferFunction.from_files(*args)
    b = jax_transfer.TransferFunction.from_files(*args)
    np.testing.assert_array_equal(a.color_lut, b.color_lut)
    np.testing.assert_array_equal(a.opacity_lut, b.opacity_lut)
    assert (a.low, a.high) == (1.0, 7.0)


def test_apply_tf_inside_and_outside_the_range():
    """<= 1e-6 on values in [0, 1]; scalars below low and above high clamp
    to the first and last entry on both sides."""
    rng = np.random.default_rng(13)
    color = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    opacity = rng.uniform(0, 1, 256).astype(np.float32)
    vrange = np.asarray([-3.0, 9.0], np.float32)
    s = rng.uniform(-6.0, 12.0, (64, 5)).astype(np.float32)
    s[0, :3] = (-3.0, 9.0, 3.0)
    jrgb, ja = jax_transfer.apply_tf(jnp.asarray(color), jnp.asarray(opacity),
                                     jnp.asarray(vrange), jnp.asarray(s))
    trgb, ta = transfer.apply_tf(torch.tensor(color), torch.tensor(opacity),
                                 torch.tensor(vrange), torch.tensor(s))
    assert trgb.shape == (64, 5, 3) and ta.shape == (64, 5)
    assert np.abs(trgb.numpy() - np.asarray(jrgb)).max() <= 1e-6
    assert np.abs(ta.numpy() - np.asarray(ja)).max() <= 1e-6
    below, above = torch.tensor(s) < -3.0, torch.tensor(s) > 9.0
    assert below.any() and above.any()
    np.testing.assert_array_equal(ta[below].numpy(),
                                  np.full(int(below.sum()), opacity[0]))
    np.testing.assert_array_equal(ta[above].numpy(),
                                  np.full(int(above.sum()), opacity[255]))


@pytest.mark.parametrize("kind", chip_smoke.VOLUME_KINDS)
def test_build_volume_scene_matches_jax(kind):
    spec = chip_smoke.make_volume_scene(kind, n=16, width=8, height=8)
    if kind == "plain":     # a non-identity placement too
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.diag([2.0, 1.5, 0.5])
        m[:3, 3] = (3.0, -2.0, 1.0)
        spec.instances = [(0, m)]
    jscene = jax_volume_scene(spec)
    carried = port_scene_of(jscene)
    built = vs.build_volume_scene(spec.volumes, spec.instances, device="cpu")
    for name in vs.VOLUME_TENSOR_FIELDS:
        for a, b in zip(getattr(built, name), getattr(carried, name),
                        strict=True):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    for name in vs.INSTANCE_TENSOR_FIELDS:
        a, b = getattr(built, name), getattr(carried, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    for name in vs.STATIC_FIELDS:
        assert getattr(built, name) == getattr(jscene, name), name
    assert len(built.vol_subgrids) == len(jscene.vol_subgrids)
    for subs_a, subs_b in zip(built.vol_subgrids, jscene.vol_subgrids):
        assert len(subs_a) == len(subs_b)
        for sa, sb in zip(subs_a, subs_b):
            for a, b in zip(sa, sb, strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind == "amr":
        assert len(built.vol_subgrids[0]) == 1
    with pytest.raises(TypeError):
        interop.volume_scene_from_numpy(scene_leaves(jscene)[0],
                                        device="cpu", no_such_field=1)


def test_build_volume_scene_needs_a_transfer_function():
    v = volume.wavelet_volume(8)
    v.tf = None
    with pytest.raises(ValueError):
        vs.build_volume_scene([v], [(0, np.eye(4, dtype=np.float32))],
                              device="cpu")


def test_volume_camera_rays_match_jax():
    spec = chip_smoke.make_volume_scene("plain", n=32, width=24, height=20,
                                        eye=(4.4, 4.0, 4.0))
    jr = ray_leaves(jax_camera(spec.camera).generate_rays(volume=True))
    tr = spec.camera.generate_rays("cpu", volume=True)
    for name, ref in jr.items():
        got = getattr(tr, name).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if name == "direction":
            assert np.abs(got - ref).max() <= 1e-6
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (jr["w"] == 0).all() and (jr["depth"] == 0).all()
    assert (jr["type"] == 1).all()
