"""Core modules of the port (gravit_tpu_torch) against the JAX package on
the CPU: the per-ray hash, camera rays, shading, byte conversion and the
device rule. Inputs are made from seeds with numpy and fed to both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravit_tpu.core import rng as jax_rng
from gravit_tpu.core.rays import RayArena as JaxArena
from gravit_tpu.scene import image as jax_image
from gravit_tpu.scene import material as jax_material
from gravit_tpu.scene.camera import PerspectiveCamera as JaxCamera

from gravit_tpu_torch import resolve_device
from gravit_tpu_torch.core import rng
from gravit_tpu_torch.core.rays import RayArena
from gravit_tpu_torch.scene import image, material
from gravit_tpu_torch.scene.camera import PerspectiveCamera

torch.set_num_threads(2)

# 2^20 consecutive ids plus the int32 / uint32 edge values
IDS = np.concatenate([np.arange(1 << 20),
                      [2**31 - 1, 2**31 - 2, -1, -2, -2**31]]).astype(np.int32)


def test_mix_bit_equal_on_edge_values():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                 np.uint32)
    ref = np.asarray(jax_rng._mix(jnp.asarray(x)))
    got = rng._mix(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("salt", [0, 11, 991, 992 * 2 + 2])
@pytest.mark.parametrize("with_extra", [False, True])
def test_hash_uniform_bit_equal(salt, with_extra):
    ids_j, ids_t = jnp.asarray(IDS), torch.from_numpy(IDS)
    extra_j = extra_t = None
    if with_extra:
        # the tracer's per-generation counter, over depths incl. -1
        depth = np.random.default_rng(salt).integers(-1, 7, IDS.shape[0])
        depth = depth.astype(np.int32)
        g = 5
        extra_j = (jnp.asarray(g).astype(jnp.uint32) * jnp.uint32(2654435761)
                   + jnp.asarray(depth).astype(jnp.uint32)
                   * jnp.uint32(40503))
        extra_t = rng.round_extra(g, torch.from_numpy(depth))
        np.testing.assert_array_equal(
            extra_t.numpy(), np.asarray(extra_j).astype(np.int64))
    ref = np.asarray(jax_rng.hash_uniform2(ids_j, salt, extra_j))
    got = rng.hash_uniform2(ids_t, salt, extra_t).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("jitter_mode", ["current", "golden"])
@pytest.mark.parametrize("samples", [1, 2])
def test_generate_rays(jitter_mode, samples):
    """Integer fields equal; unit directions within |d| <= 2^-22, 2 ulp at
    1.0 (measured: 1.2e-7). XLA contracts the camera's a*b+c terms into
    fused multiply-adds; the port rounds each operation."""
    cam = PerspectiveCamera(
        eye=(0.3, 0.2, 1.7), focus=(0.0, 0.05, 0.0), up=(0.1, 1.0, 0.0),
        fov=0.9, film_width=24, film_height=16, samples=samples,
        max_depth=3, jitter_window=0.5, jitter_mode=jitter_mode)
    ref = JaxCamera(**dataclasses.asdict(cam)).generate_rays()
    got = cam.generate_rays("cpu")
    for f in dataclasses.fields(got):
        r, g = np.asarray(getattr(ref, f.name)), getattr(got, f.name).numpy()
        if f.name == "direction":
            assert np.abs(g - r).max() <= 2.0**-22, f.name
        else:
            np.testing.assert_array_equal(g, r, err_msg=f.name)


def _shade_inputs(seed: int, n: int = 4096):
    rng_ = np.random.default_rng(seed)

    def unit(shape):
        v = rng_.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    f32 = lambda *s: rng_.uniform(0.0, 1.0, s).astype(np.float32)  # noqa
    normal = unit((n, 3))
    wi = unit((n, 3))
    wi = np.where((wi * normal).sum(-1, keepdims=True) < 0, -wi, wi)
    return dict(
        mat_type=rng_.integers(0, 6, n).astype(np.int32),
        kd=f32(n, 3), ks=f32(n, 3),
        alpha=rng_.uniform(1.0, 20.0, n).astype(np.float32),
        embree=(f32(n, 3) + 0.1, f32(n, 3) * 3.0, f32(n) * 0.3 + 0.01,
                f32(n, 3), f32(n) * 2.0, f32(n) * 2.0),
        ray_dir=unit((n, 3)), ray_w=f32(n), normal=normal, wi=wi)


@pytest.mark.parametrize("has_specular", [True, False])
@pytest.mark.parametrize("embree", [True, False])
def test_shade_full(has_specular, embree):
    """lambert, phong, blinn and the embree family, within rtol 1e-6 (and
    atol 1e-7 near zero): power and division differ by ulps between XLA
    and torch."""
    x = _shade_inputs(7)
    to_j = lambda a: jnp.asarray(a)  # noqa: E731
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = ("mat_type", "kd", "ks", "alpha")
    tail = ("ray_dir", "ray_w", "normal", "wi")
    emb = x["embree"] if embree else None
    ref = jax_material.shade_full(
        *(to_j(x[k]) for k in args),
        None if emb is None else tuple(to_j(a) for a in emb),
        *(to_j(x[k]) for k in tail), has_specular=has_specular)
    got = material.shade_full(
        *(to_t(x[k]) for k in args),
        None if emb is None else tuple(to_t(a) for a in emb),
        *(to_t(x[k]) for k in tail), has_specular=has_specular)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_to_rgb8_and_clamp_equal():
    fb = np.random.default_rng(3).uniform(-0.2, 1.3, (24 * 16, 4))
    fb = fb.astype(np.float32)
    np.testing.assert_array_equal(image.to_rgb8(torch.from_numpy(fb), 24, 16),
                                  jax_image.to_rgb8(fb, 24, 16))
    np.testing.assert_array_equal(
        image.clamp_rgb(torch.from_numpy(fb)).numpy(),
        np.asarray(jax_image.clamp_rgb(jnp.asarray(fb))))


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerspectiveCamera(film_width=8, film_height=8).generate_rays()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_ray_arena_zeros_equal():
    ref, got = JaxArena.zeros(37), RayArena.zeros(37, "cpu")
    assert got.capacity == ref.capacity == 37
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
