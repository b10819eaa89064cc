"""Materials and shading models, counterpart of gravit_tpu/scene/material.py.

Reference: data/primitives/Material.{h,cpp}. Shading is vectorized over rays;
`shade()` replicates Shade() (Material.cpp:90-139).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from gravit_tpu_torch.core.math3d import dot3


class MaterialType(enum.IntEnum):
    """Material.h:50-57."""

    LAMBERT = 0
    PHONG = 1
    BLINN = 2
    EMBREE_MATERIAL_METAL = 3
    EMBREE_MATERIAL_VELVET = 4
    EMBREE_MATERIAL_MATTE = 5


@dataclasses.dataclass
class Material:
    type: int = int(MaterialType.LAMBERT)
    kd: tuple = (0.5, 0.5, 0.5)
    ks: tuple = (0.5, 0.5, 0.5)
    alpha: float = 1.0
    # Embree-material params, reference defaults = copper (Material.h:61-75)
    eta: tuple = (0.19, 1.45, 1.50)
    k: tuple = (3.06, 2.40, 1.88)
    roughness: float = 0.05
    horizon_scatter_color: tuple = (0.5, 0.5, 0.5)
    back_scattering: float = 0.0
    horizon_scatter_falloff: float = 0.0


def _clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def eval_embree(mat_type, ks, eta, k_, roughness, hsc, bs, hsf,
                wo, normal, wi, kd):
    """Embree-shaders BRDF family (EmbreeMaterial.h / optics.h): matte,
    velvet (Minneart + Velvety) and metal (microfacet conductor). Returns
    eval BEFORE the 2*w factor of Shade() (Material.cpp:112-120)."""
    ndwi = dot3(normal, wi)
    ndwo = dot3(normal, wo)

    matte = kd * _clamp01(ndwi)[:, None]

    one_over_pi = 1.0 / math.pi
    cos_i = _clamp01(ndwi)
    back = torch.pow(_clamp01(dot3(wo, wi)), bs)
    minneart = ks * (back * cos_i * one_over_pi)[:, None]
    cos_o = _clamp01(ndwo)
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    horizon = torch.pow(sin_o, hsf)
    velvety = hsc * (horizon * cos_i * one_over_pi)[:, None]
    velvet = minneart + velvety

    wh = wi + wo
    wh = wh / torch.sqrt(torch.clamp(dot3(wh, wh), min=1e-30))[:, None]
    cos_h = dot3(wh, normal)
    cos_t = dot3(wi, wh)
    tmp = eta * eta + k_ * k_
    c2 = (cos_t * cos_t)[:, None]
    ct = cos_t[:, None]
    rpar = (tmp * c2 - 2.0 * eta * ct + 1.0) / torch.clamp(
        tmp * c2 + 2.0 * eta * ct + 1.0, min=1e-30)
    rper = (tmp - 2.0 * eta * ct + c2) / torch.clamp(
        tmp + 2.0 * eta * ct + c2, min=1e-30)
    fres = 0.5 * (rpar + rper)
    exp = 1.0 / torch.clamp(roughness, min=1e-6)
    dist = (exp + 2.0) * (1.0 / (2.0 * math.pi)) * torch.pow(
        torch.abs(cos_h), exp)
    safe_ct = torch.where(torch.abs(cos_t) < 1e-30, 1.0, cos_t)
    g = torch.minimum(torch.ones_like(cos_h),
                      torch.minimum(2.0 * cos_h * ndwo / safe_ct,
                                    2.0 * cos_h * ndwi / safe_ct))
    metal = ks * fres * (dist * g)[:, None] / torch.clamp(
        4.0 * ndwo, min=1e-30)[:, None]
    metal = torch.where(((ndwi <= 0.0) | (ndwo <= 0.0))[:, None], 0.0, metal)

    return torch.where(
        (mat_type == int(MaterialType.EMBREE_MATERIAL_METAL))[:, None],
        metal,
        torch.where(
            (mat_type == int(MaterialType.EMBREE_MATERIAL_VELVET))[:, None],
            velvet, matte))


def shade(mat_type, kd, ks, alpha, ray_dir, ray_w, normal, wi,
          has_specular: bool = True):
    """Per-ray shading model dispatch; (N, 3) model color BEFORE the light
    contribution factor.
      lambert:     kd * NdotL * w                         (Material.cpp:50-57)
      phong:       + ks * (VdotR * VdotR^alpha) * w       (Material.cpp:59-73)
      blinn-phong: + ks * (NdotH * NdotH^alpha) * w       (Material.cpp:75-87)
    has_specular=False (scene-level: no phong/blinn triangle) skips the two
    provably dead power branches; the selects would pick `diffuse` anyway.
    """
    ndotl = torch.clamp(dot3(normal, wi), min=0.0)
    diffuse = kd * (ndotl * ray_w)[:, None]
    if not has_specular:
        return diffuse

    r = normal * (2.0 * ndotl)[:, None] - wi
    vdotr = torch.clamp(dot3(r, -ray_dir), min=0.0)
    phong = diffuse + ks * (vdotr * torch.pow(vdotr, alpha) * ray_w)[:, None]

    h = wi - ray_dir
    h = h / torch.sqrt(torch.clamp(dot3(h, h), min=1e-30))[:, None]
    ndoth = torch.clamp(dot3(h, normal), min=0.0)
    blinn = diffuse + ks * (ndoth * torch.pow(ndoth, alpha) * ray_w)[:, None]

    return torch.where(
        (mat_type == int(MaterialType.PHONG))[:, None], phong,
        torch.where((mat_type == int(MaterialType.BLINN))[:, None],
                    blinn, diffuse))


def shade_full(mat_type, kd, ks, alpha, embree_params, ray_dir, ray_w,
               normal, wi, has_specular: bool = True):
    """shade() extended with the Embree family: legacy models get model*w,
    embree types 2*eval*w (Material.cpp:112-120)."""
    legacy = shade(mat_type, kd, ks, alpha, ray_dir, ray_w, normal, wi,
                   has_specular=has_specular)
    if embree_params is None:
        return legacy
    eta, k_, rough, hsc, bs, hsf = embree_params
    emb = eval_embree(mat_type, ks, eta, k_, rough, hsc, bs, hsf,
                      -ray_dir, normal, wi, kd)
    emb = 2.0 * emb * ray_w[:, None]
    is_emb = (mat_type >= int(MaterialType.EMBREE_MATERIAL_METAL))[:, None]
    return torch.where(is_emb, emb, legacy)
