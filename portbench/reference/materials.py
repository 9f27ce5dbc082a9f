"""Frozen copy of moonshine_tpu_torch/bsdf/materials.py at commit 747dbd6,
for the plain reference (portbench/reference), less the functions the
reference does not call. Its docstring:

Branchless batched BSDFs (port of moonshine_tpu/bsdf/materials.py;
parity: shaders/hrtsystem/material.hlsl).

Every lane evaluates all four material models and selects by type code,
as the reference does. Directions are in the local frame (z = shading
normal); `w_o` points to the viewer, `w_i` to the light / next bounce.
Type codes follow the reference enum: Glass=0, Lambert=1, Mirror=2,
StandardPBR=3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .frame import cos_theta, same_hemisphere, tan2_theta
from .mappings import (
    coin_flip_remap,
    spherical_to_cartesian,
    square_to_cosine_hemisphere,
)
from . import mathutil as M
from .mathutil import AIR_IOR, PI, dot, safe_normalize

GLASS = 0
LAMBERT = 1
MIRROR = 2
STANDARD_PBR = 3


class MaterialLanes(NamedTuple):
    """Per-lane decoded material parameters."""

    type: torch.Tensor  # [N] int
    color: torch.Tensor  # [N, 3]
    metalness: torch.Tensor  # [N]
    alpha: torch.Tensor  # [N] GGX alpha = max(roughness^2, 1e-3)
    ior: torch.Tensor  # [N]


def _zeros(x):
    return torch.zeros_like(x)


# --- GGX (material.hlsl:20-67) ---

def ggx_d(alpha, m):
    a2 = alpha * alpha
    c2 = cos_theta(m) ** 2
    denom = PI * (c2 * (a2 - 1.0) + 1.0) ** 2
    return a2 / torch.clamp_min(denom, 1e-20)


def _ggx_lambda(alpha, v):
    t2 = tan2_theta(v)
    return (M.sqrt(1.0 + alpha * alpha * t2) - 1.0) / 2.0


def ggx_g(alpha, w_i, w_o):
    return 1.0 / (1.0 + _ggx_lambda(alpha, w_i) + _ggx_lambda(alpha, w_o))


def ggx_sample(alpha, w_o, square):
    tan2 = alpha * alpha * square[..., 0] / torch.clamp_min(
        1.0 - square[..., 0], 1e-8)
    cos2 = 1.0 / (1.0 + tan2)
    sin_t = M.sqrt(torch.clamp_min(1.0 - cos2, 0.0))
    cos_t = M.sqrt(cos2)
    phi = 2.0 * PI * square[..., 1]
    h = spherical_to_cartesian(sin_t, cos_t, phi)
    return torch.where(same_hemisphere(w_o, h)[..., None], h, -h)


def ggx_pdf(alpha, m):
    return ggx_d(alpha, m) * torch.abs(cos_theta(m))


# --- Fresnel (material.hlsl:71-123) ---

def schlick_weight(c):
    return M.pow(1.0 - c, 5)


def schlick_color(cos_t, r0_rgb):
    return r0_rgb + (1.0 - r0_rgb) * schlick_weight(cos_t)[..., None]


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact unpolarised dielectric Fresnel (PBRT form)."""
    c = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = c > 0.0
    # a Python ior is filled on the device, not copied from the host
    on_device = lambda x: (x.to(c.dtype) if torch.is_tensor(x) else
                           torch.full((), x, dtype=c.dtype, device=c.device))
    eta_i, eta_t = on_device(eta_i), on_device(eta_t)
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    c = torch.abs(c)
    sin_i = M.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = M.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    r_parl = (et * c - ei * cos_t) / torch.clamp_min(et * c + ei * cos_t,
                                                     1e-12)
    r_perp = (ei * c - et * cos_t) / torch.clamp_min(ei * c + et * cos_t,
                                                     1e-12)
    f = (r_parl * r_parl + r_perp * r_perp) / 2.0
    return torch.where(tir, torch.ones_like(f), f)


# --- Lambert (material.hlsl:137-175) ---

def _lambert_pdf(w_i, w_o):
    pdf = torch.abs(cos_theta(w_i)) / PI
    return torch.where(same_hemisphere(w_i, w_o), pdf, _zeros(pdf))


def _lambert_eval(color):
    return color / PI


def _lambert_sample(w_o, square):
    w_i = square_to_cosine_hemisphere(square)
    flip = cos_theta(w_o) < 0.0
    w_i = torch.stack([w_i[..., 0], w_i[..., 1],
                       torch.where(flip, -w_i[..., 2], w_i[..., 2])], dim=-1)
    return w_i, _lambert_pdf(w_i, w_o)


# --- StandardPBR (material.hlsl:179-270) ---

def _micro_pdf(alpha, w_i, w_o):
    h = safe_normalize(w_i + w_o)
    pdf = ggx_pdf(alpha, h) / torch.clamp_min(
        4.0 * dot(w_o, h, keepdims=False), 1e-12)
    return torch.where(same_hemisphere(w_o, w_i), pdf, _zeros(pdf))


def _micro_sample(alpha, w_o, square):
    h = ggx_sample(alpha, w_o, square)
    w_i = 2.0 * dot(w_o, h) * h - w_o
    pdf = ggx_pdf(alpha, h) / torch.clamp_min(
        4.0 * dot(w_o, h, keepdims=False), 1e-12)
    return w_i, torch.where(same_hemisphere(w_o, w_i), pdf, _zeros(pdf))


def _pbr_p_specular(metalness):
    # specularWeight = 1, diffuseWeight = 1 - metalness
    return 1.0 / (2.0 - metalness)


def _pbr_sample(mat: MaterialLanes, w_o, square):
    p_spec = _pbr_p_specular(mat.metalness)
    take_spec, rx = coin_flip_remap(p_spec, square[..., 0])
    sq = torch.stack([rx, square[..., 1]], dim=-1)

    spec_dir, spec_pdf = _micro_sample(mat.alpha, w_o, sq)
    spec_other = _lambert_pdf(spec_dir, w_o)
    pdf_if_spec = spec_other + (spec_pdf - spec_other) * p_spec

    diff_dir, diff_pdf = _lambert_sample(w_o, sq)
    diff_other = _micro_pdf(mat.alpha, diff_dir, w_o)
    pdf_if_diff = diff_pdf + (diff_other - diff_pdf) * p_spec

    w_i = torch.where(take_spec[..., None], spec_dir, diff_dir)
    return w_i, torch.where(take_spec, pdf_if_spec, pdf_if_diff)


# --- PerfectMirror (material.hlsl:313-332) ---

def _mirror_sample(w_o):
    w_i = torch.stack([-w_o[..., 0], -w_o[..., 1], w_o[..., 2]], dim=-1)
    return w_i, torch.ones(w_o.shape[:-1], dtype=w_o.dtype, device=w_o.device)


def _mirror_eval(w_i):
    mag = 1.0 / torch.clamp_min(torch.abs(cos_theta(w_i)), 1e-12)
    return mag[..., None] * torch.ones(3, dtype=w_i.dtype, device=w_i.device)


# --- Glass (material.hlsl:334-393) ---

def _refract_dir(wi, n, eta):
    """(direction, valid); material.hlsl:334-343."""
    cos_i = dot(n, wi, keepdims=False)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = M.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    d = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return torch.where(valid[..., None], d, _zeros(d)), valid


def _glass_sample(mat: MaterialLanes, w_o, square):
    f = fresnel_dielectric(cos_theta(w_o), AIR_IOR, mat.ior)
    reflect = square[..., 0] < f
    refl_dir = torch.stack([-w_o[..., 0], -w_o[..., 1], w_o[..., 2]], dim=-1)

    entering = cos_theta(w_o) > 0.0
    air = torch.full_like(mat.ior, AIR_IOR)
    eta_i = torch.where(entering, air, mat.ior)
    eta_t = torch.where(entering, mat.ior, air)
    nz = torch.where(entering, torch.ones_like(f), -torch.ones_like(f))
    n = torch.stack([_zeros(nz), _zeros(nz), nz], dim=-1)  # faceForward(+z)
    refr_dir, refr_valid = _refract_dir(w_o, n, eta_i / eta_t)
    refr_pdf = torch.where(refr_valid, 1.0 - f, _zeros(f))

    w_i = torch.where(reflect[..., None], refl_dir, refr_dir)
    return w_i, torch.where(reflect, f, refr_pdf)


def _glass_eval(mat: MaterialLanes, w_i, w_o):
    f = fresnel_dielectric(cos_theta(w_o), AIR_IOR, mat.ior)
    mag = torch.where(same_hemisphere(w_i, w_o), f, 1.0 - f)
    mag = mag / torch.clamp_min(torch.abs(cos_theta(w_i)), 1e-12)
    return mag[..., None] * torch.ones(3, dtype=w_i.dtype, device=w_i.device)


# --- dispatch (material.hlsl:395-487) ---

def is_delta(mat_type):
    return (mat_type == MIRROR) | (mat_type == GLASS)


def _select(mat_type, glass, lambert, mirror, pbr):
    expand = glass.ndim > mat_type.ndim

    def cond(c):
        return c[..., None] if expand else c

    out = torch.where(cond(mat_type == GLASS), glass, lambert)
    out = torch.where(cond(mat_type == MIRROR), mirror, out)
    return torch.where(cond(mat_type == STANDARD_PBR), pbr, out)


def _pbr_eval_terms(mat, w_i, w_o, h, d_ggx, same_h):
    cos_ih = dot(w_i, h, keepdims=False)
    f_dielectric = fresnel_dielectric(cos_ih, AIR_IOR, mat.ior)[..., None]
    f_metallic = schlick_color(cos_ih, mat.color)
    fr = f_dielectric + (f_metallic - f_dielectric) * mat.metalness[..., None]
    g = ggx_g(mat.alpha, w_i, w_o)
    denom = 4.0 * torch.abs(cos_theta(w_i)) * torch.abs(cos_theta(w_o))
    spec = fr * (g * d_ggx / torch.clamp_min(denom, 1e-12))[..., None]
    spec = torch.where(same_h[..., None], spec, _zeros(spec))
    return spec + (1.0 - mat.metalness[..., None]) * _lambert_eval(mat.color)


def eval_bsdf(mat: MaterialLanes, w_i, w_o):
    """BSDF value; for delta materials magnitude / |cos w_i| (the
    reference's convention, so eval * |cos| / pdf is the throughput)."""
    h = safe_normalize(w_i + w_o)
    pbr = _pbr_eval_terms(mat, w_i, w_o, h, ggx_d(mat.alpha, h),
                          same_hemisphere(w_o, w_i))
    return _select(mat.type, _glass_eval(mat, w_i, w_o),
                   _lambert_eval(mat.color).expand_as(pbr), _mirror_eval(w_i),
                   pbr)


def eval_pdf_bsdf(mat: MaterialLanes, w_i, w_o):
    """Fused eval_bsdf + pdf_bsdf sharing the half vector, D term and
    hemisphere tests (the NEE weighting needs both). Returns
    (f [N,3], pdf [N])."""
    h = safe_normalize(w_i + w_o)
    same_h = same_hemisphere(w_o, w_i)
    d_ggx = ggx_d(mat.alpha, h)
    lam_abs = torch.abs(cos_theta(w_i)) / PI
    lam_pdf = torch.where(same_h, lam_abs, _zeros(lam_abs))
    pbr_f = _pbr_eval_terms(mat, w_i, w_o, h, d_ggx, same_h)

    mic = d_ggx * torch.abs(cos_theta(h)) / torch.clamp_min(
        4.0 * dot(w_o, h, keepdims=False), 1e-12)
    mic = torch.where(same_h, mic, _zeros(mic))
    pbr_pdf = lam_pdf + (mic - lam_pdf) * _pbr_p_specular(mat.metalness)

    zeros = _zeros(lam_pdf)
    f = _select(mat.type, _glass_eval(mat, w_i, w_o),
                _lambert_eval(mat.color).expand_as(pbr_f), _mirror_eval(w_i),
                pbr_f)
    return f, _select(mat.type, zeros, lam_pdf, zeros, pbr_pdf)


def sample_bsdf(mat: MaterialLanes, w_o, square):
    """Draw a scattering direction. Returns (w_i [N,3], pdf [N]); pdf == 0
    marks an invalid sample."""
    g_dir, g_pdf = _glass_sample(mat, w_o, square)
    l_dir, l_pdf = _lambert_sample(w_o, square)
    m_dir, m_pdf = _mirror_sample(w_o)
    p_dir, p_pdf = _pbr_sample(mat, w_o, square)
    return (_select(mat.type, g_dir, l_dir, m_dir, p_dir),
            _select(mat.type, g_pdf, l_pdf, m_pdf, p_pdf))
