"""Warps between the unit square and sampling domains (port of
moonshine_tpu/core/mappings.py, parity: mappings.hlsl:5-126)."""

from __future__ import annotations

import torch

from .mathutil import PI


def square_to_triangle(square):
    """Uniform barycentric (a, b) on the standard triangle."""
    s = torch.sqrt(torch.clamp_min(1.0 - square[..., 0], 0.0))
    a = 1.0 - s
    b = square[..., 1] * s
    return torch.stack([a, b], dim=-1)


def square_to_gaussian(square):
    """Box-Muller standard 2D Gaussian."""
    u1 = 1.0 - square[..., 0]
    u2 = square[..., 1]
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-38)))
    theta = 2.0 * PI * u2
    return r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                      dim=-1)


def square_to_uniform_disk_concentric(square):
    """Shirley-Chiu concentric disk warp."""
    u = 2.0 * square - 1.0
    ux, uy = u[..., 0], u[..., 1]
    x_major = torch.abs(ux) > torch.abs(uy)
    r = torch.where(x_major, ux, uy)

    def safe(num, den):
        return num / torch.where(den == 0.0, torch.ones_like(den), den)

    theta = torch.where(
        x_major,
        (PI / 4.0) * safe(uy, ux),
        (PI / 2.0) - (PI / 4.0) * safe(ux, uy),
    )
    at_origin = (ux == 0.0) & (uy == 0.0)
    r = torch.where(at_origin, torch.zeros_like(r), r)
    return r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                      dim=-1)


def square_to_cosine_hemisphere(square):
    """Cosine-weighted upper hemisphere via the disk warp."""
    d = square_to_uniform_disk_concentric(square)
    z = torch.sqrt(torch.clamp_min(1.0 - torch.sum(d * d, dim=-1), 0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def spherical_to_cartesian(sin_theta, cos_theta, phi):
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )


def cartesian_to_spherical(v):
    """(phi in [0, 2pi], theta in [0, pi]) of a unit vector."""
    p = torch.atan2(v[..., 1], v[..., 0])
    phi = torch.where(p < 0.0, p + 2.0 * PI, p)
    theta = torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))
    return torch.stack([phi, theta], dim=-1)


def square_to_equal_area_sphere(square):
    """PBRTv4 equal-area square -> sphere map."""
    uv = 2.0 * square - 1.0
    uvp = torch.abs(uv)
    signed_distance = 1.0 - (uvp[..., 0] + uvp[..., 1])
    d = torch.abs(signed_distance)
    r = 1.0 - d
    r_zero = r == 0.0
    phi = torch.where(
        r_zero,
        torch.ones_like(r),
        (uvp[..., 1] - uvp[..., 0]) / torch.where(r_zero, torch.ones_like(r), r)
        + 1.0,
    ) * (PI / 4.0)
    z_mag = 1.0 - r * r
    planar = r * torch.sqrt(torch.clamp_min(2.0 - r * r, 0.0))
    signs = torch.sign(
        torch.stack([uv[..., 0], uv[..., 1], signed_distance], dim=-1)
    )
    body = torch.stack(
        [torch.cos(phi) * planar, torch.sin(phi) * planar, z_mag], dim=-1
    )
    return signs * body


def square_to_equal_area_sphere_inverse(dir):
    """Inverse equal-area map: unit direction -> [0, 1]^2."""
    xyz = torch.abs(dir)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(torch.clamp_min(1.0 - z, 0.0))
    both_zero = (x == 0.0) & (y == 0.0)
    phi = torch.where(
        both_zero,
        torch.zeros_like(x),
        torch.atan2(torch.minimum(x, y),
                    torch.clamp_min(torch.maximum(x, y), 1e-38))
        * (2.0 / PI),
    )
    phi = torch.where(x < y, 1.0 - phi, phi)
    u = r - phi * r
    v = phi * r
    neg = dir[..., 2] < 0.0
    u, v = torch.where(neg, 1.0 - v, u), torch.where(neg, 1.0 - u, v)
    u = u * torch.sign(dir[..., 0])
    v = v * torch.sign(dir[..., 1])
    return torch.stack([(u + 1.0) / 2.0, (v + 1.0) / 2.0], dim=-1)


def coin_flip_remap(p, rand):
    """Bernoulli(p) decision that recycles the random number
    (mappings.hlsl:103-111). Returns (took_true, remapped_rand)."""
    take = rand < p
    denom_t = torch.where(p == 0.0, torch.ones_like(p), p)
    denom_f = torch.where(p == 1.0, torch.ones_like(p), 1.0 - p)
    remapped = torch.where(take, rand / denom_t, (rand - p) / denom_f)
    return take, remapped
