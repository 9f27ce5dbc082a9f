"""Vector math helpers (port of moonshine_tpu/core/mathutil.py).

Batched tensors whose trailing axis is the vector axis."""

from __future__ import annotations

import torch

PI = 3.14159265
# huge-but-finite tmax so t-comparisons never see inf (math.hlsl:5)
INF_T = 1.0e12
AIR_IOR = 1.000277


def dot(a, b, keepdims: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def normalize(v):
    return v / norm(v)


def safe_normalize(v, eps=1e-20):
    return v / torch.clamp_min(norm(v), eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def luminance(color):
    """Rec.709 luminance (math.hlsl:17-21)."""
    return (
        0.2126 * color[..., 0] + 0.7152 * color[..., 1] + 0.0722 * color[..., 2]
    )


def face_forward(n, d):
    """Flip n into the hemisphere of d (math.hlsl:23-25)."""
    return torch.where(dot(n, d) > 0.0, n, -n)


def offset_along_normal(p, n):
    """Integer-ULP self-intersection offset (Wächter & Binder 2019,
    math.hlsl:32-42)."""
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0

    of_i = (n * int_scale).to(torch.int32)
    p_int = p.contiguous().view(torch.int32)
    p_i = (p_int + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + n * float_scale, p_i)


def coordinate_system(v1):
    """(v2, v3) orthonormal to unit v1, branchless (math.hlsl:56-64)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = torch.rsqrt(torch.clamp_min(x * x + z * z, 1e-30))
    inv_b = torch.rsqrt(torch.clamp_min(y * y + z * z, 1e-30))
    zeros = torch.zeros_like(x)
    v2_a = torch.stack([-z * inv_a, zeros, x * inv_a], dim=-1)
    v2_b = torch.stack([zeros, z * inv_b, -y * inv_b], dim=-1)
    v2 = torch.where(use_x[..., None], v2_a, v2_b)
    return v2, cross(v2, v1)
