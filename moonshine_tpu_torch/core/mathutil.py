"""Vector math helpers (port of moonshine_tpu/core/mathutil.py).

Batched tensors whose trailing axis is the vector axis."""

from __future__ import annotations

import math

import torch

PI = 3.14159265
# huge-but-finite tmax so t-comparisons never see inf (math.hlsl:5)
INF_T = 1.0e12
AIR_IOR = 1.000277


# ---- float32 functions whose value does not depend on the host
#
# torch's CPU kernels for float32 sqrt, sin, cos, log and tan call MKL's
# vector math library, whose results differ in the last bit from one
# processor to another (on some, one float32 square root in six is an ulp
# high), and atan2 and pow take the vector code of the build's CPU
# capability. On a CPU tensor these helpers compute in float64 and round
# once to float32: the correctly rounded value, the same on every host
# (sqrt exactly so, by a test against the neighbouring midpoints; the
# others but where the exact value lies within a float64 ulp of a float32
# rounding boundary). On a CUDA tensor each is torch's float32 op, the one
# the kernels of csrc/shade.cu reproduce.

def _host_f32(x) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.float32


def sqrt(x):
    if not _host_f32(x):
        return torch.sqrt(x)
    xd = x.double()
    s = torch.sqrt(xd).float()  # within an ulp of the correctly rounded root
    sd = s.double()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    dn = torch.nextafter(s, torch.zeros_like(s))
    # the midpoints to the neighbours and their squares are exact in float64
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    fixed = torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, s))
    return torch.where((s > 0.0) & torch.isfinite(s), fixed, s)


def _via_f64(fn):
    def f(x, *args):
        if not _host_f32(x):
            return fn(x, *args)
        return fn(x.double(), *(a.double() if torch.is_tensor(a) else a
                                for a in args)).float()
    f.__name__ = fn.__name__
    return f


sin = _via_f64(torch.sin)
cos = _via_f64(torch.cos)
log = _via_f64(torch.log)
tan = _via_f64(torch.tan)
acos = _via_f64(torch.acos)
atan2 = _via_f64(torch.atan2)
pow = _via_f64(torch.pow)  # noqa: A001 (x ** e with a Python exponent)


def dot(a, b, keepdims: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def norm(v):
    return sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def normalize(v):
    return v / norm(v)


def safe_normalize(v, eps=1e-20):
    return v / torch.clamp_min(norm(v), eps)


def cross(a, b):
    """On the card torch.linalg.cross (each component one fma, which the
    kernels reproduce); on the CPU each product rounded, since the CPU
    kernel contracts to an fma or not with the build's CPU capability."""
    if a.device.type != "cpu":
        return torch.linalg.cross(a, b, dim=-1)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


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


def reflect(v, n):
    """Mirror v about normal n (both unit, pointing away from surface)."""
    return 2.0 * dot(v, n) * n - v


def transform_point(mat3x4, p):
    """Apply a [..., 3, 4] affine transform to [..., 3] points."""
    return (torch.einsum("...ij,...j->...i", mat3x4[..., :, :3], p)
            + mat3x4[..., :, 3])


def transform_dir(mat3x4, d):
    """Apply the linear part of a [..., 3, 4] transform to [..., 3]
    vectors."""
    return torch.einsum("...ij,...j->...i", mat3x4[..., :, :3], d)
