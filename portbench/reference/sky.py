"""The sky's equal-area image on any torch device, equal bit for bit to
the program's host build (moonshine_tpu_torch/lights/envmap.py
`build_envmap` at commit 747dbd6, which runs on the host's CPU and takes
some seconds for a 2048x1024 sky): the same 3x3 supersampled resample,
op for op in the types the host build computes in. Its torch steps are
float32 with the transcendental functions taken in float64 and rounded
once and a correctly rounded square root (mathutil.py's host
semantics); its numpy steps promote as numpy does: the bilinear weights
and taps in float64 (float32 less int64), each subsample added to the
float32 sum in float64 and rounded back. IEEE float32 and float64
arithmetic and square roots round the same on the card; a float64 sine,
cosine, arc tangent or arc cosine there may differ from the host's in
its last bit, which changes the float32 it rounds to only within 2^-28
of a rounding boundary, and then a texel by an ulp. Those functions see
only the subsample grid, which is the same for every sky of a size, so
the card's test (tests/test_portbench_sky.py) settles them for the
cells' size.
"""
from __future__ import annotations

import numpy as np
import torch

from . import mathutil as M
from .envmap import finish_envmap
from .mathutil import PI


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _f64(fn):
    def f(*args):
        return fn(*(a.double() for a in args)).float()
    return f


_cos, _sin = _f64(torch.cos), _f64(torch.sin)
_atan2, _acos = _f64(torch.atan2), _f64(torch.acos)


def _sqrt(x):
    """float32 square root, correctly rounded on every device."""
    return M.sqrt(x) if x.device.type == "cpu" else torch.sqrt(x)


def _div(x, c: float):
    """x / c correctly rounded in float32, as numpy divides (on the card
    torch divides by a Python number as a product with its reciprocal)."""
    return x / torch.full_like(x, np.float32(c))


def _square_to_sphere(square):
    """mappings.square_to_equal_area_sphere with the host's functions."""
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
    planar = r * _sqrt(torch.clamp_min(2.0 - r * r, 0.0))
    signs = torch.sign(
        torch.stack([uv[..., 0], uv[..., 1], signed_distance], dim=-1))
    body = torch.stack(
        [_cos(phi) * planar, _sin(phi) * planar, z_mag], dim=-1)
    return signs * body


def _to_spherical(v):
    """The program's core/mappings.py `cartesian_to_spherical` with the
    host's functions."""
    p = _atan2(v[..., 1], v[..., 0])
    phi = torch.where(p < 0.0, p + 2.0 * PI, p)
    theta = _acos(torch.clamp(v[..., 2], -1.0, 1.0))
    return phi, theta


def _bilinear_wrap_x(img, u, v):
    """The program's envmap.py `_bilinear_wrap_x` in numpy's types:
    float64 from the weights on."""
    H, W = img.shape[:2]
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x.double() - x0.double())[..., None]
    fy = (y.double() - y0.double())[..., None]
    x0w = torch.remainder(x0, W)
    x1w = torch.remainder(x0 + 1, W)
    y0c = torch.clamp(y0, 0, H - 1)
    y1c = torch.clamp(y0 + 1, 0, H - 1)
    tap = lambda yy, xx: img[yy, xx].double()
    top = tap(y0c, x0w) * (1 - fx) + tap(y0c, x1w) * fx
    bot = tap(y1c, x0w) * (1 - fx) + tap(y1c, x1w) * fx
    return top * (1 - fy) + bot * fy


def resample(equirect: np.ndarray, device) -> np.ndarray:
    """The [S, S, 3] float32 equal-area image of an equirect [H, W, 3]
    sky, S as the host build picks it (size None)."""
    img = torch.as_tensor(np.asarray(equirect, np.float32), device=device)
    H = img.shape[0]
    S = max(_next_pow2(int(min(1024, _next_pow2(max(H // 2, 1)) * 2))), 1)
    spd = 3
    acc = torch.zeros((S, S, 3), dtype=torch.float32, device=device)
    px = torch.arange(S, dtype=torch.float32, device=device)
    for i in range(spd):
        for j in range(spd):
            sub = _div(torch.tensor([1 + i, 1 + j], dtype=torch.float32,
                                    device=device), spd + 1)
            u = _div(px[:, None] + sub[0], S)
            v = _div(px[None, :] + sub[1], S)
            uv = torch.stack(torch.broadcast_tensors(u, v), dim=-1)
            phi, theta = _to_spherical(_square_to_sphere(uv))
            sample = _bilinear_wrap_x(img, _div(phi, 2 * PI), _div(theta, PI))
            acc = (acc.double() + sample).float()
    return _div(acc, spd * spd).cpu().numpy()


def build(equirect: np.ndarray, device) -> dict:
    """The host arrays of the sky's env map (the program's
    `build_envmap`'s), resampled on `device`."""
    return finish_envmap(resample(equirect, device))
