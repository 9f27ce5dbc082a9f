"""Frozen copy of moonshine_tpu_torch/lights/envmap.py at commit 747dbd6,
for the plain reference (portbench/reference), less the functions the
reference does not call. Its docstring:

Environment-map lighting with the equal-area parameterisation (port of
moonshine_tpu/lights/envmap.py; parity: light.hlsl:34-103).

The host resamples an equirect image to an S x S equal-area square (3x3
supersampled) and builds a luminance alias table; `sample_envmap` draws a
texel in O(1), `miss_radiance_and_pdf` returns the bilinear radiance and
point-sampled texel pdf of a direction. Radiance and luminance share one
[S*S, 4] row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import alias_table
from .mappings import (
    square_to_equal_area_sphere,
    square_to_equal_area_sphere_inverse,
)
from .mathutil import PI


class EnvMap(NamedTuple):
    rgbl: torch.Tensor  # [S*S, 4] radiance + luminance
    integral: float  # sum of texel luminances (float32 value)
    select: torch.Tensor  # [S*S] f32 alias keep probability
    alias: torch.Tensor  # [S*S] i64 alias fallback texel
    size: int  # S


def finish_envmap(rgb: np.ndarray) -> dict:
    """Host arrays of an env map from its [S, S, 3] equal-area image."""
    lum = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
           + 0.0722 * rgb[..., 2]).astype(np.float32)
    table = alias_table.build(lum.reshape(-1))
    rgbl = np.concatenate([rgb, lum[..., None]], axis=-1).reshape(-1, 4)
    return dict(rgbl=rgbl.astype(np.float32), select=table.select,
                alias=table.alias,
                integral=float(np.float32(table.weight_sum)))


def envmap_from_arrays(arrays: dict, device) -> EnvMap:
    rgbl = torch.tensor(np.asarray(arrays["rgbl"], np.float32),
                        device=device)
    return EnvMap(
        rgbl=rgbl,
        integral=float(arrays["integral"]),
        select=torch.tensor(np.asarray(arrays["select"], np.float32),
                            device=device),
        alias=torch.tensor(np.asarray(arrays["alias"], np.int64),
                           device=device),
        size=int(round(rgbl.shape[0] ** 0.5)),
    )


def _uniform_pdf(n, like):
    return torch.full((n,), 1.0 / (4.0 * PI), dtype=torch.float32,
                      device=like.device)


def sample_envmap(env: EnvMap, rand2: torch.Tensor):
    """Luminance-proportional texel draw. rand2 [N, 2] ->
    (dir_ws [N,3], radiance [N,3], pdf [N]); occlusion is the caller's."""
    S = env.size
    n = rand2.shape[0]
    if S == 1:
        # constant env: the draw is the identity and the pdf uniform
        return (square_to_equal_area_sphere(rand2),
                env.rgbl[0, :3].expand(n, 3), _uniform_pdf(n, rand2))
    texel, ru = alias_table.sample(env.select, env.alias, S * S,
                                   rand2[..., 0])
    ix = texel // S
    iy = texel - ix * S
    row = env.rgbl[texel]
    discrete_pdf = row[..., 3] * (S * S) / max(env.integral, 1e-30)
    uv = (torch.stack([ix, iy], dim=-1).to(torch.float32)
          + torch.stack([ru, rand2[..., 1]], dim=-1)) / S
    return (square_to_equal_area_sphere(uv), row[..., :3],
            discrete_pdf / (4.0 * PI))


def _texel_pdf(env, row):
    S = env.size
    return row[..., 3] * (S * S) / max(env.integral, 1e-30) / (4.0 * PI)


def _bilinear(env: EnvMap, uv):
    """Four-tap bilinear fetch at equal-area square coords uv [N, 2]."""
    S = env.size
    x = uv[..., 0] * S - 0.5
    y = uv[..., 1] * S - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = torch.clamp(x0.to(torch.int64), 0, S - 1)
    xi1 = torch.clamp(xi0 + 1, 0, S - 1)
    yi0 = torch.clamp(y0.to(torch.int64), 0, S - 1)
    yi1 = torch.clamp(yi0 + 1, 0, S - 1)
    taps = (
        (xi0 * S + yi0, (1 - fx) * (1 - fy)),
        (xi1 * S + yi0, fx * (1 - fy)),
        (xi0 * S + yi1, (1 - fx) * fy),
        (xi1 * S + yi1, fx * fy),
    )
    out = 0.0
    for ids, wk in taps:
        out = out + wk[:, None] * env.rgbl[ids]
    return out[..., :3]


def miss_radiance_and_pdf(env: EnvMap, dir_ws: torch.Tensor):
    """Fused miss query: (bilinear radiance, texel radiance, texel pdf)
    from one equal-area inverse."""
    S = env.size
    n = dir_ws.shape[0]
    if S == 1:
        rad = env.rgbl[0, :3].expand(n, 3)
        return rad, rad, _uniform_pdf(n, dir_ws)
    uv = square_to_equal_area_sphere_inverse(dir_ws)
    idx = torch.clamp((uv * S).to(torch.int64), 0, S - 1)
    texel = env.rgbl[idx[..., 0] * S + idx[..., 1]]
    return _bilinear(env, uv), texel[..., :3], _texel_pdf(env, texel)

