"""Thin-lens camera ray generation (port of moonshine_tpu/render/camera.py;
parity: camera.hlsl:6-43 and the Gaussian jitter of main.hlsl:54-59)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.mappings import square_to_gaussian, square_to_uniform_disk_concentric
from ..core import mathutil as M
from ..core.mathutil import cross, normalize
from ..scene.types import Lens


class LensArrays(NamedTuple):
    """Lens parameters as float32 tensors on the render device."""

    origin: torch.Tensor  # [3]
    forward: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    vfov: torch.Tensor  # scalar
    aperture: torch.Tensor  # scalar
    focus_distance: torch.Tensor  # scalar

    @staticmethod
    def from_lens(lens: Lens, device="cuda") -> "LensArrays":
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        return LensArrays(
            origin=f32(lens.origin), forward=f32(lens.forward),
            up=f32(lens.up), vfov=f32(lens.vfov), aperture=f32(lens.aperture),
            focus_distance=f32(lens.focus_distance),
        )


def pixel_uv(px, py, width, height, jitter_rand2, flip_image=True):
    """Jittered uv in [0,1]^2 for integer pixel coords; flip_image matches
    the reference's default y flip."""
    center = 0.5 + 0.5 * square_to_gaussian(jitter_rand2)
    u = (px.to(torch.float32) + center[..., 0]) / width
    v = (py.to(torch.float32) + center[..., 1]) / height
    if flip_image:
        v = 1.0 - v
    return torch.stack([u, v], dim=-1)


def generate_rays(lens: LensArrays, width, height, uv, aperture_rand2):
    """uv [N,2] -> (origin [N,3], direction [N,3])."""
    w = -lens.forward
    u_axis = normalize(cross(lens.up, w))
    v_axis = cross(w, u_axis)

    aspect = float(np.float32(width) / np.float32(height))
    h = M.tan(lens.vfov / 2.0)
    viewport_h = 2.0 * h * lens.focus_distance
    viewport_w = aspect * viewport_h

    horizontal = u_axis * viewport_w
    vertical = v_axis * viewport_h
    lower_left = (lens.origin - horizontal / 2.0 - vertical / 2.0
                  - w * lens.focus_distance)

    rd = lens.aperture * square_to_uniform_disk_concentric(aperture_rand2) / 2.0
    defocus = rd[..., 0:1] * u_axis + rd[..., 1:2] * v_axis

    origin = lens.origin + defocus
    target = lower_left + uv[..., 0:1] * horizontal + uv[..., 1:2] * vertical
    return origin, normalize(target - defocus - lens.origin)

