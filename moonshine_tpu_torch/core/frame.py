"""Orthonormal shading frames (port of moonshine_tpu/core/frame.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import mathutil as M
from .mathutil import coordinate_system, cross, dot, safe_normalize


class Frame(NamedTuple):
    n: torch.Tensor  # normal
    s: torch.Tensor  # tangent
    t: torch.Tensor  # bitangent

    @staticmethod
    def from_normal(n):
        """Frame with arbitrary tangents around unit n
        (reflection_frame.hlsl:9-13)."""
        t, s = coordinate_system(n)
        return Frame(n=n, s=s, t=t)

    def reorthogonalize(self) -> "Frame":
        """Gram-Schmidt s against n, rebuild t
        (reflection_frame.hlsl:31-35)."""
        s = safe_normalize(self.s - self.n * dot(self.n, self.s))
        t = safe_normalize(cross(self.n, s))
        return Frame(n=self.n, s=s, t=t)

    def world_to_frame(self, v):
        return torch.stack(
            [
                dot(self.s, v, keepdims=False),
                dot(self.t, v, keepdims=False),
                dot(self.n, v, keepdims=False),
            ],
            dim=-1,
        )

    def frame_to_world(self, v):
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


def cos_theta(v):
    return v[..., 2]


def cos2_theta(v):
    return v[..., 2] * v[..., 2]


def sin2_theta(v):
    return torch.clamp_min(1.0 - cos2_theta(v), 0.0)


def sin_theta(v):
    return M.sqrt(sin2_theta(v))


def tan2_theta(v):
    return sin2_theta(v) / torch.clamp_min(cos2_theta(v), 1e-30)


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0
