"""Direct-light integrator: the primary hit, its emission and NEE with MIS
(port of moonshine_tpu/integrator/direct.py; parity:
DirectLightIntegrator, integrator.hlsl:188-249), on the path tracer's
traversal dispatch, so its closest and any hits run the same kernels as
a path's bounce, and on the shading kernels of integrator/shade.py: the
env miss, the surface kernel's direct form (the decode, the emission and
every light sample with its shadow ray) and the scatter kernel's
weight-only form."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..core.mathutil import INF_T
from . import shade
from .path import _any_hit, _closest


@dataclass(frozen=True)
class DirectConfig:
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1


def trace_direct(scene, ray_o, ray_d, rng_state, cfg: DirectConfig):
    """One primary hit + emission + MIS-weighted NEE per ray
    (integrator.hlsl:199-247). Returns (radiance [N,3], rng_state,
    rays_traced int64 scalar: the primary rays plus the live shadow
    rays). On the card: one closest-hit dispatch, one env miss, one
    surface launch that draws every light sample (env ones first, one
    next_float2 each, every lane's PCG state advanced), one any-hit
    dispatch over the [S * N] shadow batch and one weighting launch."""
    n = ray_o.shape[0]
    dev, f32 = ray_o.device, torch.float32
    rays = torch.full((), n, dtype=torch.int64, device=dev)

    with record_function("traversal"):
        hit = _closest(scene, ray_o, ray_d, INF_T, None)
    with record_function("env"):
        # the env miss as a path's first segment without env samples:
        # every lane live, unit throughput, radiance from 0; the lanes
        # that missed leave the mask, which is then the hits'
        radiance, active = shade.env_miss(
            scene.env, 0, 0, ray_d,
            torch.ones(n, dtype=torch.bool, device=dev), hit.tri,
            torch.ones((n, 3), dtype=f32, device=dev),
            torch.zeros((n, 3), dtype=f32, device=dev),
            torch.ones(n, dtype=f32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))
    with record_function("surface"):
        surf = shade.surface(
            scene, cfg.mesh_samples_per_bounce, 0, hit, None, ray_d, active,
            None, radiance, None, None, shade.DIRECT,
            shade.DrawIn(scene.env, cfg.env_samples_per_bounce, 0, False,
                         rng_state.clone()), rays=rays)
    if surf.lights is None:  # no light sample
        return surf.radiance, surf.rng, rays
    with record_function("any_hit"):
        occluded = _any_hit(scene, *surf.shadow)
    with record_function("scatter"):  # the light weighting, a bounce's
        lights = surf.lights._replace(
            occluded=occluded.view(surf.lights.lane.shape))
        radiance = shade.weigh(surf, surf.radiance, active, lights)
    return radiance, surf.rng, rays
