"""Direct-light integrator: the primary hit, its emission and NEE with MIS
(port of moonshine_tpu/integrator/direct.py; parity:
DirectLightIntegrator, integrator.hlsl:188-249), on the path tracer's
traversal dispatch and surface decode, so its closest and any hits run
the same kernels as a path's bounce, and its miss, surface decode and
env draw the shading kernels of integrator/shade.py."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import cos_theta
from ..core.mathutil import INF_T, face_forward, norm, offset_along_normal
from ..lights.mesh_lights import sample_mesh_lights
from . import shade
from .path import _any_hit, _closest
from .shade import _emissive_at, _masked, power_heuristic


@dataclass(frozen=True)
class DirectConfig:
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1


def trace_direct(scene, ray_o, ray_d, rng_state, cfg: DirectConfig):
    """One primary hit + emission + MIS-weighted NEE per ray
    (integrator.hlsl:199-247). Returns (radiance [N,3], rng_state,
    rays_traced int64 scalar: the primary rays plus the live shadow
    rays)."""
    n = ray_o.shape[0]
    rng = rng_state
    rays = torch.tensor(n, dtype=torch.int64, device=ray_o.device)

    with record_function("traversal"):
        hit = _closest(scene, ray_o, ray_d, INF_T, None)
    dev, f32 = ray_o.device, torch.float32
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
        surf = shade.surface(scene, 0, None, hit, None, ray_d, active, None,
                             radiance, None, None, shade.DIRECT)
    position, tri_n, frame, w_o_ss, mat, radiance = surf[:6]

    def nee(radiance, rng, rays, sampler, n_samples):
        for _ in range(n_samples):
            with record_function("nee_draw"):
                rng, r2 = R.next_float2(rng)
                l_dir, l_rad, l_pdf, tmax = sampler(r2)
                shadow_o = offset_along_normal(position,
                                               face_forward(tri_n, l_dir))
                lane = active & (l_pdf > 0.0)
            with record_function("any_hit"):
                occluded = _any_hit(scene, shadow_o, l_dir, tmax, lane)
            radiance = weight(radiance, lane, occluded, l_dir, l_rad, l_pdf,
                              n_samples)
            rays = rays + lane.sum()
        return radiance, rng, rays

    def weight(radiance, lane, occluded, l_dir, l_rad, l_pdf, n_samples):
        with record_function("scatter"):  # the light weighting, a bounce's
            l_pdf = torch.where(occluded, 0.0, l_pdf)
            w_i_ss = frame.world_to_frame(l_dir)
            scatter_pdf = B.pdf_bsdf(mat, w_i_ss, w_o_ss)
            brdf = B.eval_bsdf(mat, w_i_ss, w_o_ss)
            mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
            contrib = l_rad * brdf * (
                torch.abs(cos_theta(w_i_ss)) * mis
                / torch.clamp_min(l_pdf, 1e-30))[..., None]
            ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
            return radiance + _masked(ok, contrib / n_samples)

    if cfg.env_samples_per_bounce > 0:
        def env_sampler(r2):
            l_dir, l_rad, l_pdf = shade.env_draw(scene.env, r2)
            return l_dir, l_rad, l_pdf, torch.full_like(l_pdf, INF_T)

        radiance, rng, rays = nee(radiance, rng, rays, env_sampler,
                                  cfg.env_samples_per_bounce)

    if cfg.mesh_samples_per_bounce > 0:
        def mesh_sampler(r2):
            l_dir, l_pos, l_n, _tri, l_bary, l_pdf, l_row = (
                sample_mesh_lights(scene, position, r2))
            l_rad = _emissive_at(scene, l_row, l_bary)
            seg = offset_along_normal(l_pos, l_n) - position
            return l_dir, l_rad, l_pdf, norm(seg)[..., 0]

        radiance, rng, rays = nee(radiance, rng, rays, mesh_sampler,
                                  cfg.mesh_samples_per_bounce)

    return radiance, rng, rays
