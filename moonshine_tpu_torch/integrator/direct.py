"""Direct-light integrator: the primary hit, its emission and NEE with MIS
(port of moonshine_tpu/integrator/direct.py; parity:
DirectLightIntegrator, integrator.hlsl:188-249), on the path tracer's
traversal dispatch and surface decode, so its closest and any hits run
the same kernels as a path's bounce."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import Frame, cos_theta
from ..core.mathutil import INF_T, dot, face_forward, norm, offset_along_normal
from ..lights.envmap import envmap_incoming_radiance, sample_envmap
from ..lights.mesh_lights import sample_mesh_lights
from .path import (
    _any_hit,
    _closest,
    _decode_hit,
    _decode_material,
    _emissive_at,
    _masked,
    _texture_frame,
    power_heuristic,
)


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

    hit = _closest(scene, ray_o, ray_d, INF_T, None)
    active = hit.is_hit
    radiance = _masked(~active, envmap_incoming_radiance(scene.env, ray_d))

    tri = torch.clamp(hit.tri.to(torch.int64), 0, scene.num_tris - 1)
    position, uv, tri_frame, vtx_frame, mat_row, _ = _decode_hit(
        scene, tri, hit.u, hit.v)
    mat, emissive, normal_rg = _decode_material(scene, mat_row, uv)
    tex_frame = _texture_frame(normal_rg, vtx_frame)
    w_o_ws = -ray_d
    tex_ok = (dot(w_o_ws, tex_frame.n, keepdims=False) > 0.0)[..., None]
    vtx_ok = (dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0)[..., None]

    def pick(a, b, c):
        return torch.where(tex_ok, a, torch.where(vtx_ok, b, c))

    frame = Frame(n=pick(tex_frame.n, vtx_frame.n, tri_frame.n),
                  s=pick(tex_frame.s, vtx_frame.s, tri_frame.s),
                  t=pick(tex_frame.t, vtx_frame.t, tri_frame.t))
    w_o_ss = frame.world_to_frame(w_o_ws)
    radiance = radiance + _masked(active, emissive)

    def nee(radiance, rng, rays, sampler, n_samples):
        for _ in range(n_samples):
            rng, r2 = R.next_float2(rng)
            l_dir, l_rad, l_pdf, tmax = sampler(r2)
            shadow_o = offset_along_normal(position,
                                           face_forward(tri_frame.n, l_dir))
            lane = active & (l_pdf > 0.0)
            occluded = _any_hit(scene, shadow_o, l_dir, tmax, lane)
            rays = rays + lane.sum()
            l_pdf = torch.where(occluded, 0.0, l_pdf)
            w_i_ss = frame.world_to_frame(l_dir)
            scatter_pdf = B.pdf_bsdf(mat, w_i_ss, w_o_ss)
            brdf = B.eval_bsdf(mat, w_i_ss, w_o_ss)
            mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
            contrib = l_rad * brdf * (
                torch.abs(cos_theta(w_i_ss)) * mis
                / torch.clamp_min(l_pdf, 1e-30))[..., None]
            ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
            radiance = radiance + _masked(ok, contrib / n_samples)
        return radiance, rng, rays

    if cfg.env_samples_per_bounce > 0:
        def env_sampler(r2):
            l_dir, l_rad, l_pdf = sample_envmap(scene.env, r2)
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
