"""Unidirectional path tracer with NEE + MIS, batched over rays (port of
moonshine_tpu/integrator/path.py; parity: PathTracingIntegrator,
shaders/hrtsystem/integrator.hlsl:55-184).

Every lane advances in lockstep with masks: each bounce issues one batched
closest hit, decodes the surface, draws the NEE light samples, traces all
shadow rays as one batched any hit, weights them with the power
heuristic, and scatters. Emissive, termination, NEE and miss handling
follow the reference in order; per-lane RNG consumption is identical in
the unrolled and the looped form, so both give the same image.

Traversal always goes to the packet wrappers (accel/packet.py), which
launch the CUDA kernels for CUDA tensors. Not ported yet: the per-bounce
coherence resort and live-prefix shrinking (image-invisible speed
features) and the staged per-bounce dispatch API.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..accel import packet
from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import Frame, cos_theta
from ..core.mathutil import (
    INF_T,
    cross,
    dot,
    face_forward,
    luminance,
    norm,
    normalize,
    offset_along_normal,
    safe_normalize,
)
from ..lights.envmap import (
    envmap_incoming_radiance,
    miss_radiance_and_pdf,
    sample_envmap,
)
from ..lights.mesh_lights import area_to_solid_angle, sample_mesh_lights
from ..scene import textures as TX
from ..scene.textures import sample_material_block


@dataclass(frozen=True)
class PathConfig:
    """Render knobs (the reference's specialisation constants)."""

    max_bounces: int = 4
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1
    # None = auto: the unrolled form when max_bounces + 2 <= 10
    unroll: bool | None = None
    # accepted and ignored: the reference's per-bounce coherence resort
    # reorders lanes for traversal speed and leaves the image unchanged;
    # the port has no resort yet
    resort_bounces: bool | None = None


def power_heuristic(numf, f_pdf, numg, g_pdf):
    """Power heuristic, exponent 2 (integrator.hlsl:10-16)."""
    f = numf * f_pdf
    g = numg * g_pdf
    f2 = f * f
    return f2 / torch.clamp_min(f2 + g * g, 1e-30)


def _interp(bary_u, bary_v, corners):
    """Barycentric interpolation of [N,3,C] corner attributes."""
    b0 = (1.0 - bary_u - bary_v)[..., None]
    return (b0 * corners[:, 0] + bary_u[..., None] * corners[:, 1]
            + bary_v[..., None] * corners[:, 2])


def _tangent_bitangent(p0, p1, p2, t0, t1, t2):
    """UV-gradient tangent frame (world.hlsl:86-100)."""
    dt02 = t0 - t2
    dt12 = t1 - t2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = dt02[..., 0] * dt12[..., 1] - dt02[..., 1] * dt12[..., 0]
    bad = torch.abs(det) < 1e-12
    inv = 1.0 / torch.where(bad, 1e-12, det)
    tangent = safe_normalize(
        (dt12[..., 1:2] * dp02 - dt02[..., 1:2] * dp12) * inv[..., None])
    bitangent = safe_normalize(
        (-dt12[..., 0:1] * dp02 + dt02[..., 0:1] * dp12) * inv[..., None])
    # degenerate uvs: an arbitrary frame around the normal
    fallback = Frame.from_normal(safe_normalize(cross(p2 - p0, p1 - p0)))
    tangent = torch.where(bad[..., None], fallback.s, tangent)
    bitangent = torch.where(bad[..., None], fallback.t, bitangent)
    return tangent, bitangent


def _decode_hit(scene, tri, bary_u, bary_v):
    """Surface attributes at a hit (world.hlsl:107-177). Returns
    (position, uv, tri_frame, vtx_frame, mat_row, sampled)."""
    row = scene.tri_shade[tri]  # [N, 48]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    nrms = row[:, 9:18].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    sampled = row[:, 25] > 0.5

    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tangent, bitangent = _tangent_bitangent(p0, p1, p2, uvs[:, 0],
                                            uvs[:, 1], uvs[:, 2])
    tri_n = safe_normalize(cross(p0 - p2, p1 - p2))
    tri_frame = Frame(n=tri_n, s=tangent, t=bitangent).reorthogonalize()
    vtx_n = safe_normalize(_interp(bary_u, bary_v, nrms))
    vtx_frame = Frame(n=vtx_n, s=tri_frame.s, t=tri_frame.t).reorthogonalize()
    return position, uv, tri_frame, vtx_frame, row[:, 32:48], sampled


def _decode_hit_thin(scene, tri, bary_u, bary_v):
    """Last-segment decode: position, triangle normal, uv, material row
    and sampled flag only (the last segment only adds emission); values
    equal the full decode's."""
    row = scene.tri_shade[tri]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tri_n = safe_normalize(cross(p0 - p2, p1 - p2))
    return position, uv, tri_n, row[:, 32:48], row[:, 25] > 0.5


def _decode_emissive(scene, mat_row, uv):
    """Emitted radiance (getEmissive, material.hlsl:519-522)."""
    if scene.mat_atlas.emissive_constant:
        return mat_row[:, 7:10]
    block = sample_material_block(scene.mat_atlas.emissive,
                                  mat_row[:, 12:16], uv)
    return block[:, TX.EMISSIVE]


def _decode_material(scene, mat_row, uv):
    """(MaterialLanes, emissive, tangent-space normal rg); constant
    planes read straight from the packed material row."""
    if scene.mat_atlas.bsdf_constant:
        color = mat_row[:, 1:4]
        metalness = mat_row[:, 4]
        roughness = mat_row[:, 6]
        normal_rg = mat_row[:, 10:12]
    else:
        block = sample_material_block(scene.mat_atlas.bsdf,
                                      mat_row[:, 1:5], uv)
        color = block[:, TX.COLOR]
        metalness = block[:, TX.METALNESS]
        roughness = block[:, TX.ROUGHNESS]
        normal_rg = block[:, TX.NORMAL_RG]
    lanes = B.MaterialLanes(
        type=mat_row[:, 0].to(torch.int32),
        color=color,
        metalness=metalness,
        alpha=torch.clamp_min(roughness * roughness, 1e-3),
        ior=mat_row[:, 5],
    )
    return lanes, _decode_emissive(scene, mat_row, uv), normal_rg


def _texture_frame(normal_rg, vtx_frame):
    """Normal-mapped shading frame (material.hlsl:489-517)."""
    rg = normal_rg * 2.0 - 1.0
    z = torch.sqrt(torch.clamp(1.0 - torch.sum(rg * rg, dim=-1), 0.0, 1.0))
    n_ts = torch.cat([rg, z[..., None]], dim=-1)
    n_ws = normalize(vtx_frame.frame_to_world(n_ts))
    return Frame(n=n_ws, s=vtx_frame.s, t=vtx_frame.t).reorthogonalize()


def _emissive_at(scene, light_row, bary):
    """Emitted radiance at a light sample from its packed emitter row."""
    if scene.mat_atlas.emissive_constant:
        return light_row[:, 15:18]
    n = light_row.shape[0]
    uv = _interp(bary[..., 0], bary[..., 1], light_row[:, 9:15].reshape(n, 3, 2))
    block = sample_material_block(scene.mat_atlas.emissive,
                                  light_row[:, 18:22], uv)
    return block[:, TX.EMISSIVE]


def _masked(mask, value):
    """value where mask (broadcast over the trailing axis), else 0."""
    return torch.where(mask[..., None], value, torch.zeros_like(value))


def _bounce_body(scene, cfg: PathConfig, bounce: int, st: dict,
                 last: bool = False) -> dict:
    """One bounce over the whole lane batch. last=True marks the final
    segment of the unrolled form, where every lane dies after the
    emissive/miss accumulation, so NEE, roulette and scatter are skipped."""
    active = st["active"]
    o, d = st["o"], st["d"]
    throughput = st["throughput"]
    radiance = st["radiance"]
    last_pdf = st["last_pdf"]
    last_delta = st["last_delta"]
    rng = st["rng"]
    rays = st["rays"] + active.sum()

    hit = packet.closest_hit_packet(scene.wide, o, d, INF_T, active_in=active)
    is_hit = active & hit.is_hit
    miss = active & ~hit.is_hit

    # ---- miss: environment radiance (integrator.hlsl:166-180)
    env_plain = (last_delta | (bounce == 0)
                 | (cfg.env_samples_per_bounce == 0))
    if cfg.env_samples_per_bounce > 0:
        env_rad, rad_e, pdf_e = miss_radiance_and_pdf(scene.env, d)
        w = power_heuristic(1.0, last_pdf, cfg.env_samples_per_bounce, pdf_e)
        radiance = radiance + _masked(miss & ~env_plain & (pdf_e > 0.0),
                                      throughput * rad_e * w[..., None])
    else:
        env_rad = envmap_incoming_radiance(scene.env, d)
    radiance = radiance + _masked(miss & env_plain, throughput * env_rad)
    active = is_hit

    # ---- decode the surface (masked lanes read clamped junk rows)
    tri = torch.clamp(hit.tri.to(torch.int64), 0, scene.num_tris - 1)
    w_o_ws = -d
    if last:
        position, uv, tri_n, mat_row, tri_sampled = _decode_hit_thin(
            scene, tri, hit.u, hit.v)
        emissive = _decode_emissive(scene, mat_row, uv)
    else:
        position, uv, tri_frame, vtx_frame, mat_row, tri_sampled = (
            _decode_hit(scene, tri, hit.u, hit.v))
        mat, emissive, normal_rg = _decode_material(scene, mat_row, uv)
        tri_n = tri_frame.n

        # shading-normal selection chain (integrator.hlsl:93-104); with
        # flat normal maps the texture frame is the vertex frame
        frontfacing = dot(tri_frame.n, w_o_ws, keepdims=False) > 0.0
        sgn = torch.where(frontfacing, 1.0, -1.0)
        vtx_ok = (sgn * dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0)[
            ..., None]
        if scene.mat_atlas.normals_flat:
            def pick(a, b, c):
                return torch.where(vtx_ok, b, c)
            tex_frame = vtx_frame
        else:
            tex_frame = _texture_frame(normal_rg, vtx_frame)
            tex_ok = (sgn * dot(w_o_ws, tex_frame.n, keepdims=False)
                      > 0.0)[..., None]

            def pick(a, b, c):
                return torch.where(tex_ok, a, torch.where(vtx_ok, b, c))
        frame = Frame(n=pick(tex_frame.n, vtx_frame.n, tri_frame.n),
                      s=pick(tex_frame.s, vtx_frame.s, tri_frame.s),
                      t=pick(tex_frame.t, vtx_frame.t, tri_frame.t))
        w_o_ss = frame.world_to_frame(w_o_ws)

    # ---- emissive accumulation (integrator.hlsl:109-124)
    emit_plain = (~tri_sampled | last_delta | (bounce == 0)
                  | (cfg.mesh_samples_per_bounce == 0))
    emit_front = dot(w_o_ws, tri_n, keepdims=False) > 0.0
    radiance = radiance + _masked(active & emit_plain & emit_front,
                                  throughput * emissive)
    if cfg.mesh_samples_per_bounce > 0:
        light_pdf = area_to_solid_angle(position, o, d, tri_n) / max(
            scene.emitters.weight_sum, 1e-20)
        w = power_heuristic(1.0, last_pdf, cfg.mesh_samples_per_bounce,
                            light_pdf)
        radiance = radiance + _masked(active & ~emit_plain & (light_pdf > 0.0),
                                      throughput * emissive * w[..., None])

    if last:
        # the max-bounce cut kills every lane here
        return dict(st, active=torch.zeros_like(active), radiance=radiance,
                    rays=rays)

    # ---- termination (integrator.hlsl:126-135)
    active = active & (bounce < cfg.max_bounces + 1)
    rng, rr_rand = R.next_float(rng)
    if bounce > 3:
        p_survive = torch.clamp_max(luminance(throughput), 0.95)
        active = active & ~(rr_rand > p_survive)
        throughput = torch.where(
            active[..., None],
            throughput / torch.clamp_min(p_survive, 1e-20)[..., None],
            throughput)

    is_delta = B.is_delta(mat.type)
    nee_active = active & ~is_delta

    # ---- NEE (integrator.hlsl:139-151): draw every light sample, trace
    # all shadow rays as one any-hit batch, then weight
    shadow = []  # (origin, dir, tmax, lane, kind, l_dir, l_rad, l_pdf)
    for _ in range(cfg.env_samples_per_bounce):
        rng, r2 = R.next_float2(rng)
        l_dir, l_rad, l_pdf = sample_envmap(scene.env, r2)
        shadow_o = offset_along_normal(position,
                                       face_forward(tri_frame.n, l_dir))
        shadow.append((shadow_o, l_dir, torch.full_like(l_pdf, INF_T),
                       nee_active & (l_pdf > 0.0), "env", l_dir, l_rad, l_pdf))
    for _ in range(cfg.mesh_samples_per_bounce):
        rng, r2 = R.next_float2(rng)
        l_dir, l_pos, l_n, _tri, l_bary, l_pdf, l_row = sample_mesh_lights(
            scene, position, r2)
        l_rad = _emissive_at(scene, l_row, l_bary)
        # two-ended shadow segment (light.hlsl:149-154)
        off_light = offset_along_normal(l_pos, l_n)
        off_shade = offset_along_normal(position,
                                        face_forward(tri_frame.n, l_dir))
        seg = off_light - off_shade
        seg_len = norm(seg)[..., 0]
        seg_dir = seg / torch.clamp_min(seg_len, 1e-20)[..., None]
        shadow.append((off_shade, seg_dir, seg_len, nee_active & (l_pdf > 0.0),
                       "mesh", l_dir, l_rad, l_pdf))

    if shadow:
        occ_all = packet.any_hit_packet(
            scene.wide,
            torch.cat([b[0] for b in shadow]),
            torch.cat([b[1] for b in shadow]),
            torch.cat([b[2] for b in shadow]),
            active_in=torch.cat([b[3] for b in shadow]),
        )
        n = position.shape[0]
        for i, (_, _, _, lane, kind, l_dir, l_rad, l_pdf) in enumerate(shadow):
            occluded = occ_all[i * n:(i + 1) * n]
            rays = rays + lane.sum()
            l_pdf = torch.where(occluded, 0.0, l_pdf)
            w_i_ss = frame.world_to_frame(l_dir)
            brdf, scatter_pdf = B.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
            n_samples = (cfg.env_samples_per_bounce if kind == "env"
                         else cfg.mesh_samples_per_bounce)
            mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
            contrib = l_rad * brdf * (
                torch.abs(cos_theta(w_i_ss)) * mis
                / torch.clamp_min(l_pdf, 1e-30))[..., None]
            ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
            radiance = radiance + _masked(ok, throughput * contrib / n_samples)

    # ---- scatter (integrator.hlsl:153-163)
    rng, r2 = R.next_float2(rng)
    w_i_ss, pdf = B.sample_bsdf(mat, w_o_ss, r2)
    active = active & (pdf > 0.0)
    new_d = normalize(frame.frame_to_world(w_i_ss))
    new_o = offset_along_normal(position, face_forward(tri_frame.n, new_d))
    f = B.eval_bsdf(mat, w_i_ss, w_o_ss)
    thr_mul = f * (torch.abs(cos_theta(w_i_ss))
                   / torch.clamp_min(pdf, 1e-30))[..., None]
    act = active[..., None]
    return dict(
        st,
        active=active,
        o=torch.where(act, new_o, o),
        d=torch.where(act, new_d, d),
        throughput=torch.where(act, throughput * thr_mul, throughput),
        radiance=radiance,
        last_pdf=pdf,
        last_delta=is_delta,
        rng=rng,
        rays=rays,
    )


def _init_state(ray_o, ray_d, rng_state) -> dict:
    N = ray_o.shape[0]
    dev = ray_o.device
    f32 = torch.float32
    return dict(
        active=torch.ones(N, dtype=torch.bool, device=dev),
        o=ray_o,
        d=ray_d,
        throughput=torch.ones((N, 3), dtype=f32, device=dev),
        radiance=torch.zeros((N, 3), dtype=f32, device=dev),
        last_pdf=torch.ones(N, dtype=f32, device=dev),
        last_delta=torch.zeros(N, dtype=torch.bool, device=dev),
        rng=rng_state,
        rays=torch.zeros((), dtype=torch.int64, device=dev),
    )


def trace_paths(scene, ray_o, ray_d, rng_state, cfg: PathConfig):
    """Estimate incoming radiance along N rays.

    Returns (radiance [N,3], rng_state, rays_traced int64 scalar, segments)
    where rays_traced counts the closest-hit and shadow rays issued for
    live lanes (the Mrays/s numerator, path.py:400,580 of the reference)
    and segments is the number of bounce segments run (one closest-hit
    dispatch each).

    The unrolled form runs all max_bounces + 2 segments, the last one
    thin; the looped form (deep bounce budgets) stops as soon as no lane
    is live, which costs one host sync per segment."""
    st = _init_state(ray_o, ray_d, rng_state)
    n_segments = cfg.max_bounces + 2
    unroll = cfg.unroll if cfg.unroll is not None else n_segments <= 10
    segments = 0
    if unroll:
        for bounce in range(n_segments):
            st = _bounce_body(scene, cfg, bounce, st,
                              last=bounce == n_segments - 1)
            segments += 1
    else:
        bounce = 0
        while bounce < n_segments and bool(st["active"].any()):
            st = _bounce_body(scene, cfg, bounce, st)
            bounce += 1
            segments += 1
    return st["radiance"], st["rng"], st["rays"], segments
