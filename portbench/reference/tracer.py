"""The plain reference path tracer: what the program's image holds at a
sample of pixels, worked out again in plain torch.

Each (pixel, sample) is one path with the program's semantics: the
camera ray and the PCG stream keyed by (sample, x, y); per bounce the
closest hit, the env miss MIS-weighted against the env draw, the surface
decode (the shading-normal chain, the emission MIS-weighted against the
mesh-light draw), the max-bounce cut and the roulette past bounce 3,
one env and one mesh-light NEE sample a bounce each with its shadow
ray, their power-heuristic weights, and the BSDF scatter; the samples of
a pixel folded into a running mean as the program's sensor folds them.
The arithmetic restates the program's plain versions at commit 747dbd6
(moonshine_tpu_torch/integrator/shade.py `surface_plain`, `_draw_plain`,
`_light_samples`, `scatter_plain`, `weigh_plain`, `env_miss_plain`;
render/frame_kernels.py `sample_rays_plain`; render/camera.py;
lights/mesh_lights.py; render/sensor.py `accumulate`), op for op, on
the frozen copies beside this file. The hits are found by brute force
over Morton-ordered clusters of triangles (scene.py), nearest box
first, with the program's triangle tests (accel/packet.py `_tri_closest`
and `_tri_any`), not through the program's BVH.

`Precision` makes the control: the same tracer with its rays (the
camera's, the bounces' and the shadow rays) and the path's throughput
and radiance stored in bfloat16 between bounces, the precision below
the float32 the configuration states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import materials as B
from . import mathutil as M
from . import rng as R
from . import alias_table
from .envmap import miss_radiance_and_pdf, sample_envmap
from .frame import Frame, cos_theta
from .mappings import square_to_gaussian, square_to_triangle
from .mappings import square_to_uniform_disk_concentric
from .mathutil import (INF_T, cross, dot, face_forward, luminance, norm,
                       normalize, offset_along_normal, safe_normalize)

_TINY = 1e-12
RAY_BLOCK = 16384  # rays a block of the brute-force hit search


class Precision(NamedTuple):
    """Where the tracer rounds its state: None keeps float32 (the
    reference), torch.bfloat16 makes the control."""

    store: torch.dtype | None = None

    def __call__(self, x):
        if self.store is None:
            return x
        return x.to(self.store).to(torch.float32)


FLOAT32 = Precision()
BFLOAT16 = Precision(torch.bfloat16)


# ---- hits: brute force over clusters, nearest box first

def _tri_closest(v0, e1, e2, o, d, t_best):
    """Moller-Trumbore with exact division (accel/packet.py)."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    det_c = torch.where(torch.abs(det) < _TINY, _TINY, det)
    inv_det = 1.0 / det_c
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    valid = ((torch.abs(det) > _TINY) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0) & (t < t_best))
    return valid, t, u, v


def _tri_any(v0, e1, e2, o, d, t_max):
    """Division-free occlusion test (accel/packet.py)."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    s = torch.where(det >= 0.0, 1.0, -1.0)
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u_n = (tx * px + ty * py + tz * pz) * s
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v_n = (d[0] * qx + d[1] * qy + d[2] * qz) * s
    t_n = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * s
    det_a = det * s
    return ((det_a > _TINY) & (u_n >= 0.0) & (v_n >= 0.0)
            & (u_n + v_n <= det_a) & (t_n > 0.0) & (t_n < t_max * det_a))


def _entry(sc, o, d, t_max):
    """Each ray's entry distance into each cluster's box ([n, K], inf
    where it misses the box before t_max), and the clusters' order by
    it."""
    tiny = torch.full_like(d, 1e-30)
    d_safe = torch.where(torch.abs(d) < 1e-30, torch.copysign(tiny, d), d)
    inv = 1.0 / d_safe
    t0 = (sc.box_lo[None] - o[:, None]) * inv[:, None]
    t1 = (sc.box_hi[None] - o[:, None]) * inv[:, None]
    t_near = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
    t_far = torch.maximum(t0, t1).amin(-1)
    hit = (t_near <= t_far) & (t_near < t_max[:, None])
    key = torch.where(hit, t_near, torch.full_like(t_near, math.inf))
    return torch.sort(key, dim=1)


def _split(x):
    return [x[..., k] for k in range(3)]


def _closest_block(sc, o, d):
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), INF_T, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    key, order = _entry(sc, o, d, best_t)
    for k in range(key.shape[1]):
        rows = torch.nonzero(key[:, k] < best_t).squeeze(1)
        if rows.numel() == 0:
            break
        tris = sc.cluster_tris[order[rows, k]]  # [r, C]
        ok = tris >= 0
        t_ids = tris.clamp_min(0)
        ro = _split(o[rows][:, None, :])
        rd = _split(d[rows][:, None, :])
        valid, t, u, v = _tri_closest(
            _split(sc.v0[t_ids]), _split(sc.e1[t_ids]), _split(sc.e2[t_ids]),
            ro, rd, best_t[rows][:, None])
        t = torch.where(valid & ok, t, torch.full_like(t, math.inf))
        t_min, j = t.min(dim=1)
        better = t_min < best_t[rows]
        take = rows[better]
        pick = (better.nonzero().squeeze(1), j[better])
        best_t[take] = t_min[better]
        best_tri[take] = tris[pick]
        best_u[take] = u[pick]
        best_v[take] = v[pick]
    return best_t, best_tri, best_u, best_v


def closest_hit(sc, o, d):
    """(t, tri (-1 on a miss), u, v) of each ray's closest hit."""
    outs = [_closest_block(sc, o[i:i + RAY_BLOCK], d[i:i + RAY_BLOCK])
            for i in range(0, o.shape[0], RAY_BLOCK)]
    if not outs:
        z = torch.zeros(0, device=o.device)
        return z, z.long(), z, z
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _occluded_block(sc, o, d, t_max):
    n = o.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    key, order = _entry(sc, o, d, t_max)
    for k in range(key.shape[1]):
        rows = torch.nonzero((key[:, k] < math.inf) & ~hit).squeeze(1)
        if rows.numel() == 0:
            break
        tris = sc.cluster_tris[order[rows, k]]
        t_ids = tris.clamp_min(0)
        found = _tri_any(
            _split(sc.v0[t_ids]), _split(sc.e1[t_ids]), _split(sc.e2[t_ids]),
            _split(o[rows][:, None, :]), _split(d[rows][:, None, :]),
            t_max[rows][:, None])
        hit[rows] = (found & (tris >= 0)).any(dim=1)
    return hit


def occluded(sc, o, d, t_max):
    """Whether each ray hits any triangle before t_max."""
    parts = [_occluded_block(sc, o[i:i + RAY_BLOCK], d[i:i + RAY_BLOCK],
                             t_max[i:i + RAY_BLOCK])
             for i in range(0, o.shape[0], RAY_BLOCK)]
    if not parts:
        return torch.zeros(0, dtype=torch.bool, device=o.device)
    return torch.cat(parts)


# ---- camera rays (render/frame_kernels.py sample_rays_plain,
# render/camera.py)

class Lens(NamedTuple):
    origin: torch.Tensor
    forward: torch.Tensor
    up: torch.Tensor
    vfov: torch.Tensor
    aperture: torch.Tensor
    focus_distance: torch.Tensor

    @staticmethod
    def of(lens: dict, device) -> "Lens":
        f32 = lambda x: torch.as_tensor(np.float32(x), dtype=torch.float32,
                                        device=device)
        return Lens(*(f32(lens[k]) for k in Lens._fields))


def camera_rays(lens: Lens, width, height, px, py, sample, flip_image):
    """(o, d, rng) of the camera rays of pixels (px, py) at the sample
    indices `sample` (int64 tensors)."""
    rng = R.seed(sample, px, py)
    rng, jitter = R.next_float2(rng)
    center = 0.5 + 0.5 * square_to_gaussian(jitter)
    u = (px.to(torch.float32) + center[..., 0]) / width
    v = (py.to(torch.float32) + center[..., 1]) / height
    if flip_image:
        v = 1.0 - v
    uv = torch.stack([u, v], dim=-1)
    rng, ap = R.next_float2(rng)
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
    rd = lens.aperture * square_to_uniform_disk_concentric(ap) / 2.0
    defocus = rd[..., 0:1] * u_axis + rd[..., 1:2] * v_axis
    origin = lens.origin + defocus
    target = lower_left + uv[..., 0:1] * horizontal + uv[..., 1:2] * vertical
    return (origin.expand_as(target).contiguous(),
            normalize(target - defocus - lens.origin), rng)


# ---- one bounce's shading (integrator/shade.py's plain versions)

def power_heuristic(numf, f_pdf, numg, g_pdf):
    f = numf * f_pdf
    g = numg * g_pdf
    f2 = f * f
    return f2 / torch.clamp_min(f2 + g * g, 1e-30)


def _masked(mask, value):
    return torch.where(mask[..., None], value, torch.zeros_like(value))


def _interp(bary_u, bary_v, corners):
    b0 = (1.0 - bary_u - bary_v)[..., None]
    return (b0 * corners[:, 0] + bary_u[..., None] * corners[:, 1]
            + bary_v[..., None] * corners[:, 2])


def _tangent_bitangent(p0, p1, p2, t0, t1, t2):
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
    fallback = Frame.from_normal(safe_normalize(cross(p2 - p0, p1 - p0)))
    tangent = torch.where(bad[..., None], fallback.s, tangent)
    bitangent = torch.where(bad[..., None], fallback.t, bitangent)
    return tangent, bitangent


def _area_to_solid_angle(pos1, pos2, dir1, dir2):
    diff = pos1 - pos2
    r2 = dot(diff, diff, keepdims=False)
    light_cos = dot(-dir1, dir2, keepdims=False)
    return torch.where(light_cos > 0.0,
                       r2 / torch.clamp_min(light_cos, 1e-20),
                       torch.zeros_like(r2))


def _sample_mesh_lights(sc, position_ws, rand2):
    """(dir, light position, light normal, emitted radiance, pdf) of one
    emitter draw a lane (lights/mesh_lights.py)."""
    count = max(sc.em_count, 1)
    slot, rx = alias_table.sample(sc.em_select, sc.em_alias, count,
                                  rand2[..., 0])
    slot = torch.clamp(slot, 0, sc.em_corners.shape[0] - 1)
    bary = square_to_triangle(torch.stack([rx, rand2[..., 1]], dim=-1))
    corners = sc.em_corners[slot].reshape(-1, 3, 3)
    b0 = (1.0 - bary[..., 0] - bary[..., 1])[..., None]
    b1 = bary[..., 0][..., None]
    b2 = bary[..., 1][..., None]
    light_pos = b0 * corners[:, 0] + b1 * corners[:, 1] + b2 * corners[:, 2]
    gn = safe_normalize(cross(corners[:, 0] - corners[:, 2],
                              corners[:, 1] - corners[:, 2]))
    dir_ws = safe_normalize(light_pos - position_ws)
    pdf = _area_to_solid_angle(light_pos, position_ws, dir_ws, gn) / max(
        sc.em_weight_sum, 1e-20)
    if sc.em_count == 0:
        pdf = torch.zeros_like(pdf)
    return dir_ws, light_pos, gn, sc.em_emissive[slot], pdf


class Config(NamedTuple):
    max_bounces: int
    env_samples: int
    mesh_samples: int


def _bounce(sc, cfg: Config, bounce: int, st: dict, prec: Precision):
    """One bounce of the live paths `st` (o, d, throughput, radiance,
    last_pdf, last_delta, rng, active: every lane live on entry). Returns
    the state after it, `active` marking the paths that go on."""
    o, d, throughput = st["o"], st["d"], st["throughput"]
    last_pdf, last_delta = st["last_pdf"], st["last_delta"]
    radiance, active = st["radiance"], st["active"]
    t, tri, bu, bv = closest_hit(sc, o, d)

    # the env miss (env_miss_plain)
    miss = active & ~(tri >= 0)
    env_plain = last_delta | (bounce == 0) | (cfg.env_samples == 0)
    env_rad, rad_e, pdf_e = miss_radiance_and_pdf(sc.env, d)
    lit = radiance
    if cfg.env_samples > 0:
        w = power_heuristic(1.0, last_pdf, cfg.env_samples, pdf_e)
        lit = lit + _masked(miss & ~env_plain & (pdf_e > 0.0),
                            throughput * rad_e * w[..., None])
    lit = lit + _masked(miss & env_plain, throughput * env_rad)
    radiance = torch.where(miss[..., None], lit, radiance)
    active = active & ~miss

    # the surface decode (surface_plain, full form; flat normal maps)
    tri = torch.clamp(tri, 0, sc.num_tris - 1)
    corners, nrms, uvs = sc.corners[tri], sc.normals[tri], sc.uvs[tri]
    mid = sc.mat[tri]
    position = _interp(bu, bv, corners)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tangent, bitangent = _tangent_bitangent(p0, p1, p2, uvs[:, 0],
                                            uvs[:, 1], uvs[:, 2])
    tri_n = safe_normalize(cross(p0 - p2, p1 - p2))
    tri_frame = Frame(n=tri_n, s=tangent, t=bitangent).reorthogonalize()
    vtx_n = safe_normalize(_interp(bu, bv, nrms))
    vtx_frame = Frame(n=vtx_n, s=tri_frame.s, t=tri_frame.t).reorthogonalize()
    mat = B.MaterialLanes(
        type=sc.mat_type[mid], color=sc.color[mid],
        metalness=sc.metalness[mid],
        alpha=torch.clamp_min(sc.roughness[mid] * sc.roughness[mid], 1e-3),
        ior=sc.ior[mid])
    emissive = sc.emissive[mid]
    w_o_ws = -d
    frontfacing = dot(tri_frame.n, w_o_ws, keepdims=False) > 0.0
    sgn = torch.where(frontfacing, 1.0, -1.0)
    vtx_ok = (sgn * dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0)[..., None]
    frame = Frame(n=torch.where(vtx_ok, vtx_frame.n, tri_frame.n),
                  s=torch.where(vtx_ok, vtx_frame.s, tri_frame.s),
                  t=torch.where(vtx_ok, vtx_frame.t, tri_frame.t))
    w_o_ss = frame.world_to_frame(w_o_ws)

    # the emission (integrator.hlsl:109-124)
    emit_plain = (~sc.sampled[tri] | last_delta | (bounce == 0)
                  | (cfg.mesh_samples == 0))
    emit_front = dot(w_o_ws, tri_n, keepdims=False) > 0.0
    radiance = radiance + _masked(active & emit_plain & emit_front,
                                  throughput * emissive)
    if cfg.mesh_samples > 0:
        light_pdf = _area_to_solid_angle(position, o, d, tri_n) / max(
            sc.em_weight_sum, 1e-20)
        w = power_heuristic(1.0, last_pdf, cfg.mesh_samples, light_pdf)
        radiance = radiance + _masked(
            active & ~emit_plain & (light_pdf > 0.0),
            throughput * emissive * w[..., None])
    if bounce >= cfg.max_bounces + 1:  # the max-bounce cut
        return dict(st, radiance=prec(radiance),
                    active=torch.zeros_like(active))

    # the roulette and the NEE draws (_draw_plain, _light_samples)
    rng, rr_rand = R.next_float(st["rng"])
    if bounce > 3:
        p_survive = torch.clamp_max(luminance(throughput), 0.95)
        active = active & ~(rr_rand > p_survive)
        throughput = torch.where(
            active[..., None],
            throughput / torch.clamp_min(p_survive, 1e-20)[..., None],
            throughput)
    nee = active & ~B.is_delta(mat.type)
    samples = []  # (shadow o, d, t_max, traced, light dir, radiance, pdf, n)
    for _ in range(cfg.env_samples):
        rng, r2 = R.next_float2(rng)
        l_dir, l_rad, l_pdf = sample_envmap(sc.env, r2)
        shadow_o = offset_along_normal(position, face_forward(tri_n, l_dir))
        samples.append((shadow_o, l_dir, torch.full_like(l_pdf, INF_T),
                        nee & (l_pdf > 0.0), l_dir, l_rad, l_pdf,
                        cfg.env_samples))
    for _ in range(cfg.mesh_samples):
        rng, r2 = R.next_float2(rng)
        l_dir, l_pos, l_n, l_rad, l_pdf = _sample_mesh_lights(sc, position,
                                                              r2)
        off_light = offset_along_normal(l_pos, l_n)
        off_shade = offset_along_normal(position, face_forward(tri_n, l_dir))
        seg = off_light - off_shade
        seg_len = norm(seg)[..., 0]
        seg_dir = seg / torch.clamp_min(seg_len, 1e-20)[..., None]
        samples.append((off_shade, seg_dir, seg_len, nee & (l_pdf > 0.0),
                        l_dir, l_rad, l_pdf, cfg.mesh_samples))

    # the shadow rays, the weights (weigh_plain) and the scatter
    for so, sd, st_max, lane, l_dir, l_rad, l_pdf, n_samples in samples:
        occ = torch.zeros_like(lane)
        rows = lane.nonzero().squeeze(1)
        if rows.numel():
            occ[rows] = occluded(sc, prec(so[rows]), prec(sd[rows]),
                                 st_max[rows])
        l_pdf = torch.where(occ, 0.0, l_pdf)
        w_i_ss = frame.world_to_frame(l_dir)
        brdf, scatter_pdf = B.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
        mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
        contrib = l_rad * brdf * (
            torch.abs(cos_theta(w_i_ss)) * mis
            / torch.clamp_min(l_pdf, 1e-30))[..., None]
        contrib = throughput * contrib
        ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
        radiance = radiance + _masked(ok, contrib / n_samples)

    rng, r2 = R.next_float2(rng)
    w_i_ss, pdf = B.sample_bsdf(mat, w_o_ss, r2)
    active = active & (pdf > 0.0)
    new_d = normalize(frame.frame_to_world(w_i_ss))
    new_o = offset_along_normal(position, face_forward(tri_n, new_d))
    f = B.eval_bsdf(mat, w_i_ss, w_o_ss)
    thr_mul = f * (torch.abs(cos_theta(w_i_ss))
                   / torch.clamp_min(pdf, 1e-30))[..., None]
    act = active[..., None]
    return dict(
        active=active,
        o=prec(torch.where(act, new_o, o)),
        d=prec(torch.where(act, new_d, d)),
        throughput=prec(torch.where(act, throughput * thr_mul, throughput)),
        radiance=prec(radiance),
        last_pdf=pdf,
        last_delta=B.is_delta(mat.type),
        rng=rng,
    )


def trace(sc, cfg: Config, o, d, rng, prec: Precision = FLOAT32):
    """Radiance [N, 3] of the paths from rays (o, d) with PCG states rng,
    the live ones compacted after every bounce."""
    n = o.shape[0]
    dev = o.device
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ids = torch.arange(n, device=dev)
    st = dict(o=prec(o), d=prec(d),
              throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
              radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
              last_pdf=torch.ones(n, dtype=torch.float32, device=dev),
              last_delta=torch.zeros(n, dtype=torch.bool, device=dev),
              rng=rng, active=torch.ones(n, dtype=torch.bool, device=dev))
    for bounce in range(cfg.max_bounces + 2):
        st = _bounce(sc, cfg, bounce, st, prec)
        out[ids] = st["radiance"]
        keep = st.pop("active").nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        ids = ids[keep]
        st = {k: v[keep] for k, v in st.items()}
        st["active"] = torch.ones(keep.numel(), dtype=torch.bool, device=dev)
    return out


def running_mean(samples):
    """The program's sensor (render/sensor.py `accumulate`) over samples
    [S, P, 3] in order: the first one as it is, each later one folded in
    as image + (x - image * 1) / (count + 1)."""
    image = samples[0] / 1
    for k in range(1, samples.shape[0]):
        image = image + (samples[k] - image * 1) / float(k + 1)
    return image


def pixels(sc, cfg: Config, lens: Lens, width: int, height: int,
           flat_ids, sample_ids, flip_image: bool,
           prec: Precision = FLOAT32, paths_a_call: int = 1 << 17):
    """The running mean over `sample_ids` (in order) at the pixels
    `flat_ids` (y * width + x): [P, 3]."""
    dev = sc.v0.device
    flat = torch.as_tensor(np.asarray(flat_ids), dtype=torch.int64,
                           device=dev)
    samples = torch.as_tensor(np.asarray(sample_ids), dtype=torch.int64,
                              device=dev)
    px, py = flat % width, flat // width
    S, P = samples.shape[0], flat.shape[0]
    # paths sample-major: path (s, p)
    s_all = samples.repeat_interleave(P)
    px_all, py_all = px.repeat(S), py.repeat(S)
    rad = torch.empty((S * P, 3), dtype=torch.float32, device=dev)
    for i in range(0, S * P, paths_a_call):
        j = min(i + paths_a_call, S * P)
        o, d, rng = camera_rays(lens, width, height, px_all[i:j],
                                py_all[i:j], s_all[i:j], flip_image)
        rad[i:j] = trace(sc, cfg, o, d, rng, prec)
    return running_mean(rad.view(S, P, 3))
