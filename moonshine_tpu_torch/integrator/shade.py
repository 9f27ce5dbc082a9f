"""The bounce's shading: the surface decode with the bounce's light draw,
the environment lookups and the BSDF scatter of one bounce segment, each
a kernel of csrc/shade.cu (the reference's bounce as XLA fuses it around
its gathers, moonshine_tpu/integrator/path.py:371-623, and the role of
its core/gather.py: each per-hit table fetch next to the math that
consumes it).

`surface`, `scatter`, `env_miss` and `env_draw` launch their kernel for
CUDA tensors, on the tensors' card and its current stream (so a CUDA
graph captures them), reading the bounce index from device memory; for
CPU tensors they run their plain version (`*_plain`), the integrator's
torch code moved behind one function each with the kernel's inputs and
outputs. There is no fallback: a failed build or launch raises. The
kernels update the lane state in place and leave dead lanes, and equal
the plain versions bit for bit on the card on every lane they write (the
wrappers' docstrings say which). Each wrapper adds one to LAUNCHES[its
name] where it launches (into a capture's tally while a graph is
captured: accel/launch.py), and to LAUNCHES["counts"] where that launch
also counts.

The bounce loop's counts (the reference's jnp.sum at path.py:400, :580,
:687) ride on these kernels: the full surface form adds the shadow rays
it sets to `rays`, the scatter the lanes it leaves live to `live`, each
an int64 device scalar (the plain versions add torch's sums of the same
masks; integer sums, so both are exact).

The full surface form with a `DrawIn` also ends the bounce's termination
and draws its NEE light samples (`_draw_plain`): the max-bounce cut, the
roulette, each env and mesh-light sample (`Lights`) and its shadow ray
into the any-hit batch (`Shadow`). The plain versions' helpers
(`_decode_hit`, `_decode_material`, `_inst_world`, `_emissive_at`, ...)
port the reference's of the same names.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import native
from ..accel.launch import Counts, call_on, count_launch
from ..bsdf import materials as B
from ..core import mathutil as M
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

# the surface kernel's forms: a bounce's, the last segment's (emission
# only; every lane dies) and the direct integrator's
FULL, THIN, DIRECT = "full", "thin", "direct"
_MODE_CODES = {FULL: 0, THIN: 1, DIRECT: 2}

LAUNCHES = Counts({"surface": 0, "scatter": 0, "env_miss": 0,
                   "env_draw": 0, "counts": 0})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class DrawIn(NamedTuple):
    """What the full form needs to draw a bounce's light samples."""

    env: object  # lights.envmap.EnvMap
    env_samples: int  # env samples a bounce (drawn first)
    max_bounces: int
    roulette: bool  # bounce > 3, decided on the host
    rng: torch.Tensor  # [N] int64 PCG states


class Lights(NamedTuple):
    """A bounce's S NEE samples, env ones first (S = env + mesh samples
    a bounce), and their shadow rays' answers."""

    dir: torch.Tensor  # [S, N, 3] world-space direction to the light
    radiance: torch.Tensor  # [S, N, 3]
    pdf: torch.Tensor  # [S, N] solid-angle pdf before occlusion
    lane: torch.Tensor  # [S, N] bool: the shadow ray is traced
    occluded: torch.Tensor | None  # [S, N] bool, once traced
    env_samples: int  # the first samples, of the env map; then the
    mesh_samples: int  # mesh lights' (S = env_samples + mesh_samples)

    def n_samples(self, k: int) -> int:
        """The samples a bounce draws of sample k's kind."""
        return self.env_samples if k < self.env_samples else self.mesh_samples


class Shadow(NamedTuple):
    """A bounce's shadow rays, [S * N] in the samples' order: the any-hit
    batch as `_any_hit` takes it."""

    o: torch.Tensor  # [S * N, 3]
    d: torch.Tensor  # [S * N, 3]
    t_max: torch.Tensor  # [S * N]
    lane: torch.Tensor  # [S * N] bool


class Surface(NamedTuple):
    """The decoded hit: position, the geometric normal, the shading
    frame, w_o in it, the material, the radiance with the hit's emission
    added, and the lanes live after the segment (the thin form: none; it
    leaves the others None). The full form's also holds its draw's
    throughput after the roulette, the advanced rng, the light samples
    and their shadow rays (None when a bounce draws none); `active` is
    then the lanes live after the cut and the roulette."""

    position: torch.Tensor | None  # [N, 3]
    tri_n: torch.Tensor | None  # [N, 3]
    frame: Frame | None
    w_o_ss: torch.Tensor | None  # [N, 3]
    mat: B.MaterialLanes | None
    radiance: torch.Tensor  # [N, 3]
    active: torch.Tensor  # [N] bool
    throughput: torch.Tensor | None = None  # [N, 3]
    rng: torch.Tensor | None = None  # [N] int64
    lights: Lights | None = None
    shadow: Shadow | None = None


# ---- the plain versions' helpers (reference path.py:95-256)

def power_heuristic(numf, f_pdf, numg, g_pdf):
    """Power heuristic, exponent 2 (integrator.hlsl:10-16)."""
    f = numf * f_pdf
    g = numg * g_pdf
    f2 = f * f
    return f2 / torch.clamp_min(f2 + g * g, 1e-30)


def _masked(mask, value):
    """value where mask (broadcast over the trailing axis), else 0."""
    return torch.where(mask[..., None], value, torch.zeros_like(value))


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


def _inst_world(scene, inst, corners, nrms):
    """Two-level decode: the object-space corners (and normals, unless
    None) of the gathered rows into world space by each lane's instance
    (reference path.py:121-137): corners by inst_tf, normals by the
    transpose of the TLAS's world -> object matrix (the inverse
    transpose). Returns (corners, normals, determinant sign)."""
    k = torch.clamp(inst.to(torch.int64), 0, scene.inst_tf.shape[0] - 1)
    tf = scene.inst_tf[k]  # [N, 13]
    lin = tf[:, :9].reshape(-1, 3, 3)
    corners_w = _rows_times(lin, corners) + tf[:, None, 9:12]
    nrms_w = None
    if nrms is not None:
        nrm_m = scene.tlas.inst_inv[k][:, :9].reshape(-1, 3, 3)
        nrms_w = safe_normalize(_rows_times(nrm_m, nrms, transposed=True))
    return corners_w, nrms_w, tf[:, 12]


def _rows_times(m, c, transposed: bool = False):
    """[N, K, 3]: each of c's K vectors times m [N, 3, 3] (or its
    transpose). On the card the einsum (cuBLAS's batched product, which
    the surface kernel reproduces); on the CPU the products summed as
    `dot` sums them, since the einsum there is MKL's, whose order
    depends on the host."""
    if m.device.type == "cuda":
        return torch.einsum("nji,nkj->nki" if transposed else "nij,nkj->nki",
                            m, c)
    if transposed:
        m = m.transpose(1, 2)
    return torch.sum(m[:, None] * c[:, :, None], dim=-1)


def _decode_hit(scene, tri, bary_u, bary_v, inst=None):
    """Surface attributes at a hit (world.hlsl:107-177). Returns
    (position, uv, tri_frame, vtx_frame, mat_row, sampled). `inst` (a
    two-level scene's hits) places the object-space rows in the world."""
    row = scene.tri_shade[tri]  # [N, 48]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    nrms = row[:, 9:18].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    sampled = row[:, 25] > 0.5
    det_sign = None
    if inst is not None and scene.tlas is not None:
        corners, nrms, det_sign = _inst_world(scene, inst, corners, nrms)

    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tangent, bitangent = _tangent_bitangent(p0, p1, p2, uvs[:, 0],
                                            uvs[:, 1], uvs[:, 2])
    tri_n = safe_normalize(cross(p0 - p2, p1 - p2))
    if det_sign is not None:
        # a mirroring instance flips the winding (the flatten swaps
        # corners instead)
        tri_n = tri_n * det_sign[..., None]
    tri_frame = Frame(n=tri_n, s=tangent, t=bitangent).reorthogonalize()
    vtx_n = safe_normalize(_interp(bary_u, bary_v, nrms))
    vtx_frame = Frame(n=vtx_n, s=tri_frame.s, t=tri_frame.t).reorthogonalize()
    return position, uv, tri_frame, vtx_frame, row[:, 32:48], sampled


def _decode_hit_thin(scene, tri, bary_u, bary_v, inst=None):
    """Last-segment decode: position, triangle normal, uv, material row
    and sampled flag only (the last segment only adds emission); values
    equal the full decode's."""
    row = scene.tri_shade[tri]
    n = tri.shape[0]
    corners = row[:, 0:9].reshape(n, 3, 3)
    uvs = row[:, 18:24].reshape(n, 3, 2)
    det_sign = None
    if inst is not None and scene.tlas is not None:
        corners, _, det_sign = _inst_world(scene, inst, corners, None)
    position = _interp(bary_u, bary_v, corners)
    uv = _interp(bary_u, bary_v, uvs)
    p0, p1, p2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tri_n = safe_normalize(cross(p0 - p2, p1 - p2))
    if det_sign is not None:
        tri_n = tri_n * det_sign[..., None]
    return position, uv, tri_n, row[:, 32:48], row[:, 25] > 0.5


def _decode_emissive(scene, mat_row, uv):
    """Emitted radiance (getEmissive, material.hlsl:519-522)."""
    if scene.mat_atlas.emissive_constant:
        return mat_row[:, 7:10]
    block = sample_material_block(scene.mat_atlas.emissive,
                                  mat_row[:, 12:16], uv)
    return block[:, TX.EMISSIVE]


def _emissive_at(scene, light_row, bary):
    """Emitted radiance at a light sample from its packed emitter row
    (reference path.py:256)."""
    if scene.mat_atlas.emissive_constant:
        return light_row[:, 15:18]
    n = light_row.shape[0]
    uv = _interp(bary[..., 0], bary[..., 1], light_row[:, 9:15].reshape(n, 3, 2))
    block = sample_material_block(scene.mat_atlas.emissive,
                                  light_row[:, 18:22], uv)
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
    z = M.sqrt(torch.clamp(1.0 - torch.sum(rg * rg, dim=-1), 0.0, 1.0))
    n_ts = torch.cat([rg, z[..., None]], dim=-1)
    n_ws = normalize(vtx_frame.frame_to_world(n_ts))
    return Frame(n=n_ws, s=vtx_frame.s, t=vtx_frame.t).reorthogonalize()


# ---- the plain versions

def surface_plain(scene, mesh_samples: int, bounce, hit, o, d, active,
                  throughput, radiance, last_pdf, last_delta,
                  mode: str = FULL, draw: DrawIn | None = None,
                  rays=None) -> Surface:
    """Decode each lane's hit (masked lanes read clamped junk rows), pick
    its shading frame and add its emission (integrator.hlsl:93-124;
    reference path.py:424-485). THIN: the last segment's decode and
    emission, after which every lane dies. DIRECT: the direct
    integrator's (integrator.hlsl:199-215): the normal-mapped frame
    always, picked without the front-face sign, and the emission of every
    hit lane; it reads none of o, throughput, last_pdf, last_delta and
    bounce. `bounce` is an int or a device scalar. FULL then also draws
    the bounce's light samples (`_draw_plain`; `draw` is required) and
    adds the shadow rays it sets to `rays` where given."""
    tri = torch.clamp(hit.tri.to(torch.int64), 0, scene.num_tris - 1)
    w_o_ws = -d
    frame = w_o_ss = mat = None
    if mode == THIN:
        position, uv, tri_n, mat_row, tri_sampled = _decode_hit_thin(
            scene, tri, hit.u, hit.v, inst=hit.inst)
        emissive = _decode_emissive(scene, mat_row, uv)
    else:
        position, uv, tri_frame, vtx_frame, mat_row, tri_sampled = (
            _decode_hit(scene, tri, hit.u, hit.v, inst=hit.inst))
        mat, emissive, normal_rg = _decode_material(scene, mat_row, uv)
        tri_n = tri_frame.n

        # shading-normal selection chain (integrator.hlsl:93-104); with
        # flat normal maps the texture frame is the vertex frame
        if mode == DIRECT:
            tex_frame = _texture_frame(normal_rg, vtx_frame)
            tex_ok = (dot(w_o_ws, tex_frame.n, keepdims=False) > 0.0)[
                ..., None]
            vtx_ok = (dot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0)[
                ..., None]

            def pick(a, b, c):
                return torch.where(tex_ok, a, torch.where(vtx_ok, b, c))
        else:
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

    if mode == DIRECT:
        radiance = radiance + _masked(active, emissive)
        return Surface(position, tri_n, frame, w_o_ss, mat, radiance, active)

    # ---- emissive accumulation (integrator.hlsl:109-124)
    emit_plain = (~tri_sampled | last_delta | (bounce == 0)
                  | (mesh_samples == 0))
    emit_front = dot(w_o_ws, tri_n, keepdims=False) > 0.0
    radiance = radiance + _masked(active & emit_plain & emit_front,
                                  throughput * emissive)
    if mesh_samples > 0:
        light_pdf = area_to_solid_angle(position, o, d, tri_n) / max(
            scene.emitters.weight_sum, 1e-20)
        w = power_heuristic(1.0, last_pdf, mesh_samples, light_pdf)
        radiance = radiance + _masked(active & ~emit_plain & (light_pdf > 0.0),
                                      throughput * emissive * w[..., None])
    if mode == THIN:
        # the max-bounce cut kills every lane here
        return Surface(None, None, None, None, None, radiance,
                       torch.zeros_like(active))
    surf = Surface(position, tri_n, frame, w_o_ss, mat, radiance, active)
    surf = _draw_plain(scene, mesh_samples, bounce, surf, throughput, draw)
    if rays is not None and surf.shadow is not None:
        rays += surf.shadow.lane.sum()
    return surf


def _draw_plain(scene, mesh_samples: int, bounce, surf: Surface,
                throughput, draw: DrawIn) -> Surface:
    """The max-bounce cut and the roulette (integrator.hlsl:126-135),
    then every NEE light sample of the bounce with its shadow ray
    (:139-151; reference path.py:503-573): env samples through
    sample_envmap, mesh ones through sample_mesh_lights and _emissive_at
    with the two-ended shadow segment (light.hlsl:149-154)."""
    active = surf.active & (bounce < draw.max_bounces + 1)
    rng, rr_rand = R.next_float(draw.rng)
    if draw.roulette:
        p_survive = torch.clamp_max(luminance(throughput), 0.95)
        active = active & ~(rr_rand > p_survive)
        throughput = torch.where(
            active[..., None],
            throughput / torch.clamp_min(p_survive, 1e-20)[..., None],
            throughput)

    nee_active = active & ~B.is_delta(surf.mat.type)
    position, tri_n = surf.position, surf.tri_n
    samples = []  # (shadow o, d, t_max, lane, light dir, radiance, pdf)
    for _ in range(draw.env_samples):
        rng, r2 = R.next_float2(rng)
        l_dir, l_rad, l_pdf = sample_envmap(draw.env, r2)
        shadow_o = offset_along_normal(position, face_forward(tri_n, l_dir))
        samples.append((shadow_o, l_dir, torch.full_like(l_pdf, INF_T),
                        nee_active & (l_pdf > 0.0), l_dir, l_rad, l_pdf))
    for _ in range(mesh_samples):
        rng, r2 = R.next_float2(rng)
        l_dir, l_pos, l_n, _tri, l_bary, l_pdf, l_row = (
            sample_mesh_lights(scene, position, r2))
        l_rad = _emissive_at(scene, l_row, l_bary)
        off_light = offset_along_normal(l_pos, l_n)
        off_shade = offset_along_normal(position, face_forward(tri_n, l_dir))
        seg = off_light - off_shade
        seg_len = norm(seg)[..., 0]
        seg_dir = seg / torch.clamp_min(seg_len, 1e-20)[..., None]
        samples.append((off_shade, seg_dir, seg_len,
                        nee_active & (l_pdf > 0.0), l_dir, l_rad, l_pdf))
    lights = shadow = None
    if samples:
        n = position.shape[0]
        cat = lambda j: torch.cat([x[j] for x in samples])
        stack = lambda j: torch.stack([x[j] for x in samples])
        shadow = Shadow(cat(0), cat(1), cat(2), cat(3))
        lights = Lights(stack(4), stack(5), stack(6),
                        shadow.lane.view(len(samples), n), None,
                        draw.env_samples, mesh_samples)
    return surf._replace(active=active, throughput=throughput, rng=rng,
                         lights=lights, shadow=shadow)


def scatter_plain(surf: Surface, o, d, throughput, radiance, rng, active,
                  lights: Lights | None, state: dict, live=None) -> dict:
    """Weight each NEE sample (`lights`, in draw order; None: none) by the
    power heuristic and add it (integrator.hlsl:139-151), then draw the
    BSDF sample and continue the path (:153-163; reference
    path.py:518-623). Returns the lane state's new active, o, d,
    throughput, radiance, last_pdf, last_delta and rng (`state`, the
    kernel's buffers to write into, is not read here), and adds the lanes
    it leaves live to `live` where given."""
    mat, frame, w_o_ss = surf.mat, surf.frame, surf.w_o_ss
    is_delta = B.is_delta(mat.type)
    for k in range(0 if lights is None else lights.pdf.shape[0]):
        l_pdf = torch.where(lights.occluded[k], 0.0, lights.pdf[k])
        w_i_ss = frame.world_to_frame(lights.dir[k])
        brdf, scatter_pdf = B.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
        n_samples = lights.n_samples(k)
        mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
        contrib = lights.radiance[k] * brdf * (
            torch.abs(cos_theta(w_i_ss)) * mis
            / torch.clamp_min(l_pdf, 1e-30))[..., None]
        ok = lights.lane[k] & (l_pdf > 0.0) & (scatter_pdf > 0.0)
        radiance = radiance + _masked(ok, throughput * contrib / n_samples)

    # ---- scatter (integrator.hlsl:153-163)
    rng, r2 = R.next_float2(rng)
    w_i_ss, pdf = B.sample_bsdf(mat, w_o_ss, r2)
    active = active & (pdf > 0.0)
    new_d = normalize(frame.frame_to_world(w_i_ss))
    new_o = offset_along_normal(surf.position,
                                face_forward(surf.tri_n, new_d))
    f = B.eval_bsdf(mat, w_i_ss, w_o_ss)
    thr_mul = f * (torch.abs(cos_theta(w_i_ss))
                   / torch.clamp_min(pdf, 1e-30))[..., None]
    act = active[..., None]
    if live is not None:
        live += active.sum()
    return dict(
        active=active,
        o=torch.where(act, new_o, o),
        d=torch.where(act, new_d, d),
        throughput=torch.where(act, throughput * thr_mul, throughput),
        radiance=radiance,
        last_pdf=pdf,
        last_delta=is_delta,
        rng=rng,
    )


def env_miss_plain(env, env_samples: int, bounce, d, active, tri,
                   throughput, radiance, last_pdf, last_delta):
    """Environment radiance of the lanes that missed (`active` and no hit,
    tri < 0), MIS-weighted against the env draw where the last bounce
    could have drawn it (integrator.hlsl:166-180; reference
    path.py:402-436). Returns (radiance, active): new tensors, the
    radiance of every other lane as it was and the mask without the lanes
    that missed (the reference's active & is_hit)."""
    miss = active & ~(tri >= 0)
    env_plain = last_delta | (bounce == 0) | (env_samples == 0)
    lit = radiance
    if env_samples > 0:
        env_rad, rad_e, pdf_e = miss_radiance_and_pdf(env, d)
        w = power_heuristic(1.0, last_pdf, env_samples, pdf_e)
        lit = lit + _masked(miss & ~env_plain & (pdf_e > 0.0),
                            throughput * rad_e * w[..., None])
    else:
        env_rad = envmap_incoming_radiance(env, d)
    lit = lit + _masked(miss & env_plain, throughput * env_rad)
    return torch.where(miss[..., None], lit, radiance), active & ~miss


def env_draw_plain(env, rand2):
    """lights/envmap.py sample_envmap: (dir [N,3], radiance [N,3],
    pdf [N])."""
    return sample_envmap(env, rand2)


# ---- the wrappers

def _device_kind(x) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no shading kernels for device {x.device}")
    return kind


def _ptr(keep: list, x, dtype):
    """x's device pointer (None for None) as the kernel reads it:
    contiguous, of `dtype`; kept alive in `keep` until the launch has
    been enqueued."""
    if x is None:
        return None
    if x.dtype != dtype:
        raise TypeError(f"shading kernel argument of {x.dtype}, wants "
                        f"{dtype}")
    x = x.contiguous()
    keep.append(x)
    return x.data_ptr()


def _bounce_on(bounce, device):
    """The bounce index as an int64 device scalar (the graphed loop's
    own, or an int filled on the device)."""
    if torch.is_tensor(bounce):
        return bounce
    return torch.full((), int(bounce), dtype=torch.int64, device=device)


def _reciprocal(x: float, floor: float) -> float:
    """1 / max(x, floor) as torch forms a division by a Python scalar on
    the card: the scalar in float32, its float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(max(x, floor)))


def _launch(key: str, fn, device, *args) -> None:
    rc = call_on(fn, device, *args)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    count_launch(LAUNCHES, key)


def surface(scene, mesh_samples: int, bounce, hit, o, d, active,
            throughput, radiance, last_pdf, last_delta,
            mode: str = FULL, draw: DrawIn | None = None,
            rays=None) -> Surface:
    """surface_plain's result: the csrc/shade.cu surface kernel for CUDA
    tensors, the plain version for CPU tensors. On the card the kernel
    works in place: it adds the emission into `radiance` (the thin and
    full forms on the lanes active at the hit), the thin form clears
    `active`, and the full form's draw (`draw`, required there) applies
    the cut and the roulette to `active` and `throughput` and advances
    `draw.rng`; the returned Surface holds
    those tensors. The decoded hit is written on the lanes active at the
    hit (the direct form: every lane), a light sample and its shadow ray
    where the ray is traced, the shadow lanes everywhere. The full form
    adds the shadow rays it sets to `rays` (an int64 device scalar) where
    given."""
    if mode == FULL and draw is None:
        raise ValueError("the full form draws the bounce's light samples: "
                         "it needs a DrawIn")
    if _device_kind(d) == "cpu":
        return surface_plain(scene, mesh_samples, bounce, hit, o, d, active,
                             throughput, radiance, last_pdf, last_delta,
                             mode, draw, rays)
    lib = native.shade_lib()
    n, dev = d.shape[0], d.device
    f32, b8, keep = torch.float32, torch.bool, []
    two_level = hit.inst is not None and scene.tlas is not None
    vec = lambda *lead: torch.empty((*lead, n, 3), dtype=f32, device=dev)
    lane = lambda dt=f32, *lead: torch.empty((*lead, n), dtype=dt,
                                             device=dev)
    outs = [None] * 11
    if mode != THIN:
        outs = [vec() for _ in range(6)] + [lane(torch.int32), vec(),
                                            lane(), lane(), lane()]
    draw_on = mode == FULL
    counted = draw_on and rays is not None
    if scene.tri_shade.data_ptr() % 16:
        raise ValueError("the surface kernel reads material rows as float4: "
                         "tri_shade must be 16-byte aligned")
    atlas = scene.mat_atlas
    bsdf, em = atlas.bsdf.data, atlas.emissive.data
    inst_tf = inst_inv = None
    if two_level:
        inst_tf, inst_inv = scene.inst_tf, scene.tlas.inst_inv
    reads_state = mode != DIRECT
    n_samples = draw.env_samples + mesh_samples if draw_on else 0
    samples = [None] * 7
    env_args = (None, None, None, 0, 0.0)
    em_args = (None, 0, None, None, 0, 0)
    if draw_on:
        if scene.emitters.rows.shape[0] == 0:
            raise ValueError("the light draw needs an emitter row")
        samples = [vec(n_samples), vec(n_samples), lane(f32, n_samples),
                   vec(n_samples), vec(n_samples), lane(f32, n_samples),
                   lane(b8, n_samples)]
        env = draw.env
        env_args = (_env_args(keep, env)[0], _ptr(keep, env.select, f32),
                    _ptr(keep, env.alias, torch.int64), env.size,
                    _reciprocal(env.integral, 1e-30))
        emitters = scene.emitters
        em_args = (_ptr(keep, emitters.rows, f32), emitters.rows.shape[0],
                   _ptr(keep, emitters.select, f32),
                   _ptr(keep, emitters.alias, torch.int64),
                   max(emitters.count, 1), int(emitters.count == 0))
    _launch(
        "surface", lib.surface, dev, _MODE_CODES[mode], int(two_level),
        _ptr(keep, scene.tri_shade, f32), scene.num_tris,
        _ptr(keep, inst_tf, f32), _ptr(keep, inst_inv, f32),
        0 if inst_tf is None else inst_tf.shape[0],
        _ptr(keep, bsdf, torch.bfloat16), atlas.bsdf.width, bsdf.shape[0],
        _ptr(keep, em, torch.bfloat16), atlas.emissive.width, em.shape[0],
        int(atlas.bsdf_constant), int(atlas.emissive_constant),
        int(atlas.normals_flat), mesh_samples,
        _reciprocal(scene.emitters.weight_sum, 1e-20),
        _ptr(keep, hit.tri, torch.int32), _ptr(keep, hit.u, f32),
        _ptr(keep, hit.v, f32),
        _ptr(keep, hit.inst if two_level else None, torch.int32),
        _ptr(keep, o if reads_state else None, f32), _ptr(keep, d, f32),
        _inplace(active, b8),
        _inplace(throughput, f32) if reads_state else None,
        _inplace(radiance, f32),
        _ptr(keep, last_pdf if reads_state else None, f32),
        _ptr(keep, last_delta if reads_state else None, torch.bool),
        _ptr(keep, _bounce_on(bounce, dev) if reads_state else None,
             torch.int64),
        n, *(None if x is None else x.data_ptr() for x in outs),
        draw.env_samples if draw_on else 0,
        draw.max_bounces if draw_on else 0,
        int(draw_on and draw.roulette),
        _inplace(draw.rng, torch.int64) if draw_on else None,
        *env_args, *em_args,
        *(None if x is None else x.data_ptr() for x in samples),
        _inplace(rays, torch.int64) if counted else None)
    if counted:
        count_launch(LAUNCHES, "counts")
    if mode == THIN:
        return Surface(None, None, None, None, None, radiance, active)
    position, tri_n, fn, fs, ft, w_o_ss, mtype, color, metal, alpha, ior = \
        outs
    mat = B.MaterialLanes(type=mtype, color=color, metalness=metal,
                          alpha=alpha, ior=ior)
    surf = Surface(position, tri_n, Frame(n=fn, s=fs, t=ft), w_o_ss, mat,
                   radiance, active)
    if not draw_on:  # the direct form
        return surf
    lights = shadow = None
    if n_samples:
        l_dir, l_rad, l_pdf, sh_o, sh_d, sh_t, sh_lane = samples
        lights = Lights(l_dir, l_rad, l_pdf, sh_lane, None,
                        draw.env_samples, mesh_samples)
        shadow = Shadow(sh_o.view(-1, 3), sh_d.view(-1, 3), sh_t.view(-1),
                        sh_lane.view(-1))
    return surf._replace(throughput=throughput, rng=draw.rng, lights=lights,
                         shadow=shadow)


def _inplace(x, dtype):
    """x's device pointer for a kernel that writes x in place: x must be
    contiguous, of `dtype`."""
    if x.dtype != dtype or not x.is_contiguous():
        raise TypeError(f"shading kernel updates in place a contiguous "
                        f"{dtype} tensor, got {x.dtype} (contiguous: "
                        f"{x.is_contiguous()})")
    return x.data_ptr()


def scatter(surf: Surface, o, d, throughput, radiance, rng, active,
            lights: Lights | None, state: dict, live=None) -> dict:
    """scatter_plain's result: the csrc/shade.cu scatter kernel for CUDA
    tensors, the plain version for CPU tensors. On the card the kernel
    updates o, d, throughput, radiance and rng in place and writes the
    new active, last_pdf and last_delta into `state`'s tensors of those
    names: a lane inactive on entry writes its active
    alone (its light lanes are clear, as the draw leaves them), a lane
    whose path ends no ray or throughput. It adds the lanes it leaves live
    to `live` (an int64 device scalar) where given."""
    if _device_kind(d) == "cpu":
        return scatter_plain(surf, o, d, throughput, radiance, rng, active,
                             lights, state, live)
    lib = native.shade_lib()
    n, dev = d.shape[0], d.device
    f32, b8, keep = torch.float32, torch.bool, []
    mat, frame = surf.mat, surf.frame
    env_samples = mesh_samples = 0
    light_ptrs = [None] * 5
    if lights is not None:
        env_samples, mesh_samples = lights.env_samples, lights.mesh_samples
        light_ptrs = [_ptr(keep, lights.dir, f32),
                      _ptr(keep, lights.radiance, f32),
                      _ptr(keep, lights.pdf, f32), _ptr(keep, lights.lane, b8),
                      _ptr(keep, lights.occluded, b8)]
    _launch(
        "scatter", lib.scatter, dev, _ptr(keep, mat.type, torch.int32),
        _ptr(keep, mat.color, f32), _ptr(keep, mat.metalness, f32),
        _ptr(keep, mat.alpha, f32), _ptr(keep, mat.ior, f32),
        _ptr(keep, frame.n, f32), _ptr(keep, frame.s, f32),
        _ptr(keep, frame.t, f32), _ptr(keep, surf.w_o_ss, f32),
        _ptr(keep, surf.position, f32), _ptr(keep, surf.tri_n, f32),
        _ptr(keep, active, b8), *light_ptrs, env_samples, mesh_samples, n,
        _inplace(state["active"], b8), _inplace(o, f32), _inplace(d, f32),
        _inplace(throughput, f32), _inplace(radiance, f32),
        _inplace(state["last_pdf"], f32), _inplace(state["last_delta"], b8),
        _inplace(rng, torch.int64),
        None if live is None else _inplace(live, torch.int64))
    if live is not None:
        count_launch(LAUNCHES, "counts")
    return dict(active=state["active"], o=o, d=d, throughput=throughput,
                radiance=radiance, last_pdf=state["last_pdf"],
                last_delta=state["last_delta"], rng=rng)


def _env_args(keep, env):
    if env.rgbl.data_ptr() % 16:
        raise ValueError("the env kernels read rgbl rows as float4: it must "
                         "be 16-byte aligned")
    return (_ptr(keep, env.rgbl, torch.float32), env.size,
            _reciprocal(env.integral, 1e-30))


def env_miss(env, env_samples: int, bounce, d, active, tri, throughput,
             radiance, last_pdf, last_delta):
    """env_miss_plain's (radiance, active): the csrc/shade.cu miss kernel
    for CUDA tensors, in place on `radiance` and `active` (a lane that
    missed adds its env radiance and clears its mask bit; no other lane
    is written), which it returns; the plain version for CPU tensors."""
    if _device_kind(d) == "cpu":
        return env_miss_plain(env, env_samples, bounce, d, active, tri,
                              throughput, radiance, last_pdf, last_delta)
    lib = native.shade_lib()
    f32, keep = torch.float32, []
    rgbl, size, inv_integral = _env_args(keep, env)
    _launch("env_miss", lib.env_miss, d.device, rgbl, size, inv_integral,
            env_samples, _ptr(keep, d, f32), _ptr(keep, tri, torch.int32),
            _ptr(keep, throughput, f32), _ptr(keep, last_pdf, f32),
            _ptr(keep, last_delta, torch.bool),
            _ptr(keep, _bounce_on(bounce, d.device), torch.int64),
            d.shape[0], _inplace(active, torch.bool), _inplace(radiance, f32))
    return radiance, active


def env_draw(env, rand2):
    """env_draw_plain's result: the csrc/shade.cu draw kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _device_kind(rand2) == "cpu":
        return env_draw_plain(env, rand2)
    lib = native.shade_lib()
    n, dev, keep = rand2.shape[0], rand2.device, []
    f32 = torch.float32
    out = (torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty(n, dtype=f32, device=dev))
    rgbl, size, inv_integral = _env_args(keep, env)
    _launch("env_draw", lib.env_draw, dev, rgbl,
            _ptr(keep, env.select, f32), _ptr(keep, env.alias, torch.int64),
            size, inv_integral, _ptr(keep, rand2, f32), n,
            *(x.data_ptr() for x in out))
    return out
