"""The bounce's shading: the surface decode, the environment lookups and
the BSDF scatter of one bounce segment, each a kernel of csrc/shade.cu
(the reference's bounce as XLA fuses it around its gathers,
moonshine_tpu/integrator/path.py:371-623, and the role of its
core/gather.py: each per-hit table fetch next to the math that consumes
it).

`surface`, `scatter`, `env_miss` and `env_draw` launch their kernel for
CUDA tensors, on the tensors' card and its current stream (so a CUDA
graph captures them), reading the bounce index from device memory; for
CPU tensors they run their plain version (`*_plain`), the integrator's
torch code moved behind one function each with the kernel's inputs and
outputs. There is no fallback: a failed build or launch raises. The
kernels equal the plain versions bit for bit on the card. Each wrapper
adds one to LAUNCHES[its name] where it launches (into a capture's tally
while a graph is captured, as accel/packet.py's wrappers do).

The plain versions' helpers (`_decode_hit`, `_decode_material`,
`_inst_world`, ...) port the reference's of the same names.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..accel import native, packet
from ..bsdf import materials as B
from ..core import rng as R
from ..core.frame import Frame, cos_theta
from ..core.mathutil import (
    cross,
    dot,
    face_forward,
    normalize,
    offset_along_normal,
    safe_normalize,
)
from ..lights.envmap import (
    envmap_incoming_radiance,
    miss_radiance_and_pdf,
    sample_envmap,
)
from ..lights.mesh_lights import area_to_solid_angle
from ..scene import textures as TX
from ..scene.textures import sample_material_block

# the surface kernel's forms: a bounce's, the last segment's (emission
# only; every lane dies) and the direct integrator's
FULL, THIN, DIRECT = "full", "thin", "direct"
_MODE_CODES = {FULL: 0, THIN: 1, DIRECT: 2}

LAUNCHES = {"surface": 0, "scatter": 0, "env_miss": 0, "env_draw": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Surface(NamedTuple):
    """The decoded hit: position, the geometric normal, the shading
    frame, w_o in it, the material, the radiance with the hit's emission
    added, and the lanes live after the segment (the thin form: none; it
    leaves the others None)."""

    position: torch.Tensor | None  # [N, 3]
    tri_n: torch.Tensor | None  # [N, 3]
    frame: Frame | None
    w_o_ss: torch.Tensor | None  # [N, 3]
    mat: B.MaterialLanes | None
    radiance: torch.Tensor  # [N, 3]
    active: torch.Tensor  # [N] bool


class Light(NamedTuple):
    """One NEE sample of a bounce, with its shadow ray's answer."""

    dir: torch.Tensor  # [N, 3] world-space direction to the light
    radiance: torch.Tensor  # [N, 3]
    pdf: torch.Tensor  # [N] solid-angle pdf before occlusion
    lane: torch.Tensor  # [N] bool: the shadow ray was traced
    occluded: torch.Tensor  # [N] bool
    n_samples: int  # the samples a bounce draws of this light's kind


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
    corners_w = torch.einsum("nij,nkj->nki", lin, corners) + tf[:, None, 9:12]
    nrms_w = None
    if nrms is not None:
        nrm_m = scene.tlas.inst_inv[k][:, :9].reshape(-1, 3, 3)
        nrms_w = safe_normalize(torch.einsum("nji,nkj->nki", nrm_m, nrms))
    return corners_w, nrms_w, tf[:, 12]


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


# ---- the plain versions

def surface_plain(scene, mesh_samples: int, bounce, hit, o, d, active,
                  throughput, radiance, last_pdf, last_delta,
                  mode: str = FULL) -> Surface:
    """Decode each lane's hit (masked lanes read clamped junk rows), pick
    its shading frame and add its emission (integrator.hlsl:93-124;
    reference path.py:424-485). THIN: the last segment's decode and
    emission, after which every lane dies. DIRECT: the direct
    integrator's (integrator.hlsl:199-215): the normal-mapped frame
    always, picked without the front-face sign, and the emission of every
    hit lane; it reads none of o, throughput, last_pdf, last_delta and
    bounce. `bounce` is an int or a device scalar."""
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
    return Surface(position, tri_n, frame, w_o_ss, mat, radiance, active)


def scatter_plain(surf: Surface, o, d, throughput, radiance, rng, active,
                  lights) -> dict:
    """Weight each NEE sample (`lights`, Light tuples in draw order) by
    the power heuristic and add it (integrator.hlsl:139-151), then draw
    the BSDF sample and continue the path (:153-163; reference
    path.py:518-623). Returns the lane state's new active, o, d,
    throughput, radiance, last_pdf, last_delta and rng."""
    mat, frame, w_o_ss = surf.mat, surf.frame, surf.w_o_ss
    is_delta = B.is_delta(mat.type)
    for light in lights:
        l_pdf = torch.where(light.occluded, 0.0, light.pdf)
        w_i_ss = frame.world_to_frame(light.dir)
        brdf, scatter_pdf = B.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
        n_samples = light.n_samples
        mis = power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
        contrib = light.radiance * brdf * (
            torch.abs(cos_theta(w_i_ss)) * mis
            / torch.clamp_min(l_pdf, 1e-30))[..., None]
        ok = light.lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
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
    path.py:424-436). Returns the radiance."""
    miss = active & ~(tri >= 0)
    env_plain = last_delta | (bounce == 0) | (env_samples == 0)
    if env_samples > 0:
        env_rad, rad_e, pdf_e = miss_radiance_and_pdf(env, d)
        w = power_heuristic(1.0, last_pdf, env_samples, pdf_e)
        radiance = radiance + _masked(miss & ~env_plain & (pdf_e > 0.0),
                                      throughput * rad_e * w[..., None])
    else:
        env_rad = envmap_incoming_radiance(env, d)
    return radiance + _masked(miss & env_plain, throughput * env_rad)


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
    rc = packet._call_on(fn, device, *args)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    packet.count_launch(LAUNCHES, key)


def surface(scene, mesh_samples: int, bounce, hit, o, d, active,
            throughput, radiance, last_pdf, last_delta,
            mode: str = FULL) -> Surface:
    """surface_plain's result: the csrc/shade.cu surface kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _device_kind(d) == "cpu":
        return surface_plain(scene, mesh_samples, bounce, hit, o, d, active,
                             throughput, radiance, last_pdf, last_delta,
                             mode)
    lib = native.shade_lib()
    n, dev = d.shape[0], d.device
    f32, keep = torch.float32, []
    two_level = hit.inst is not None and scene.tlas is not None
    vec = lambda: torch.empty((n, 3), dtype=f32, device=dev)
    lane = lambda dt=f32: torch.empty(n, dtype=dt, device=dev)
    rad_out = vec()
    if mode == THIN:
        outs = [None] * 11
        act_out = lane(torch.bool)
    else:
        outs = [vec() for _ in range(6)] + [lane(torch.int32), vec(),
                                            lane(), lane(), lane()]
        act_out = None
    atlas = scene.mat_atlas
    bsdf, em = atlas.bsdf.data, atlas.emissive.data
    inst_tf = inst_inv = None
    if two_level:
        inst_tf, inst_inv = scene.inst_tf, scene.tlas.inst_inv
    reads_state = mode != DIRECT
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
        _ptr(keep, active, torch.bool),
        _ptr(keep, throughput if reads_state else None, f32),
        _ptr(keep, radiance, f32),
        _ptr(keep, last_pdf if reads_state else None, f32),
        _ptr(keep, last_delta if reads_state else None, torch.bool),
        _ptr(keep, _bounce_on(bounce, dev) if reads_state else None,
             torch.int64),
        n, *(None if x is None else x.data_ptr() for x in outs),
        rad_out.data_ptr(), None if act_out is None else act_out.data_ptr())
    if mode == THIN:
        return Surface(None, None, None, None, None, rad_out, act_out)
    position, tri_n, fn, fs, ft, w_o_ss, mtype, color, metal, alpha, ior = \
        outs
    mat = B.MaterialLanes(type=mtype, color=color, metalness=metal,
                          alpha=alpha, ior=ior)
    return Surface(position, tri_n, Frame(n=fn, s=fs, t=ft), w_o_ss, mat,
                   rad_out, active)


def scatter(surf: Surface, o, d, throughput, radiance, rng, active,
            lights) -> dict:
    """scatter_plain's result: the csrc/shade.cu scatter kernel for CUDA
    tensors, the plain version for CPU tensors. A launch weighs at most
    `max_lights` NEE samples; a bounce with more weighs the rest first,
    in order, in launches that add to the radiance alone."""
    if _device_kind(d) == "cpu":
        return scatter_plain(surf, o, d, throughput, radiance, rng, active,
                             lights)
    lib = native.shade_lib()
    n, dev = d.shape[0], d.device
    f32, b8 = torch.float32, torch.bool
    mat, frame = surf.mat, surf.frame
    k = lib.max_lights
    chunks = [lights[i:i + k] for i in range(0, len(lights), k)] or [[]]
    for j, chunk in enumerate(chunks):
        keep, ptrs = [], []
        for light in chunk:
            ptrs += [_ptr(keep, light.dir, f32),
                     _ptr(keep, light.radiance, f32),
                     _ptr(keep, light.pdf, f32), _ptr(keep, light.lane, b8),
                     _ptr(keep, light.occluded, b8)]
        c_ptrs = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
        c_counts = (ctypes.c_int * max(len(chunk), 1))(
            *(light.n_samples for light in chunk))
        last = j == len(chunks) - 1
        out = dict(radiance=torch.empty_like(radiance))
        if last:
            out = dict(active=torch.empty(n, dtype=b8, device=dev),
                       o=torch.empty_like(o), d=torch.empty_like(d),
                       throughput=torch.empty_like(throughput),
                       radiance=out["radiance"],
                       last_pdf=torch.empty(n, dtype=f32, device=dev),
                       last_delta=torch.empty(n, dtype=b8, device=dev),
                       rng=torch.empty_like(rng))
        outs = [out.get(name) for name in (
            "active", "o", "d", "throughput", "radiance", "last_pdf",
            "last_delta", "rng")]
        _launch(
            "scatter", lib.scatter, dev, _ptr(keep, mat.type, torch.int32),
            _ptr(keep, mat.color, f32), _ptr(keep, mat.metalness, f32),
            _ptr(keep, mat.alpha, f32), _ptr(keep, mat.ior, f32),
            _ptr(keep, frame.n, f32), _ptr(keep, frame.s, f32),
            _ptr(keep, frame.t, f32), _ptr(keep, surf.w_o_ss, f32),
            _ptr(keep, surf.position, f32), _ptr(keep, surf.tri_n, f32),
            _ptr(keep, o, f32), _ptr(keep, d, f32),
            _ptr(keep, throughput, f32), _ptr(keep, radiance, f32),
            _ptr(keep, rng, torch.int64), _ptr(keep, active, b8),
            len(chunk), c_ptrs, c_counts, int(last), n,
            *(None if x is None else x.data_ptr() for x in outs))
        radiance = out["radiance"]
    return out


def _env_args(keep, env):
    if env.rgbl.data_ptr() % 16:
        raise ValueError("the env kernels read rgbl rows as float4: it must "
                         "be 16-byte aligned")
    return (_ptr(keep, env.rgbl, torch.float32), env.size,
            _reciprocal(env.integral, 1e-30))


def env_miss(env, env_samples: int, bounce, d, active, tri, throughput,
             radiance, last_pdf, last_delta):
    """env_miss_plain's result: the csrc/shade.cu miss kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _device_kind(d) == "cpu":
        return env_miss_plain(env, env_samples, bounce, d, active, tri,
                              throughput, radiance, last_pdf, last_delta)
    lib = native.shade_lib()
    f32, keep = torch.float32, []
    out = torch.empty_like(radiance)
    rgbl, size, inv_integral = _env_args(keep, env)
    _launch("env_miss", lib.env_miss, d.device, rgbl, size, inv_integral,
            env_samples, _ptr(keep, d, f32), _ptr(keep, active, torch.bool),
            _ptr(keep, tri, torch.int32), _ptr(keep, throughput, f32),
            _ptr(keep, radiance, f32), _ptr(keep, last_pdf, f32),
            _ptr(keep, last_delta, torch.bool),
            _ptr(keep, _bounce_on(bounce, d.device), torch.int64),
            d.shape[0], out.data_ptr())
    return out


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
