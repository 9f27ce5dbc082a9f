"""The bounce's shading (integrator/shade.py) on the CPU, where each
wrapper runs its plain version: each plain version against
moonshine_tpu's functions on the same seeded inputs (both packages read
the JAX scene's arrays, bridged with scene_from_arrays), and the port's
render bit for bit what the integrator rendered before its shading moved
behind those functions.

- surface: `_decode_hit` / `_decode_hit_thin` / `_decode_material` /
  `_inst_world` with the reference's shading-normal selection and
  emissive accumulation (its path.py:424-485, direct.py:56-77), on the
  flagship (textured atlas, every material), the room (constant atlas)
  and an instanced scene built two-level (a mirroring instance);
- scatter: the reference's light weighting and scatter (path.py:583-623:
  eval_pdf_bsdf, the power heuristic, sample_bsdf, eval_bsdf) for every
  material type, and its weight-only form against the direct
  integrator's weighting (direct.py:89-100: pdf_bsdf, eval_bsdf, the
  power heuristic);
- the light draws: the full form's against the path's (path.py:503-573)
  and the direct form's against the direct integrator's (direct.py:79-86
  with :103-124);
- env: miss_radiance_and_pdf / envmap_incoming_radiance with the miss
  weighting (path.py:404-419), and the direct form's env draw against
  sample_envmap, at size 1 and 32.

Tolerance rtol 1e-5, atol 1e-5 (positions and radiance of order 10:
1e-6 relative): the frameworks' transcendental functions and fused
multiply-adds differ in the last bits, and normalisations, GGX and
Fresnel terms amplify that; the scattered pdf and throughput of glossy
lanes by GGX's condition (`_close_glossy`). The masks (live lanes,
shading-frame picks, scatter validity) agree exactly on every lane.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.bsdf import materials as JB
from moonshine_tpu.core import rng as JR
from moonshine_tpu.core.frame import Frame as JFrame
from moonshine_tpu.core.frame import cos_theta as j_cos_theta
from moonshine_tpu.core.mathutil import dot as jdot
from moonshine_tpu.core.mathutil import face_forward as j_face_forward
from moonshine_tpu.core.mathutil import normalize as j_normalize
from moonshine_tpu.core.mathutil import offset_along_normal as j_offset
from moonshine_tpu.integrator import path as JP
from moonshine_tpu.lights import envmap as JE
from moonshine_tpu.lights.mesh_lights import area_to_solid_angle as j_a2s
from moonshine_tpu.scene import procedural as JPr
from moonshine_tpu_torch.bsdf import materials as PB
from moonshine_tpu_torch.core.frame import Frame as PFrame
from moonshine_tpu_torch.integrator import shade
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.lights import envmap as PE
from moonshine_tpu_torch.render import renderer as RR
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene.world import scene_from_arrays

from test_torch_scene import jax_scene_arrays
from test_torch_tlas import jax_tlas_arrays, jax_world, two_level
from torch_light_world import LIGHTS, light_world

TOL = dict(rtol=1e-5, atol=1e-5)
N = 2048


def _close(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX DeviceScene, the port's scene on its arrays)."""
    from __graft_entry__ import _flagship_scene

    out = {}
    js = _flagship_scene()[0]
    out["flagship"] = js, scene_from_arrays(*jax_scene_arrays(js), "cpu")
    for name, textured in (("room", True), ("room_constant", False)):
        js = JPr.room_scene(grid=2, subdivisions=2,
                            textured=textured)[0].build()
        out[name] = js, scene_from_arrays(*jax_scene_arrays(js), "cpu")
    js = two_level(jax_world(n=6, mirrored=True, hidden=4).build)
    out["instanced"] = js, scene_from_arrays(*jax_tlas_arrays(js), "cpu")
    return out


def _lanes(num_tris, num_inst, n, seed):
    """Seeded numpy lane state: hits (a sixth missed: tri -1, u = v = 0),
    instances, rays, throughput, radiance, last_pdf and last_delta; a
    third of the hit lanes dead."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    tri = rs.randint(0, num_tris, n).astype(np.int32)
    miss = rs.rand(n) < 1 / 6
    tri[miss] = -1
    u = rs.rand(n).astype(f32)
    v = (rs.rand(n) * (1 - u)).astype(f32)
    u[miss] = v[miss] = 0.0
    inst = rs.randint(0, max(num_inst, 1), n).astype(np.int32)
    inst[miss] = -1
    d = rs.randn(n, 3).astype(f32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    last_pdf = (rs.rand(n) * 3).astype(f32)
    last_pdf[rs.rand(n) < 0.1] = 0.0
    return dict(tri=tri, u=u, v=v, inst=inst if num_inst else None,
                o=(rs.randn(n, 3) * 4).astype(f32), d=d,
                active=(rs.rand(n) > 0.33) & ~miss,
                throughput=rs.rand(n, 3).astype(f32),
                radiance=rs.rand(n, 3).astype(f32), last_pdf=last_pdf,
                last_delta=rs.rand(n) < 0.2)


def _port_hit(lanes):
    from moonshine_tpu_torch.accel.tlas import TlasHit

    t = lambda k: None if lanes[k] is None else torch.from_numpy(lanes[k])
    return TlasHit(t=torch.zeros(len(lanes["tri"])), tri=t("tri"), u=t("u"),
                   v=t("v"), inst=t("inst"))


def _ref_surface(js, mesh_samples, bounce, lanes, mode):
    """The reference's surface stage (path.py:424-485; the direct
    integrator's, direct.py:56-77) on numpy lanes."""
    n_tris = js.tri_shade.shape[0]
    tri = jnp.clip(jnp.asarray(lanes["tri"]), 0, n_tris - 1)
    u, v = jnp.asarray(lanes["u"]), jnp.asarray(lanes["v"])
    inst = None if lanes["inst"] is None else jnp.asarray(lanes["inst"])
    d = jnp.asarray(lanes["d"])
    active = jnp.asarray(lanes["active"])
    w_o_ws = -d
    out = {}
    if mode == shade.THIN:
        position, uv, tri_n, mat_row, sampled = JP._decode_hit_thin(
            js, tri, u, v, inst=inst)
        emissive = JP._decode_emissive(js, mat_row, uv)
    else:
        position, uv, tri_frame, vtx_frame, mat_row, sampled = (
            JP._decode_hit(js, tri, u, v, inst=inst))
        mat, emissive, normal_rg = JP._decode_material(js, mat_row, uv)
        tri_n = tri_frame.n
        sgn = 1.0
        if mode != shade.DIRECT:
            sgn = jnp.where(jdot(tri_frame.n, w_o_ws, keepdims=False) > 0.0,
                            1.0, -1.0)
        vtx_ok = sgn * jdot(w_o_ws, vtx_frame.n, keepdims=False) > 0.0
        if mode != shade.DIRECT and js.mat_atlas.normals_flat:
            tex_frame, tex_ok = vtx_frame, jnp.zeros_like(vtx_ok)
        else:
            tex_frame = JP._texture_frame(normal_rg, vtx_frame)
            tex_ok = sgn * jdot(w_o_ws, tex_frame.n, keepdims=False) > 0.0
        pick = lambda a, b, c: jnp.where(
            tex_ok[..., None], a, jnp.where(vtx_ok[..., None], b, c))
        frame = JFrame(n=pick(tex_frame.n, vtx_frame.n, tri_frame.n),
                       s=pick(tex_frame.s, vtx_frame.s, tri_frame.s),
                       t=pick(tex_frame.t, vtx_frame.t, tri_frame.t))
        out = dict(position=position, tri_n=tri_n, n=frame.n, s=frame.s,
                   t=frame.t, w_o_ss=frame.world_to_frame(w_o_ws),
                   type=mat.type, color=mat.color, metalness=mat.metalness,
                   alpha=mat.alpha, ior=mat.ior, tex_ok=tex_ok,
                   vtx_ok=vtx_ok)
    radiance = jnp.asarray(lanes["radiance"])
    if mode == shade.DIRECT:
        out["radiance"] = radiance + jnp.where(active[..., None], emissive,
                                               0.0)
        return out
    thr = jnp.asarray(lanes["throughput"])
    emit_plain = ((mesh_samples == 0) | (bounce == 0) | ~sampled
                  | jnp.asarray(lanes["last_delta"]))
    emit_front = jdot(w_o_ws, tri_n, keepdims=False) > 0.0
    radiance = radiance + jnp.where(
        (active & emit_plain & emit_front)[..., None], thr * emissive, 0.0)
    if mesh_samples > 0:
        light_pdf = j_a2s(position, jnp.asarray(lanes["o"]), d, tri_n) / (
            jnp.maximum(js.emitters.weight_sum, 1e-20))
        w = JP.power_heuristic(1.0, jnp.asarray(lanes["last_pdf"]),
                               mesh_samples, light_pdf)
        radiance = radiance + jnp.where(
            (active & ~emit_plain & (light_pdf > 0.0))[..., None],
            thr * emissive * w[..., None], 0.0)
    out["radiance"] = radiance
    return out


def _surface(ps, mesh_samples, bounce, lanes, mode):
    """The port's surface on `lanes`; the full form with a draw of no
    env sample, no roulette and no cut, which leaves the decode, the
    emission and the mask as they are; the direct form with a draw of no
    sample."""
    t = lambda k: torch.from_numpy(lanes[k])
    draw = None
    if mode != shade.THIN:
        rng = np.random.RandomState(bounce).randint(0, 2**32, len(lanes["d"]))
        draw = shade.DrawIn(ps.env, 0, bounce + 1, False,
                            torch.from_numpy(rng.astype(np.int64)))
    if mode == shade.DIRECT:
        mesh_samples = 0
    return shade.surface(ps, mesh_samples, torch.tensor(bounce),
                         _port_hit(lanes), t("o"), t("d"), t("active"),
                         t("throughput"), t("radiance"), t("last_pdf"),
                         t("last_delta"), mode, draw)


@pytest.mark.parametrize("name", ["flagship", "room", "room_constant",
                                  "instanced"])
@pytest.mark.parametrize("mode", [shade.FULL, shade.THIN, shade.DIRECT])
def test_surface_matches_reference(scenes, name, mode):
    """surface_plain against the reference's decode, frame selection and
    emission, at bounce 0 and 2 with one mesh-light sample a bounce and
    with none: the flagship and the room with textured atlases, the
    untextured room and the instanced scene with constant ones."""
    js, ps = scenes[name]
    assert (ps.tlas is not None) == (name == "instanced")
    assert ps.mat_atlas.bsdf_constant == (name in ("room_constant",
                                                   "instanced"))
    lanes = _lanes(ps.num_tris, 0 if ps.tlas is None else
                   ps.inst_tf.shape[0], N, 23)
    for bounce, mesh_samples in ((0, 1), (2, 1), (2, 0)):
        got = _surface(ps, mesh_samples, bounce, lanes, mode)
        want = _ref_surface(js, mesh_samples, bounce, lanes, mode)
        what = f"{name} {mode} bounce {bounce}"
        _close(got.radiance, want["radiance"], f"{what} radiance")
        if mode == shade.THIN:
            assert not bool(got.active.any())
            continue
        assert bool(torch.equal(got.active, torch.from_numpy(
            lanes["active"])))
        for key, val in (("position", got.position), ("tri_n", got.tri_n),
                         ("n", got.frame.n), ("s", got.frame.s),
                         ("t", got.frame.t), ("w_o_ss", got.w_o_ss),
                         *((k, getattr(got.mat, k))
                           for k in PB.MaterialLanes._fields)):
            _close(val, want[key], f"{what} {key}")
    if name == "flagship" and mode != shade.THIN:
        # the cases reach every material and every leg of the selection
        assert set(want["type"].tolist()) == {0, 1, 2, 3}
        assert bool(want["vtx_ok"].any()) and bool((~want["vtx_ok"]).any())
        # the flagship's normal maps are flat: only the direct form builds
        # the texture frame
        assert bool(want["tex_ok"].any()) == (mode == shade.DIRECT)
    if name == "instanced":
        assert bool((ps.inst_tf[:, 12] < 0).any())  # a mirroring instance


def _ref_scatter(mat, frame, w_o_ss, position, tri_n, o, d, thr, rad, rng,
                 active, lights):
    """The reference's light weighting and scatter (path.py:583-623)."""
    for l_dir, l_rad, l_pdf, lane, occluded, n_samples in lights:
        l_pdf = jnp.where(occluded, 0.0, l_pdf)
        w_i_ss = frame.world_to_frame(l_dir)
        brdf, scatter_pdf = JB.eval_pdf_bsdf(mat, w_i_ss, w_o_ss)
        mis = JP.power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
        contrib = l_rad * brdf * (jnp.abs(j_cos_theta(w_i_ss)) * mis
                                  / jnp.maximum(l_pdf, 1e-30))[..., None]
        ok = lane & (l_pdf > 0.0) & (scatter_pdf > 0.0)
        rad = rad + jnp.where(ok[..., None], thr * contrib / n_samples, 0.0)
    rng, r2 = JR.next_float2(rng)
    w_i_ss, pdf = JB.sample_bsdf(mat, w_o_ss, r2)
    active = active & (pdf > 0.0)
    new_d = j_normalize(frame.frame_to_world(w_i_ss))
    new_o = j_offset(position, j_face_forward(tri_n, new_d))
    f = JB.eval_bsdf(mat, w_i_ss, w_o_ss)
    thr_mul = f * (jnp.abs(j_cos_theta(w_i_ss))
                   / jnp.maximum(pdf, 1e-30))[..., None]
    act = active[..., None]
    return dict(active=active, o=jnp.where(act, new_o, o),
                d=jnp.where(act, new_d, d),
                throughput=jnp.where(act, thr * thr_mul, thr),
                radiance=rad, last_pdf=pdf, last_delta=JB.is_delta(mat.type),
                rng=rng)


def scatter_case(mat_type):
    """test_scatter_matches_reference's seeded lanes of one material
    type: (material fields, the frame's n, s, t, w_o in it, the light
    samples as (dir, radiance, pdf, lane, occluded, count), the lane
    state)."""
    rs = np.random.RandomState(31 + mat_type)
    f32 = np.float32
    n = N

    def unit(k=n):
        v = rs.randn(k, 3).astype(f32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    nrm = unit()
    s = unit()
    s = s - nrm * np.sum(nrm * s, axis=1, keepdims=True)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    t = np.cross(nrm, s).astype(f32)
    wo = unit()
    fields = dict(type=np.full(n, mat_type, np.int32),
                  color=rs.rand(n, 3).astype(f32),
                  metalness=rs.rand(n).astype(f32),
                  alpha=np.maximum(rs.rand(n) ** 2, 1e-3).astype(f32),
                  ior=(1.0 + rs.rand(n)).astype(f32))
    lights = []
    for k, count in enumerate((1, 2, 2)):
        pdf = (rs.rand(n) * 2).astype(f32)
        pdf[rs.rand(n) < 0.1] = 0.0
        lights.append((unit(), rs.rand(n, 3).astype(f32), pdf,
                       (rs.rand(n) > 0.2) & (pdf > 0), rs.rand(n) < 0.3,
                       count))
    state = dict(position=(rs.randn(n, 3) * 3).astype(f32), tri_n=unit(),
                 o=(rs.randn(n, 3) * 3).astype(f32), d=unit(),
                 thr=rs.rand(n, 3).astype(f32), rad=rs.rand(n, 3).astype(f32),
                 rng=rs.randint(0, 2**32, n).astype(np.uint32),
                 active=rs.rand(n) > 0.2)
    return fields, (nrm, s, t), wo, lights, state


@pytest.mark.parametrize("mat_type", [JB.GLASS, JB.LAMBERT, JB.MIRROR,
                                      JB.STANDARD_PBR])
def test_scatter_matches_reference(mat_type):
    """scatter_plain against the reference on seeded lanes of one
    material type: random frames, w_o, colours, metalness, roughness and
    ior; an env sample and two mesh samples (sample counts 1 and 2) with
    random lanes and occlusion."""
    fields, (nrm, s, t), wo, lights, state = scatter_case(mat_type)
    n = N
    P = torch.from_numpy
    surf = shade.Surface(
        position=P(state["position"]), tri_n=P(state["tri_n"]),
        frame=PFrame(n=P(nrm), s=P(s), t=P(t)), w_o_ss=P(wo),
        mat=PB.MaterialLanes(**{k: P(v) for k, v in fields.items()}),
        radiance=P(state["rad"]), active=P(state["active"]))
    stack = lambda j: P(np.stack([light[j] for light in lights]))
    got = shade.scatter(surf, P(state["o"]), P(state["d"]), P(state["thr"]),
                        surf.radiance, P(state["rng"].astype(np.int64)),
                        surf.active,
                        shade.Lights(stack(0), stack(1), stack(2), stack(3),
                                     stack(4), 1, 2), state={})
    J = jnp.asarray
    want = _ref_scatter(
        JB.MaterialLanes(**{k: J(v) for k, v in fields.items()}),
        JFrame(n=J(nrm), s=J(s), t=J(t)), J(wo), J(state["position"]),
        J(state["tri_n"]), J(state["o"]), J(state["d"]), J(state["thr"]),
        J(state["rad"]), J(state["rng"]), J(state["active"]),
        [tuple(J(x) if isinstance(x, np.ndarray) else x for x in light)
         for light in lights])
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        if k in ("throughput", "last_pdf"):
            _close_glossy(got[k].numpy(), w, fields["alpha"],
                          f"type {mat_type} {k}")
            continue
        _close(got[k], w.astype(np.int64) if k == "rng" else w,
               f"type {mat_type} {k}")
    assert 0 < int(got["active"].sum()) < n


@pytest.mark.parametrize("mat_type", [JB.GLASS, JB.LAMBERT, JB.MIRROR,
                                      JB.STANDARD_PBR])
def test_weigh_matches_reference(mat_type):
    """The scatter's weight-only form (weigh_plain, the direct
    integrator's) against the reference direct integrator's weighting
    (direct.py:89-100: pdf_bsdf and eval_bsdf apart, the power heuristic,
    contrib / n_samples at unit throughput) on scatter_case's lanes of one
    material type, its samples traced only on live lanes: the radiance to
    TOL; nothing else of the state is returned or changed."""
    fields, (nrm, s, t), wo, lights, state = scatter_case(mat_type)
    lights = [(l_dir, l_rad, pdf, lane & state["active"], occ, count)
              for l_dir, l_rad, pdf, lane, occ, count in lights]
    P, J = torch.from_numpy, jnp.asarray
    surf = shade.Surface(
        position=None, tri_n=None,
        frame=PFrame(n=P(nrm), s=P(s), t=P(t)), w_o_ss=P(wo),
        mat=PB.MaterialLanes(**{k: P(v) for k, v in fields.items()}),
        radiance=P(state["rad"]), active=P(state["active"]))
    stack = lambda j: P(np.stack([light[j] for light in lights]))
    rad_in = state["rad"].copy()
    got = shade.weigh(surf, surf.radiance, surf.active,
                      shade.Lights(stack(0), stack(1), stack(2), stack(3),
                                   stack(4), 1, 2))
    np.testing.assert_array_equal(state["rad"], rad_in)
    mat = JB.MaterialLanes(**{k: J(v) for k, v in fields.items()})
    frame = JFrame(n=J(nrm), s=J(s), t=J(t))
    want = J(state["rad"])
    for l_dir, l_rad, l_pdf, lane, occluded, n_samples in lights:
        l_pdf = jnp.where(J(occluded), 0.0, J(l_pdf))
        w_i_ss = frame.world_to_frame(J(l_dir))
        scatter_pdf = JB.pdf_bsdf(mat, w_i_ss, J(wo))
        brdf = JB.eval_bsdf(mat, w_i_ss, J(wo))
        mis = JP.power_heuristic(n_samples, l_pdf, 1.0, scatter_pdf)
        contrib = J(l_rad) * brdf * (jnp.abs(j_cos_theta(w_i_ss)) * mis
                                     / jnp.maximum(l_pdf, 1e-30))[..., None]
        ok = J(lane) & (l_pdf > 0.0) & (scatter_pdf > 0.0)
        want = want + jnp.where(ok[..., None], contrib / n_samples, 0.0)
    _close(got, want, f"type {mat_type} weighted radiance")
    added = (got.numpy() != state["rad"]).any(1)
    assert not added[~state["active"]].any()
    assert added.any() == (mat_type in (JB.LAMBERT, JB.STANDARD_PBR))


def _close_glossy(got, want, alpha, what):
    """The sampled direction's pdf and throughput pass through the GGX
    density at the sampled half vector, whose relative condition is
    2 / (alpha^2 + sin^2 theta_h) <= 2 / alpha^2 (test_torch_shading.py's
    test_bsdf): each lane is held to rtol max(1e-5, 2e-6 / alpha^2) (about
    16 float32 ulps times that condition), and 98% of lanes to the common
    bar."""
    rtol = np.maximum(1e-5, 2e-6 / alpha.astype(np.float64) ** 2)
    if got.ndim == 2:
        rtol = rtol[:, None]
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-5 + rtol * np.abs(want)).all(), what
    lanes = np.isclose(got, want, **TOL)
    assert (lanes.all(1) if lanes.ndim == 2 else lanes).mean() >= 0.98, what


# ---- the bounce's light draw (the full form with a draw)

@pytest.fixture(scope="module")
def light_scenes():
    """name -> (JAX DeviceScene, the port's scene on its arrays): the
    light panels' emission constant, textured, or not sampled
    (torch_light_world.py)."""
    from moonshine_tpu.scene import types as JTy
    from moonshine_tpu.scene.world import World

    out = {}
    for name in LIGHTS:
        js = light_world(JTy, World, name).build()
        out[name] = js, scene_from_arrays(*jax_scene_arrays(js), "cpu")
    return out


def _ref_draw(js, bounce, max_bounces, env_samples, mesh_samples, lanes):
    """The reference's termination and NEE draws (path.py:503-573) on
    numpy lanes: (active, throughput, rng, per sample (shadow o, d,
    t_max, lane, light dir, radiance, pdf))."""
    from moonshine_tpu.core.mathutil import luminance as j_luminance
    from moonshine_tpu.lights.mesh_lights import sample_mesh_lights

    J = jnp.asarray
    active = J(lanes["active"]) & (bounce < max_bounces + 1)
    throughput = J(lanes["throughput"])
    position, tri_n = J(lanes["position"]), J(lanes["tri_n"])
    rng, rr_rand = JR.next_float(J(lanes["rng"]))
    do_rr = bounce > 3
    p_survive = jnp.minimum(0.95, j_luminance(throughput))
    active = active & ~(do_rr & (rr_rand > p_survive))
    throughput = jnp.where((do_rr & active)[..., None],
                           throughput / jnp.maximum(p_survive, 1e-20)[
                               ..., None], throughput)
    nee_active = active & ~JB.is_delta(J(lanes["type"]))
    samples = []
    for _ in range(env_samples):
        rng, r2 = JR.next_float2(rng)
        l_dir, l_rad, l_pdf = JE.sample_envmap(js.env, r2)
        shadow_o = j_offset(position, j_face_forward(tri_n, l_dir))
        samples.append((shadow_o, l_dir, jnp.full_like(l_pdf, 1.0e12),
                        nee_active & (l_pdf > 0.0), l_dir, l_rad, l_pdf))
    for _ in range(mesh_samples):
        rng, r2 = JR.next_float2(rng)
        l_dir, l_pos, l_n, _, l_bary, l_pdf, l_row = sample_mesh_lights(
            js, position, r2)
        l_rad = JP._emissive_at(js, l_row, l_bary)
        off_light = j_offset(l_pos, l_n)
        off_shade = j_offset(position, j_face_forward(tri_n, l_dir))
        seg = off_light - off_shade
        seg_len = jnp.linalg.norm(seg, axis=-1)
        samples.append((off_shade, seg / jnp.maximum(seg_len, 1e-20)[
            ..., None], seg_len, nee_active & (l_pdf > 0.0), l_dir, l_rad,
            l_pdf))
    return active, throughput, rng, samples


@pytest.mark.parametrize("counts", [(1, 1), (2, 1), (1, 2), (0, 2),
                                    (2, 0)])
@pytest.mark.parametrize("roulette", [False, True])
@pytest.mark.parametrize("name", ["constant", "textured", "no_emitters"])
def test_draw_matches_reference(light_scenes, name, roulette, counts):
    """The full form's draw (_draw_plain: the cut, the roulette, each env
    and mesh light sample and its shadow ray) against the reference's
    on seeded lanes of the panels' scene (bounce 4 with the roulette, 2
    without; max_bounces 4): masks and PCG states exactly, the rest to
    TOL; the shadow batch in the samples' order (env first), each
    sample's lanes the reference's. The scene without emitters gives
    every mesh sample pdf 0 and no shadow ray."""
    js, ps = light_scenes[name]
    assert ps.mat_atlas.emissive_constant == (name != "textured")
    assert (ps.emitters.count == 0) == (name == "no_emitters")
    env_samples, mesh_samples = counts
    n = N
    rs = np.random.RandomState(61)
    f32 = np.float32
    lanes = _lanes(ps.num_tris, 0, n, 67)
    # shading points on the floor, below the panels, and random normals
    position = np.stack([rs.rand(n) * 6 - 3, rs.rand(n) * 6 - 3,
                         rs.rand(n) * 0.5], 1).astype(f32)
    tri_n = rs.randn(n, 3).astype(f32)
    tri_n /= np.linalg.norm(tri_n, axis=1, keepdims=True)
    lanes.update(position=position, tri_n=tri_n,
                 type=rs.randint(0, 4, n).astype(np.int32),
                 rng=rs.randint(0, 2**32, n).astype(np.uint32))
    bounce = 4 if roulette else 2
    P = torch.from_numpy
    surf = shade.Surface(P(position), P(tri_n), None, None,
                         PB.MaterialLanes(P(lanes["type"]), None, None, None,
                                          None), None, P(lanes["active"]))
    got = shade._draw_plain(
        ps, mesh_samples, torch.tensor(bounce), surf, P(lanes["throughput"]),
        shade.DrawIn(ps.env, env_samples, 4, roulette,
                     P(lanes["rng"].astype(np.int64))))
    active, throughput, rng, samples = _ref_draw(
        js, bounce, 4, env_samples, mesh_samples, lanes)
    what = f"{name} roulette {roulette} samples {counts}"
    _close(got.active, active, f"{what} active")
    _close(got.throughput, throughput, f"{what} throughput")
    _close(got.rng, np.asarray(rng).astype(np.int64), f"{what} rng")
    if roulette:
        assert 0 < int(got.active.sum()) < int(P(lanes["active"]).sum())
    s = len(samples)
    assert (got.shadow is None) == (s == 0) == (got.lights is None)
    if not s:
        return
    assert [got.lights.n_samples(k) for k in range(s)] == (
        [env_samples] * env_samples + [mesh_samples] * mesh_samples)
    for j, key in enumerate(("o", "d", "t_max", "lane")):
        want = np.concatenate([np.asarray(x[j]) for x in samples])
        _close(getattr(got.shadow, key), want, f"{what} shadow {key}")
    for j, key in enumerate(("dir", "radiance", "pdf"), start=4):
        want = np.stack([np.asarray(x[j]) for x in samples])
        _close(getattr(got.lights, key), want, f"{what} light {key}")
    assert torch.equal(got.lights.lane.reshape(-1), got.shadow.lane)
    traced = got.lights.lane[env_samples:]
    assert bool(traced.any()) == (mesh_samples > 0 and name != "no_emitters")
    if name == "no_emitters":
        assert not bool(got.lights.pdf[env_samples:].any())


def _ref_direct_draw(js, env_samples, mesh_samples, lanes):
    """The reference direct integrator's draws (direct.py:79-86 with
    :103-124) on numpy lanes: (rng, per sample (shadow o, d, t_max, lane,
    light dir, radiance, pdf))."""
    from moonshine_tpu.lights.mesh_lights import sample_mesh_lights

    J = jnp.asarray
    active = J(lanes["active"])
    position, tri_n = J(lanes["position"]), J(lanes["tri_n"])
    rng = J(lanes["rng"])
    samples = []
    for k in range(env_samples + mesh_samples):
        rng, r2 = JR.next_float2(rng)
        if k < env_samples:
            l_dir, l_rad, l_pdf = JE.sample_envmap(js.env, r2)
            tmax = jnp.full(l_pdf.shape, 1.0e12, jnp.float32)
        else:
            l_dir, l_pos, l_n, _, l_bary, l_pdf, l_row = sample_mesh_lights(
                js, position, r2)
            l_rad = JP._emissive_at(js, l_row, l_bary)
            tmax = jnp.linalg.norm(j_offset(l_pos, l_n) - position, axis=-1)
        shadow_o = j_offset(position, j_face_forward(tri_n, l_dir))
        samples.append((shadow_o, l_dir, tmax, active & (l_pdf > 0.0), l_dir,
                        l_rad, l_pdf))
    return rng, samples


@pytest.mark.parametrize("counts", [(1, 1), (2, 1), (0, 2), (2, 0)])
@pytest.mark.parametrize("name", ["constant", "textured", "no_emitters"])
def test_direct_draw_matches_reference(light_scenes, name, counts):
    """The direct form's draw (_draw_direct_plain: every light sample and
    its one-ended shadow ray, no cut, no roulette, delta materials too)
    against the reference direct integrator's on seeded lanes of the
    panels' scene: a third of the hit lanes dead and a sixth missed (both
    not active), every material type; masks and PCG states (every lane's
    advanced) exactly, the rest to TOL; the shadow batch in the samples'
    order (env first)."""
    js, ps = light_scenes[name]
    env_samples, mesh_samples = counts
    n = N
    rs = np.random.RandomState(71)
    f32 = np.float32
    lanes = _lanes(ps.num_tris, 0, n, 73)
    # shading points on the floor, below the panels, and random normals
    position = np.stack([rs.rand(n) * 6 - 3, rs.rand(n) * 6 - 3,
                         rs.rand(n) * 0.5], 1).astype(f32)
    tri_n = rs.randn(n, 3).astype(f32)
    tri_n /= np.linalg.norm(tri_n, axis=1, keepdims=True)
    lanes.update(position=position, tri_n=tri_n,
                 type=rs.randint(0, 4, n).astype(np.int32),
                 rng=rs.randint(0, 2**32, n).astype(np.uint32))
    missed = lanes["tri"] < 0
    assert missed.any() and (~lanes["active"] & ~missed).any()
    P = torch.from_numpy
    surf = shade.Surface(P(position), P(tri_n), None, None,
                         PB.MaterialLanes(P(lanes["type"]), None, None, None,
                                          None), None, P(lanes["active"]))
    got = shade._draw_direct_plain(
        ps, mesh_samples, surf, shade.DrawIn(
            ps.env, env_samples, 0, False, P(lanes["rng"].astype(np.int64))))
    rng, samples = _ref_direct_draw(js, env_samples, mesh_samples, lanes)
    what = f"{name} samples {counts}"
    assert got.active is surf.active and got.throughput is None
    _close(got.rng, np.asarray(rng).astype(np.int64), f"{what} rng")
    assert [got.lights.n_samples(k) for k in range(len(samples))] == (
        [env_samples] * env_samples + [mesh_samples] * mesh_samples)
    for j, key in enumerate(("o", "d", "t_max", "lane")):
        want = np.concatenate([np.asarray(x[j]) for x in samples])
        _close(getattr(got.shadow, key), want, f"{what} shadow {key}")
    for j, key in enumerate(("dir", "radiance", "pdf"), start=4):
        want = np.stack([np.asarray(x[j]) for x in samples])
        _close(getattr(got.lights, key), want, f"{what} light {key}")
    assert torch.equal(got.lights.lane.reshape(-1), got.shadow.lane)
    # delta materials trace their samples too; dead lanes none
    delta = np.isin(lanes["type"], (JB.GLASS, JB.MIRROR))
    traced = got.lights.lane.numpy()
    assert traced[:, delta].any() == traced.any()
    assert not traced[:, ~lanes["active"]].any()
    assert bool(got.lights.lane[env_samples:].any()) == (
        mesh_samples > 0 and name != "no_emitters")


def _pcg_state_for(top24: int, skip: int = 0) -> int:
    """A PCG state whose (skip + 1)-th next_float is top24 * 2^-24: the
    output permutation and the LCG step inverted (core/rng.py)."""
    mask = 2**32 - 1
    b = top24 << 8
    x = b ^ (b >> 22)  # (x >> 22) ^ x
    y = (x * pow(277803737, -1, 2**32)) & mask
    a, shift = y, (y >> 28) + 4  # (a >> ((a >> 28) + 4)) ^ a
    for _ in range(8):
        a = y ^ (a >> shift)
    for _ in range(skip + 1):  # the LCG step
        a = ((a - 2891336453) * pow(747796405, -1, 2**32)) & mask
    return a


def _envs():
    """(JAX EnvMap, the port's) at size 1 and 32, from one seeded sky."""
    rs = np.random.RandomState(3)
    sky = (rs.rand(32, 64, 3) ** 4 * 5).astype(np.float32)
    out = {}
    for name, arrays in (("constant", PE.constant_envmap((0.7, 0.8, 1.1))),
                         ("map", PE.build_envmap(sky))):
        p = PE.envmap_from_arrays(arrays, "cpu")
        j = JE.EnvMap(rgbl=jnp.asarray(arrays["rgbl"]),
                      integral=jnp.float32(arrays["integral"]),
                      select=jnp.asarray(arrays["select"]),
                      alias=jnp.asarray(arrays["alias"].astype(np.int32)))
        out[name] = j, p
    return out


@pytest.mark.parametrize("env_kind", ["constant", "map"])
def test_env_matches_reference(env_kind, light_scenes):
    """env_miss_plain against the reference's miss (env samples 0 and 1,
    bounce 0 and 2), and the direct surface form's env draw (two samples,
    on the panels' scene's hits) against next_float2 and sample_envmap,
    at env size 1 and 32, with lanes whose first or second uniform is 0
    or 1 - 2^-24."""
    je, pe = _envs()[env_kind]
    assert pe.size == (1 if env_kind == "constant" else 32)
    lanes = _lanes(10, 0, N, 41)
    J, P = jnp.asarray, torch.from_numpy
    d = J(lanes["d"])
    miss = J(lanes["active"]) & ~(J(lanes["tri"]) >= 0)
    thr, rad = J(lanes["throughput"]), J(lanes["radiance"])
    for env_samples in (0, 1):
        for bounce in (0, 2):
            got, mask = shade.env_miss(
                pe, env_samples, bounce, P(lanes["d"]), P(lanes["active"]),
                P(lanes["tri"]), P(lanes["throughput"]),
                P(lanes["radiance"]), P(lanes["last_pdf"]),
                P(lanes["last_delta"]))
            _close(mask, J(lanes["active"]) & (J(lanes["tri"]) >= 0),
                   f"miss mask {env_samples} {bounce}")
            env_plain = ((env_samples == 0) | (bounce == 0)
                         | J(lanes["last_delta"]))
            want = rad
            if env_samples > 0:
                env_rad, rad_e, pdf_e = JE.miss_radiance_and_pdf(je, d)
                w = JP.power_heuristic(1.0, J(lanes["last_pdf"]),
                                       env_samples, pdf_e)
                want = want + jnp.where(
                    (miss & ~env_plain & (pdf_e > 0.0))[..., None],
                    thr * rad_e * w[..., None], 0.0)
            else:
                env_rad = JE.envmap_incoming_radiance(je, d)
            want = want + jnp.where((miss & env_plain)[..., None],
                                    thr * env_rad, 0.0)
            _close(got, want, f"miss {env_samples} {bounce}")
    _, ps = light_scenes["constant"]
    lanes = _lanes(ps.num_tris, 0, N, 43)
    rng = np.random.RandomState(43).randint(0, 2**32, N).astype(np.uint32)
    edge = 2**24 - 1
    rng[:4] = [_pcg_state_for(0), _pcg_state_for(edge),
               _pcg_state_for(0, skip=1), _pcg_state_for(edge, skip=1)]
    lanes["active"][:4] = True
    t = lambda k: P(lanes[k])
    got = shade.surface(ps, 0, 0, _port_hit(lanes), None, t("d"),
                        t("active"), None, t("radiance"), None, None,
                        shade.DIRECT, shade.DrawIn(
                            pe, 2, 0, False, P(rng.astype(np.int64))))
    want_rng, r2 = JR.next_float2(J(rng))
    assert np.asarray(r2)[:4].tolist() == [
        [0.0, np.asarray(r2)[0, 1]], [1 - 2**-24, np.asarray(r2)[1, 1]],
        [np.asarray(r2)[2, 0], 0.0], [np.asarray(r2)[3, 0], 1 - 2**-24]]
    for k in range(2):
        if k:
            want_rng, r2 = JR.next_float2(want_rng)
        for got_x, want_x, what in zip(
                (got.lights.dir[k], got.lights.radiance[k],
                 got.lights.pdf[k]), JE.sample_envmap(je, r2),
                ("dir", "radiance", "pdf")):
            _close(got_x, want_x, f"draw {k} {what}")
        _close(got.lights.lane[k], J(lanes["active"]) & (
            JE.sample_envmap(je, r2)[2] > 0.0), f"draw {k} lane")
    _close(got.rng, np.asarray(want_rng).astype(np.int64), "draw rng")


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("env_samples", [0, 1])
@pytest.mark.parametrize("env_kind", ["constant", "map"])
def test_env_miss_in_place_matches_reference(env_kind, env_samples, bounce):
    """The miss as the loop calls it (integrator/shade.py env_miss, which
    on the card works in place on the state's radiance and mask) on a
    batch of dead, hit and missed lanes, against the reference's miss
    and the mask it leaves (moonshine_tpu/integrator/path.py:402-421:
    the env radiance added on active & ~is_hit, then active = active &
    is_hit); the radiance of every lane that did not miss stays as it
    was, bit for bit (-0.0 too), as the kernel, which does not write it,
    leaves it."""
    je, pe = _envs()[env_kind]
    rs = np.random.RandomState(47 + env_samples + 2 * bounce)
    n = 512
    lanes = _lanes(10, 0, n, 53)
    lanes["tri"][rs.rand(n) < 0.3] = -1
    lanes["active"] = rs.rand(n) < 0.7
    lanes["radiance"][rs.rand(n) < 0.1] = -0.0
    kinds = lanes["active"] & (lanes["tri"] < 0), lanes["active"] & (
        lanes["tri"] >= 0), ~lanes["active"]
    assert all(k.sum() > 20 for k in kinds)
    J, P = jnp.asarray, torch.from_numpy
    got, mask = shade.env_miss(
        pe, env_samples, bounce, P(lanes["d"]), P(lanes["active"]),
        P(lanes["tri"]), P(lanes["throughput"]), P(lanes["radiance"]),
        P(lanes["last_pdf"]), P(lanes["last_delta"]))
    # the reference's miss (path.py:402-421)
    d, active = J(lanes["d"]), J(lanes["active"])
    is_hit = J(lanes["tri"]) >= 0
    miss = active & ~is_hit
    thr, rad = J(lanes["throughput"]), J(lanes["radiance"])
    env_plain = (env_samples == 0) | (bounce == 0) | J(lanes["last_delta"])
    want = rad
    if env_samples > 0:
        env_rad, rad_e, pdf_e = JE.miss_radiance_and_pdf(je, d)
        w = JP.power_heuristic(1.0, J(lanes["last_pdf"]), env_samples, pdf_e)
        want = want + jnp.where((miss & ~env_plain & (pdf_e > 0.0))[..., None],
                                thr * rad_e * w[..., None], 0.0)
    else:
        env_rad = JE.envmap_incoming_radiance(je, d)
    want = want + jnp.where((miss & env_plain)[..., None], thr * env_rad,
                            0.0)
    _close(got, want, f"radiance {env_kind} {env_samples} {bounce}")
    _close(mask, active & is_hit, "the mask after the miss")
    kept = ~kinds[0]
    np.testing.assert_array_equal(got.numpy()[kept].view(np.int32),
                                  lanes["radiance"][kept].view(np.int32))
    assert (got.numpy()[kinds[0]] != lanes["radiance"][kinds[0]]).any()


# ---- the render held bit for bit

# The scenes' arrays (the JAX builds bridged by jax_scene_arrays and
# jax_tlas_arrays, committed so that the JAX build of the host does not
# enter the check) and the images and ray counts the port renders from
# them (recorded from the repository's root with `PYTHONPATH=. python
# tests/test_torch_shade.py --record`)
INPUTS = Path(__file__).parent / "torch_fixtures" / "render_inputs.npz"
IMAGES = Path(__file__).parent / "torch_fixtures" / "render_images.npz"
RENDERS = [("flagship", True), ("flagship", False), ("instanced", True)]


def _committed_scene(name):
    """The port's scene on the committed arrays of `name`."""
    with np.load(INPUTS) as z:
        arrays = {k.split("/", 1)[1]: z[k] for k in z.files
                  if k.startswith(name + "/")}
        statics = json.loads(str(z[name + ".statics"]))
    return scene_from_arrays(arrays, statics, "cpu")


def _render(name, unroll):
    """(image, rays) of a 32x32 x 2 spp render of a committed scene."""
    from moonshine_tpu_torch.scene.types import Lens

    scene = _committed_scene(name)
    if name == "flagship":
        from moonshine_tpu_torch.scene import procedural

        lens = procedural.flagship_scene()[1]
    else:
        from test_torch_tlas import LENS

        lens = Lens(**LENS)
    la = LensArrays.from_lens(lens, "cpu")
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1, unroll=unroll)
    return RR.render_spp(scene, la, 32, 32, 3, 2, cfg)


def _key(name, unroll):
    return f"{name}_{'unrolled' if unroll else 'looped'}"


@pytest.mark.parametrize("name,unroll", RENDERS)
def test_render_bit_for_bit_as_before(name, unroll):
    """A 32x32 x 2 spp render (every segment kind: bounce 0, the deep and
    roulette ones, the thin last one or the looped form's) of a committed
    scene equals, bit for bit with its ray count, the recorded render
    (IMAGES). The inputs are committed arrays and the port's CPU float32
    functions round as on any host (core/mathutil.py), so the check holds
    on every host."""
    img, rays = _render(name, unroll)
    key = _key(name, unroll)
    with np.load(IMAGES) as before:
        want, want_rays = before[key], int(before[f"{key}_rays"])
    np.testing.assert_array_equal(img.numpy().view(np.int32),
                                  want.view(np.int32))
    assert int(rays) == want_rays
    assert float(img.mean()) > 0.0


def _record():
    """Write INPUTS from the JAX builds and IMAGES from this tree."""
    from __graft_entry__ import _flagship_scene

    out = {}
    built = {
        "flagship": jax_scene_arrays(_flagship_scene()[0]),
        "instanced": jax_tlas_arrays(two_level(
            jax_world(n=6, mirrored=True, hidden=4).build)),
    }
    for name, (arrays, statics) in built.items():
        out.update({f"{name}/{k}": v for k, v in arrays.items()})
        out[f"{name}.statics"] = np.asarray(json.dumps(statics))
    np.savez_compressed(INPUTS, **out)
    images = {}
    for name, unroll in RENDERS:
        img, rays = _render(name, unroll)
        images[_key(name, unroll)] = img.numpy()
        images[_key(name, unroll) + "_rays"] = np.asarray(int(rays))
    np.savez_compressed(IMAGES, **images)


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--record" in sys.argv:
        _record()
