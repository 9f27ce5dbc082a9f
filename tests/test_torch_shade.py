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
  material type;
- env: miss_radiance_and_pdf / envmap_incoming_radiance with the miss
  weighting (path.py:404-419) and sample_envmap, at size 1 and 32.

Tolerance rtol 1e-5, atol 1e-5 (positions and radiance of order 10:
1e-6 relative): the frameworks' transcendental functions and fused
multiply-adds differ in the last bits, and normalisations, GGX and
Fresnel terms amplify that; the scattered pdf and throughput of glossy
lanes by GGX's condition (`_close_glossy`). The masks (live lanes,
shading-frame picks, scatter validity) agree exactly on every lane.
"""

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
    t = lambda k: torch.from_numpy(lanes[k])
    return shade.surface(ps, mesh_samples, torch.tensor(bounce),
                         _port_hit(lanes), t("o"), t("d"), t("active"),
                         t("throughput"), t("radiance"), t("last_pdf"),
                         t("last_delta"), mode)


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


@pytest.mark.parametrize("mat_type", [JB.GLASS, JB.LAMBERT, JB.MIRROR,
                                      JB.STANDARD_PBR])
def test_scatter_matches_reference(mat_type):
    """scatter_plain against the reference on seeded lanes of one
    material type: random frames, w_o, colours, metalness, roughness and
    ior; an env sample and two mesh samples (sample counts 1 and 2) with
    random lanes and occlusion."""
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
    P = torch.from_numpy
    surf = shade.Surface(
        position=P(state["position"]), tri_n=P(state["tri_n"]),
        frame=PFrame(n=P(nrm), s=P(s), t=P(t)), w_o_ss=P(wo),
        mat=PB.MaterialLanes(**{k: P(v) for k, v in fields.items()}),
        radiance=P(state["rad"]), active=P(state["active"]))
    got = shade.scatter(surf, P(state["o"]), P(state["d"]), P(state["thr"]),
                        surf.radiance, P(state["rng"].astype(np.int64)),
                        surf.active,
                        [shade.Light(P(a), P(b), P(c), P(e), P(f), g)
                         for a, b, c, e, f, g in lights])
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
def test_env_matches_reference(env_kind):
    """env_miss_plain against the reference's miss (env samples 0 and 1,
    bounce 0 and 2) and env_draw_plain against sample_envmap, at env size
    1 and 32."""
    je, pe = _envs()[env_kind]
    assert pe.size == (1 if env_kind == "constant" else 32)
    lanes = _lanes(10, 0, N, 41)
    J, P = jnp.asarray, torch.from_numpy
    d = J(lanes["d"])
    miss = J(lanes["active"]) & ~(J(lanes["tri"]) >= 0)
    thr, rad = J(lanes["throughput"]), J(lanes["radiance"])
    for env_samples in (0, 1):
        for bounce in (0, 2):
            got = shade.env_miss(pe, env_samples, bounce, P(lanes["d"]),
                                 P(lanes["active"]), P(lanes["tri"]),
                                 P(lanes["throughput"]),
                                 P(lanes["radiance"]), P(lanes["last_pdf"]),
                                 P(lanes["last_delta"]))
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
    rs = np.random.RandomState(43)
    rand2 = rs.rand(N, 2).astype(np.float32)
    rand2[0] = 0.0
    for got, want, what in zip(shade.env_draw(pe, P(rand2)),
                               JE.sample_envmap(je, J(rand2)),
                               ("dir", "radiance", "pdf")):
        _close(got, want, f"draw {what}")


# ---- the render against the integrator as it was

# The same renders by the integrator as it stood before its shading
# moved behind integrator/shade.py: the images and ray counts
BEFORE = Path(__file__).parent / "torch_fixtures" / "render_before_shade.npz"


@pytest.mark.parametrize("name,unroll", [("flagship", True),
                                         ("flagship", False),
                                         ("instanced", True)])
def test_render_bit_for_bit_as_before(scenes, name, unroll):
    """A 32x32 x 2 spp render (every segment kind: bounce 0, the deep and
    roulette ones, the thin last one or the looped form's) equals, bit for
    bit with its ray count, the same render by the integrator as it was
    before the shading moved behind integrator/shade.py (BEFORE)."""
    from moonshine_tpu_torch.scene.types import Lens

    _, scene = scenes[name]
    if name == "flagship":
        from moonshine_tpu_torch.scene import procedural

        lens = procedural.flagship_scene()[1]
    else:
        from test_torch_tlas import LENS

        lens = Lens(**LENS)
    la = LensArrays.from_lens(lens, "cpu")
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1, unroll=unroll)
    img, rays = RR.render_spp(scene, la, 32, 32, 3, 2, cfg)
    key = f"{name}_{'unrolled' if unroll else 'looped'}"
    with np.load(BEFORE) as before:
        want, want_rays = before[key], int(before[f"{key}_rays"])
    np.testing.assert_array_equal(img.numpy().view(np.int32),
                                  want.view(np.int32))
    assert int(rays) == want_rays
    assert float(img.mean()) > 0.0
