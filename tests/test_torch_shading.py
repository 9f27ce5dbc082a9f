"""The port's shading against moonshine_tpu's on the CPU: BSDF eval, pdf
and sampling for all four material variants, env-map sampling and miss
queries, mesh-light sampling and the textured atlas fetch.

Inputs come from numpy seeds; both sides read the same scene tables
(the JAX scene bridged with scene_from_arrays). Tolerance rtol 1e-5,
atol 1e-6: the frameworks' transcendental functions and fused multiply-
adds differ in the last bits, and GGX / Fresnel terms amplify that."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.bsdf import materials as JB
from moonshine_tpu.lights import envmap as JE
from moonshine_tpu.lights import mesh_lights as JL
from moonshine_tpu.scene import textures as JT
from moonshine_tpu_torch.bsdf import materials as PB
from moonshine_tpu_torch.lights import envmap as PE
from moonshine_tpu_torch.lights import mesh_lights as PL
from moonshine_tpu_torch.scene import textures as PT
from moonshine_tpu_torch.scene.world import scene_from_arrays

from test_torch_scene import jax_scene_arrays

TOL = dict(rtol=1e-5, atol=1e-6)
N = 3000


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _dirs(rs, n, upper=None):
    v = rs.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) * upper
    return v


@pytest.fixture(scope="module")
def flagship():
    """(JAX DeviceScene, the same scene bridged into the port)."""
    from __graft_entry__ import _flagship_scene

    js = _flagship_scene()[0]
    return js, scene_from_arrays(*jax_scene_arrays(js), "cpu")


def bsdf_case(mat_type):
    """test_bsdf's seeded lanes of one material type: (material fields,
    w_i, w_o, the sampling squares)."""
    rs = np.random.RandomState(mat_type)
    f32 = np.float32
    fields = dict(
        type=np.full(N, mat_type, np.int32),
        color=rs.rand(N, 3).astype(f32),
        metalness=rs.rand(N).astype(f32),
        alpha=np.maximum(rs.rand(N).astype(f32) ** 2, f32(1e-3)),
        ior=(1.2 + 0.6 * rs.rand(N)).astype(f32),
    )
    # mostly upper-hemisphere directions, a quarter from below
    w_o = _dirs(rs, N, upper=1.0)
    w_o[: N // 4, 2] *= -1
    w_i = _dirs(rs, N)
    sq = rs.rand(N, 2).astype(f32)
    return fields, w_i, w_o, sq


@pytest.mark.parametrize("mat_type", [JB.GLASS, JB.LAMBERT, JB.MIRROR,
                                      JB.STANDARD_PBR])
def test_bsdf(mat_type):
    fields, w_i, w_o, sq = bsdf_case(mat_type)
    jm = JB.MaterialLanes(**{k: jnp.asarray(v) for k, v in fields.items()})
    pm = PB.MaterialLanes(**{k: torch.from_numpy(v) for k, v in fields.items()})
    J = lambda x: jnp.asarray(x)
    P = torch.from_numpy

    _close(PB.eval_bsdf(pm, P(w_i), P(w_o)), JB.eval_bsdf(jm, J(w_i), J(w_o)))
    _close(PB.pdf_bsdf(pm, P(w_i), P(w_o)), JB.pdf_bsdf(jm, J(w_i), J(w_o)))
    gf, gp = PB.eval_pdf_bsdf(pm, P(w_i), P(w_o))
    wf, wp = JB.eval_pdf_bsdf(jm, J(w_i), J(w_o))
    _close(gf, wf)
    _close(gp, wp)
    gd, gp = PB.sample_bsdf(pm, P(w_o), P(sq))
    wd, wp = JB.sample_bsdf(jm, J(w_o), J(sq))
    _close(gd, wd)
    # the GGX density at a sampled half vector h has relative condition
    # 2 / (alpha^2 + sin^2 theta_h): last-bit differences in h reach a few
    # 1e-5 on rare glossy lanes, so every lane is held to 1e-4 and all but
    # 0.1% of lanes to the common bar
    gp, wp = gp.numpy(), np.asarray(wp)
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-6)
    assert np.isclose(gp, wp, **TOL).mean() >= 0.999
    np.testing.assert_array_equal(PB.is_delta(pm.type).numpy(),
                                  np.asarray(JB.is_delta(jm.type)))


def test_envmap(flagship):
    js, ps = flagship
    assert ps.env.size == js.env.size == 16
    rs = np.random.RandomState(11)
    r2 = rs.rand(N, 2).astype(np.float32)
    for got, want in zip(PE.sample_envmap(ps.env, torch.from_numpy(r2)),
                         JE.sample_envmap(js.env, jnp.asarray(r2))):
        _close(got, want)
    d = _dirs(rs, N)
    for got, want in zip(PE.miss_radiance_and_pdf(ps.env, torch.from_numpy(d)),
                         JE.miss_radiance_and_pdf(js.env, jnp.asarray(d))):
        _close(got, want)
    _close(PE.envmap_incoming_radiance(ps.env, torch.from_numpy(d)),
           JE.envmap_incoming_radiance(js.env, jnp.asarray(d)))
    for got, want in zip(PE.eval_envmap(ps.env, torch.from_numpy(d)),
                         JE.eval_envmap(js.env, jnp.asarray(d))):
        _close(got, want)


def test_constant_envmap():
    env = PE.envmap_from_arrays(PE.constant_envmap((0.5, 1.0, 2.0)), "cpu")
    jenv = JE.constant_envmap((0.5, 1.0, 2.0))
    rs = np.random.RandomState(12)
    r2 = rs.rand(N, 2).astype(np.float32)
    for got, want in zip(PE.sample_envmap(env, torch.from_numpy(r2)),
                         JE.sample_envmap(jenv, jnp.asarray(r2))):
        _close(got, want)


def test_mesh_lights(flagship):
    js, ps = flagship
    rs = np.random.RandomState(13)
    pos = (rs.randn(N, 3) * 2).astype(np.float32)
    r2 = rs.rand(N, 2).astype(np.float32)
    got = PL.sample_mesh_lights(ps, torch.from_numpy(pos),
                                torch.from_numpy(r2))
    want = JL.sample_mesh_lights(js, jnp.asarray(pos), jnp.asarray(r2))
    for g, w in zip(got, want):
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)
    a, b = _dirs(rs, N), _dirs(rs, N)
    _close(PL.area_to_solid_angle(torch.from_numpy(pos), torch.from_numpy(a),
                                  torch.from_numpy(a), torch.from_numpy(b)),
           JL.area_to_solid_angle(jnp.asarray(pos), jnp.asarray(a),
                                  jnp.asarray(a), jnp.asarray(b)))


def test_material_block_fetch(flagship):
    """Bilinear repeat-wrap fetch from the flagship's textured BSDF plane
    (the checkered floor), including uvs far outside [0, 1]."""
    js, ps = flagship
    assert not ps.mat_atlas.bsdf_constant
    rect = np.asarray(js.materials.packed)[0, 1:5]  # the floor's block
    assert rect[2] > 1 and rect[3] > 1
    rs = np.random.RandomState(14)
    uv = (rs.rand(N, 2) * 8 - 4).astype(np.float32)
    rects = np.broadcast_to(rect, (N, 4)).copy()
    got = PT.sample_material_block(ps.mat_atlas.bsdf, torch.from_numpy(rects),
                                   torch.from_numpy(uv))
    want = JT.sample_material_block(js.mat_atlas.bsdf, jnp.asarray(rects),
                                    jnp.asarray(uv))
    _close(got, want)


@pytest.mark.parametrize("name", ["sqrt", "sin", "cos", "log", "tan", "acos",
                                  "atan2", "pow", "cross"])
def test_cpu_functions_round_as_on_every_host(name):
    """The port's float32 functions on CPU tensors (core/mathutil.py)
    give the value that does not depend on the host: sqrt the correctly
    rounded root (numpy's IEEE one, on seeded, tiny, huge, zero and
    negative inputs), the others the float64 value rounded once (Python's
    math in float64, rounded by numpy), cross
    each product rounded as numpy's float32 arithmetic rounds it; on
    lane counts on both sides of the vector loops' widths."""
    from moonshine_tpu_torch.core import mathutil as M

    rs = np.random.RandomState(71)
    f32 = np.float32
    x = np.concatenate([rs.rand(4099) * 4, rs.randn(64) * 1e30,
                        rs.rand(64) * 1e-38, [0.0, -0.0, 1.0, 4.0]]).astype(
                            f32)
    t = torch.from_numpy
    if name == "sqrt":
        got = M.sqrt(t(np.abs(x))).numpy()
        np.testing.assert_array_equal(got, np.sqrt(np.abs(x)))
        assert np.isnan(M.sqrt(t(f32([-1.0]))).numpy()).all()
        return
    if name == "cross":
        a, b = rs.randn(2, 4099, 3).astype(f32)
        want = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)
        np.testing.assert_array_equal(M.cross(t(a), t(b)).numpy(), want)
        return
    x = x[:4099] + f32(0.01)
    if name == "acos":
        x = x / f32(4.2)
    args = {"atan2": (x - 2, x), "pow": (x, 5)}.get(name, (x,))
    got = getattr(M, name)(*(t(a) if isinstance(a, np.ndarray) else a
                             for a in args)).numpy()
    # the expected value from outside torch: Python's libm in float64
    fn = getattr(math, name)
    cols = [a.astype(np.float64) if isinstance(a, np.ndarray)
            else np.full(x.shape, a, np.float64) for a in args]
    ref = np.array([fn(*v) for v in zip(*cols)]).astype(f32)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32
