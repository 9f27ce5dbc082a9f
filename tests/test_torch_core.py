"""moonshine_tpu_torch.core against moonshine_tpu.core on the CPU.

RNG states and floats are bitwise equal; mappings, frames and math
helpers agree within 4 ulp at unit scale (rtol = atol = 5e-7: the two
frameworks' sin/cos/atan2/log differ in the last bits); alias tables and
their draws are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.core import alias_table as JA
from moonshine_tpu.core import frame as JF
from moonshine_tpu.core import mappings as JM
from moonshine_tpu.core import mathutil as JU
from moonshine_tpu.core import rng as JR
from moonshine_tpu_torch.core import alias_table as PA
from moonshine_tpu_torch.core import frame as PF
from moonshine_tpu_torch.core import mappings as PM
from moonshine_tpu_torch.core import mathutil as PU
from moonshine_tpu_torch.core import rng as PR

ULP4 = dict(rtol=5e-7, atol=5e-7)


def _t(x):
    return torch.from_numpy(np.array(x))


def _square(n, seed):
    rs = np.random.RandomState(seed)
    sq = rs.rand(n, 2).astype(np.float32)
    sq[:4] = [[0.0, 0.0], [0.5, 0.5], [0.999, 0.001], [0.25, 0.75]]
    return sq


def _unit(n, seed):
    rs = np.random.RandomState(seed)
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_rng_seed_bitwise():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 4096, 500).astype(np.uint32)
    y = rs.randint(0, 4096, 500).astype(np.uint32)
    x[:3] = [0, 4095, 0xFFFFFFFF]
    for s in (0, 1, 7, 123456, 0xFFFFFFFF):
        want = np.asarray(JR.seed(s, jnp.asarray(x), jnp.asarray(y)))
        got = PR.seed(s, _t(x.astype(np.int64)), _t(y.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_rng_streams_bitwise():
    rs = np.random.RandomState(1)
    st0 = rs.randint(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    js, ps = jnp.asarray(st0), _t(st0.astype(np.int64))
    for _ in range(6):
        js, jf = JR.next_float(js)
        ps, pf = PR.next_float(ps)
        np.testing.assert_array_equal(ps.numpy().astype(np.uint32),
                                      np.asarray(js))
        assert pf.dtype == torch.float32
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    js, jf2 = JR.next_float2(js)
    ps, pf2 = PR.next_float2(ps)
    np.testing.assert_array_equal(pf2.numpy(), np.asarray(jf2))
    np.testing.assert_array_equal(ps.numpy().astype(np.uint32),
                                  np.asarray(js))


@pytest.mark.parametrize("name", [
    "square_to_triangle", "square_to_gaussian",
    "square_to_uniform_disk_concentric", "square_to_cosine_hemisphere",
    "square_to_equal_area_sphere",
])
def test_square_mappings(name):
    sq = _square(2000, 2)
    want = np.asarray(getattr(JM, name)(jnp.asarray(sq)))
    got = getattr(PM, name)(_t(sq)).numpy()
    np.testing.assert_allclose(got, want, **ULP4)


def test_direction_mappings():
    d = _unit(2000, 3)
    np.testing.assert_allclose(
        PM.square_to_equal_area_sphere_inverse(_t(d)).numpy(),
        np.asarray(JM.square_to_equal_area_sphere_inverse(jnp.asarray(d))),
        **ULP4)
    np.testing.assert_allclose(
        PM.cartesian_to_spherical(_t(d)).numpy(),
        np.asarray(JM.cartesian_to_spherical(jnp.asarray(d))), **ULP4)
    rs = np.random.RandomState(4)
    p = rs.rand(2000).astype(np.float32)
    p[:3] = [0.0, 1.0, 0.5]
    r = rs.rand(2000).astype(np.float32)
    jt, jr = JM.coin_flip_remap(jnp.asarray(p), jnp.asarray(r))
    pt, pr = PM.coin_flip_remap(_t(p), _t(r))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **ULP4)


def test_frames_and_math():
    n = _unit(1000, 5)
    s = _unit(1000, 6)
    v = _unit(1000, 7)
    jf = JF.Frame.from_normal(jnp.asarray(n))
    pf = PF.Frame.from_normal(_t(n))
    for a, b in zip(pf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ULP4)
    jo = JF.Frame(n=jnp.asarray(n), s=jnp.asarray(s), t=jnp.asarray(v)
                  ).reorthogonalize()
    po = PF.Frame(n=_t(n), s=_t(s), t=_t(v)).reorthogonalize()
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ULP4)
    np.testing.assert_allclose(po.world_to_frame(_t(v)).numpy(),
                               np.asarray(jo.world_to_frame(jnp.asarray(v))),
                               **ULP4)
    np.testing.assert_allclose(po.frame_to_world(_t(v)).numpy(),
                               np.asarray(jo.frame_to_world(jnp.asarray(v))),
                               **ULP4)
    np.testing.assert_array_equal(
        PU.face_forward(_t(n), _t(v)).numpy(),
        np.asarray(JU.face_forward(jnp.asarray(n), jnp.asarray(v))))
    p = (np.random.RandomState(8).randn(1000, 3) * 3).astype(np.float32)
    p[:3] = [[0.0, 0.01, -0.01], [1e-3, 5.0, -7.0], [100.0, -100.0, 0.02]]
    np.testing.assert_array_equal(
        PU.offset_along_normal(_t(p), _t(n)).numpy(),
        np.asarray(JU.offset_along_normal(jnp.asarray(p), jnp.asarray(n))))


def test_alias_build_and_draws():
    rs = np.random.RandomState(9)
    w = rs.rand(300) ** 4
    w[10:20] = 0.0
    jt = JA.build(w)
    pt = PA.build(w)
    np.testing.assert_array_equal(pt.select, np.asarray(jt.select))
    np.testing.assert_array_equal(pt.alias, np.asarray(jt.alias))
    assert pt.weight_sum == jt.weight_sum and pt.count == jt.count
    r = rs.rand(5000).astype(np.float32)
    ji, jr = JA.sample(jt, 300, jnp.asarray(r))
    pi, pr = PA.sample(_t(pt.select), _t(pt.alias.astype(np.int64)), 300,
                       _t(r))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji).astype(np.int64))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **ULP4)
