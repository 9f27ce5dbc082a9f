"""The port's format-V surface (accel/vpacket.py) against moonshine_tpu's:
the tiles bit for bit, and the plain traversal over them against the
port's row traversal and the reference's V kernels in interpret mode.

Tolerances: the V plain versions evaluate packet._walk's expressions in
its order on the same words, so they equal the row plain versions bit for
bit. Against the reference, tests/test_vpacket.py's bar: tri equal, t to
1e-5 relative (atol 1e-6), u and v to 1e-4 (atol 1e-5), occlusion equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.accel import vpacket as JV
from moonshine_tpu.accel import wide as JW
from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import vpacket as PV
from moonshine_tpu_torch.accel import wide as PW

from test_bvh import random_rays, random_tris


def _pair(n_tris, seed, width, cap):
    tris = random_tris(n_tris, seed=seed)
    pw = PW.build_wide(tris, leaf_cap=cap, width=width, device="cpu")
    return tris, pw, PV.v_from_wide(pw)


def _rays(n, seed):
    o, d = random_rays(n, seed=seed)
    rs = np.random.RandomState(seed)
    active = rs.rand(n) > 0.25
    t_max = (rs.rand(n) * 12.0).astype(np.float32)
    return np.asarray(o), np.asarray(d), active, t_max


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("width", [8, 16, 24])
@pytest.mark.parametrize("cap", [8, 12, 24])
def test_tiles_match_reference(width, cap):
    """tiles_from_rows and v_from_wide equal the reference's tiles bit for
    bit (cap 12: the last sublane group holds 4 empty slots)."""
    tris = random_tris(300, seed=width + cap)
    jw = JW.build_wide(tris, leaf_cap=cap, width=width)
    jv = JV.v_from_wide(jw)
    nt, lt = PV.tiles_from_rows(np.asarray(jw.nodes), np.asarray(jw.leaves),
                                width, cap)
    np.testing.assert_array_equal(nt, np.asarray(jv.nodes))
    np.testing.assert_array_equal(lt, np.asarray(jv.leaves))
    pv = PV.v_from_wide(PW.build_wide(tris, leaf_cap=cap, width=width,
                                      device="cpu"))
    np.testing.assert_array_equal(pv.nodes.numpy(), np.asarray(jv.nodes))
    np.testing.assert_array_equal(pv.leaves.numpy(), np.asarray(jv.leaves))
    assert (pv.max_depth, pv.width, pv.leaf_slots, pv.max_stack) == (
        jv.max_depth, jv.width, jv.leaf_slots, jv.max_stack)
    assert (pv.num_nodes, pv.num_leaves, pv.num_tris) == (
        jv.num_nodes, jv.num_leaves, jv.num_tris)


@pytest.mark.parametrize("n_tris,seed,width,cap", [
    (37, 4, 16, 8), (700, 5, 16, 12), (700, 15, 24, 24), (400, 6, 8, 8)])
def test_plain_equals_row_plain(n_tris, seed, width, cap):
    """Over the tiles, the same hits, t, u, v and occlusion as the row
    plain versions over the rows, bit for bit, and the same visits."""
    _, pw, pv = _pair(n_tris, seed, width, cap)
    o, d, active, t_max = _t(*_rays(1500, seed + 10))
    got, gv = PV.closest_hit_plain(pv, o, d, 1e12, active_in=active,
                                   count_visits=True)
    want, wv = PP.closest_hit_plain(pw, o, d, 1e12, active_in=active,
                                    count_visits=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert gv == wv
    assert int((want.tri >= 0).sum()) >= 10
    occ, ov = PV.any_hit_plain(pv, o, d, t_max, active_in=active,
                               count_visits=True)
    want_occ, wov = PP.any_hit_plain(pw, o, d, t_max, active_in=active,
                                     count_visits=True)
    assert torch.equal(occ, want_occ) and ov == wov
    assert int(occ.sum()) >= 5


@pytest.mark.parametrize("n_tris,seed,width,cap", [
    (37, 4, 16, 8), (700, 5, 16, 12), (700, 15, 24, 24)])
def test_closest_matches_reference(n_tris, seed, width, cap):
    """The port's V traversal against the reference's V kernel (interpret
    mode), 1000 rays."""
    tris, pw, pv = _pair(n_tris, seed, width, cap)
    jv = JV.v_from_wide(JW.build_wide(tris, leaf_cap=cap, width=width))
    o, d, _, _ = _rays(1000, seed + 20)
    want = JV.closest_hit_vpacket(jv, jnp.asarray(o), jnp.asarray(d), 1e12,
                                  interpret=True)
    got = PV.closest_hit_vpacket(pv, *_t(o, d), 1e12)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert (got.tri >= 0).sum() >= 10
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("width,cap", [(16, 12), (24, 24)])
def test_any_hit_matches_reference(width, cap):
    """Occlusion with a finite per-lane t_max and an active mask equals
    the reference's V kernel (interpret mode)."""
    tris, pw, pv = _pair(700, 5, width, cap)
    jv = JV.v_from_wide(JW.build_wide(tris, leaf_cap=cap, width=width))
    o, d, active, t_max = _rays(1000, 21)
    want = np.asarray(JV.any_hit_vpacket(
        jv, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        active_in=jnp.asarray(active), interpret=True))
    got = PV.any_hit_vpacket(pv, *_t(o, d, t_max), active_in=_t(active)[0])
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 5 and not want[~active].any()


def test_active_mask_and_hbm_wrappers():
    """Dead lanes return t_max, tri -1, u = v = 0; the sorting _hbm
    wrappers (and sort=True) equal the unsorted ones."""
    _, _, pv = _pair(700, 5, 24, 24)
    o, d, active, t_max = _t(*_rays(1000, 23))
    h = PV.closest_hit_vpacket(pv, o, d, 3.0, active_in=active)
    dead = ~active
    assert (h.tri[dead] == -1).all() and (h.t[dead] == 3.0).all()
    assert (h.u[dead] == 0).all() and (h.v[dead] == 0).all()
    for fn_hbm, fn in ((PV.closest_hit_vpacket_hbm, PV.closest_hit_vpacket),
                       (PV.any_hit_vpacket_hbm, PV.any_hit_vpacket)):
        a = fn(pv, o, d, t_max, active_in=active)
        for b in (fn_hbm(pv, o, d, t_max, active_in=active),
                  fn(pv, o, d, t_max, active_in=active, sort=True)):
            for x, y in zip(*((a, b) if isinstance(a, tuple) else
                              ((a,), (b,)))):
                assert torch.equal(x, y)
    meta = pv._replace(nodes=pv.nodes.to("meta"), leaves=pv.leaves.to("meta"))
    with pytest.raises(ValueError, match="no traversal for device"):
        PV.closest_hit_vpacket(meta, o.to("meta"), d.to("meta"), 1e12)


def test_visits_skip_empty_slots():
    """The port's V walk enters no empty child slot: its visit counts on a
    300-triangle 16-wide / 8-slot tree equal the row walk's, which never
    tests a slot whose pointer is -1 (the reference's V kernel visits
    leaf 0 once more for every empty slot of a visited node)."""
    _, pw, pv = _pair(300, 8, 16, 8)
    o, d, _, _ = _t(*_rays(256, 3))
    empty = int((pv.nodes[:, 0, PV.PTR_LANE0:PV.PTR_LANE0 + 16] == -1)
                .sum())
    assert empty > 0
    _, gv = PV.closest_hit_plain(pv, o, d, 1e12, count_visits=True)
    _, wv = PP.closest_hit_plain(pw, o, d, 1e12, count_visits=True)
    assert gv == wv
    assert gv.node_slots < gv.nodes * 16  # empty slots were not tested
    assert PV.fits_vmem(pv) and PV.stack_ok(pv, hbm=True)
    assert PV.used_floats(pv) == (8 * 12 + 17, 80)
