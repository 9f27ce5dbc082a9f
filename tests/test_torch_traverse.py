"""The port's plain traversal against moonshine_tpu's Pallas packet kernels
run in interpret mode, on the cases of tests/test_packet.py: 16-wide /
12-slot and 24-wide / 24-slot rows, 37- and 700-triangle scenes, active
masks, and a ray count that is not a multiple of the kernel block.

is_hit matches exactly, t to 1e-5 relative, and tri everywhere except on
equal-t ties (the two traversal orders may keep either triangle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.accel import packet as JP
from moonshine_tpu.accel import wide as JW
from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import wide as PW

from test_bvh import random_rays, random_tris

N_RAYS = 1500  # not a multiple of the 1024-lane interpret block
CASES = [(37, 4, 12, 16), (700, 5, 12, 16), (37, 4, 24, 24),
         (700, 5, 24, 24)]


def _case(n_tris, seed, cap, width):
    tris = random_tris(n_tris, seed=seed)
    jw = JW.build_wide(tris, leaf_cap=cap, width=width)
    pw = PW.build_wide(tris, leaf_cap=cap, width=width)
    o, d = random_rays(N_RAYS, seed=seed + 10)
    rs = np.random.RandomState(seed)
    active = rs.rand(N_RAYS) > 0.25
    return jw, pw, np.asarray(o), np.asarray(d), active, rs


@pytest.mark.parametrize("n_tris,seed,cap,width", CASES)
def test_rows_match_reference(n_tris, seed, cap, width):
    jw, pw, *_ = _case(n_tris, seed, cap, width)
    np.testing.assert_array_equal(pw.nodes.numpy(), np.asarray(jw.nodes))
    np.testing.assert_array_equal(pw.leaves.numpy(), np.asarray(jw.leaves))
    np.testing.assert_array_equal(pw.bounds.numpy(), np.asarray(jw.bounds))
    assert (pw.max_depth, pw.width, pw.leaf_slots, pw.max_stack) == (
        jw.max_depth, jw.width, jw.leaf_slots, jw.max_stack)


@pytest.mark.parametrize("n_tris,seed,cap,width", CASES)
def test_closest_hit_matches_reference(n_tris, seed, cap, width):
    jw, pw, o, d, active, _ = _case(n_tris, seed, cap, width)
    want = JP.closest_hit_packet(jw, jnp.asarray(o), jnp.asarray(d), 1e12,
                                 active_in=jnp.asarray(active),
                                 interpret=True)
    got = PP.closest_hit_packet(pw, torch.from_numpy(o), torch.from_numpy(d),
                                1e12, active_in=torch.from_numpy(active))
    w_tri, g_tri = np.asarray(want.tri), got.tri.numpy()
    np.testing.assert_array_equal(g_tri >= 0, w_tri >= 0)
    assert not (g_tri[~active] >= 0).any()
    hit = w_tri >= 0
    assert hit.sum() >= 10
    w_t, g_t = np.asarray(want.t), got.t.numpy()
    np.testing.assert_allclose(g_t[hit], w_t[hit], rtol=1e-5)
    np.testing.assert_array_equal(g_t[~hit], w_t[~hit])  # = t_max
    tie = hit & (g_tri != w_tri)
    np.testing.assert_allclose(g_t[tie], w_t[tie], rtol=1e-5)
    same = hit & (g_tri == w_tri)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(want.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(want.v)[same],
                               atol=1e-4)
    assert (got.u.numpy()[~hit] == 0).all() and (got.v.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("n_tris,seed,cap,width", CASES)
def test_any_hit_matches_reference(n_tris, seed, cap, width):
    jw, pw, o, d, active, rs = _case(n_tris, seed, cap, width)
    t_max = (rs.rand(N_RAYS) * 12.0).astype(np.float32)
    want = np.asarray(JP.any_hit_packet(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        active_in=jnp.asarray(active), interpret=True))
    got = PP.any_hit_packet(pw, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t_max),
                            active_in=torch.from_numpy(active))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 5 and not want[~active].any()


def test_dead_lanes_and_scalar_tmax():
    """Dead lanes return the caller's t_max, tri -1 and u = v = 0; a
    finite scalar t_max bounds closest hits like a per-lane one."""
    _, pw, o, d, active, _ = _case(700, 5, 12, 16)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    act = torch.from_numpy(active)
    t_lanes = torch.full((N_RAYS,), 3.0)
    h = PP.closest_hit_packet(pw, o, d, t_lanes, active_in=act)
    h2 = PP.closest_hit_packet(pw, o, d, 3.0, active_in=act)
    for a, b in zip(h, h2):
        assert torch.equal(a, b)
    dead = ~act
    assert (h.tri[dead] == -1).all() and (h.t[dead] == 3.0).all()
    assert (h.u[dead] == 0).all() and (h.v[dead] == 0).all()
    assert (h.t[h.tri >= 0] < 3.0).all()
    occ = PP.any_hit_packet(pw, o, d, 3.0, active_in=act)
    assert torch.equal(occ, h.tri >= 0)


def test_wrapper_rejects_bad_input():
    _, pw, o, d, _, _ = _case(37, 4, 12, 16)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    with pytest.raises(ValueError):
        PP.closest_hit_packet(pw, o.double(), d, 1e12)
    with pytest.raises(ValueError):
        PP.any_hit_packet(pw, o, d, torch.ones(7))
    with pytest.raises(ValueError):
        PP.closest_hit_packet(pw, o, d, 1e12,
                              active_in=torch.ones(N_RAYS, dtype=torch.int32))
    meta = pw._replace(nodes=pw.nodes.to("meta"), leaves=pw.leaves.to("meta"))
    with pytest.raises(ValueError, match="no traversal for device"):
        PP.closest_hit_packet(meta, o.to("meta"), d.to("meta"), 1e12)
