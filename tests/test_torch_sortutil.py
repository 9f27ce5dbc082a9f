"""The port's lane sort (moonshine_tpu_torch/core/sortutil.py) on the CPU,
where `sort_lanes` and `unsort_lanes` run their plain versions, against
the reference's one multi-operand sort (moonshine_tpu/core/sortutil.py)
and against numpy. The csrc/sort.cu kernels are held to
`torch.argsort(stable=True)` and to these plain versions on the card (the
`cuda` tests and chip_smoke.py).

Tolerances: none. A permutation moves values, so every moved array
equals the reference's bit for bit, ties in their incoming lane order."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.core import sortutil as JS
from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import treelet as PT
from moonshine_tpu_torch.core import sortutil as S
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.scene import procedural

DEAD = S.DEAD_KEY


def _keys(rs, n, live, dead_share=0.3):
    """int32 keys in [0, live), a share of them dead."""
    key = rs.randint(0, live, n).astype(np.int32)
    key[rs.rand(n) < dead_share] = DEAD
    return key


def _columns(rs, n):
    """One array of each kind the sites move: bool, int32, int64 (values
    of either sign past 2^31 too), float32 [N] and [N, 3]."""
    return [rs.rand(n) > 0.5,
            rs.randint(-2**31, 2**31 - 1, n).astype(np.int32),
            (rs.randint(-2**31, 2**31 - 1, n).astype(np.int64) << 20)
            + rs.randint(0, 2**20, n),
            rs.randn(n).astype(np.float32),
            rs.randn(n, 3).astype(np.float32)]


def _against_reference(key, cols, bits):
    """The port's sort_lanes against the reference's sort_lanes (int64
    columns, which the reference holds as int32 without x64, against
    numpy's stable order) bit for bit."""
    perm, got = S.sort_lanes(torch.from_numpy(key),
                             [torch.from_numpy(c) for c in cols], bits)
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    assert perm.dtype == torch.int32
    small = [c for c in cols if c.dtype != np.int64]
    want_key, want = JS.sort_lanes(jnp.asarray(key),
                                   [jnp.asarray(c) for c in small])
    np.testing.assert_array_equal(key[perm.numpy()], np.asarray(want_key))
    want = iter(want)
    for c, g in zip(cols, got):
        assert g.dtype == torch.from_numpy(c).dtype and g.shape == c.shape
        w = c[order] if c.dtype == np.int64 else np.asarray(next(want))
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 8193])
@pytest.mark.parametrize("case", ["ties", "all dead", "distinct"])
def test_sort_lanes_matches_reference(n, case):
    rs = np.random.RandomState(n + len(case))
    if case == "ties":  # four keys and the dead one over n lanes
        key = _keys(rs, n, 4)
    elif case == "all dead":
        key = np.full(n, DEAD, np.int32)
    else:
        key = rs.permutation(n).astype(np.int32)
    _against_reference(key, _columns(rs, n), max(n - 1, 0).bit_length())


def _site_keys(site, n, seed):
    """(key int32 [n], bits) as each site makes them from seeded rays."""
    rs = np.random.RandomState(seed)
    world, _ = procedural.room_scene(grid=2, subdivisions=2)
    scene = world.build("cpu")
    lo, hi = scene.wide.bounds.numpy()
    o = torch.from_numpy((lo + rs.rand(n, 3) * (hi - lo) * 1.2
                          - 0.1 * (hi - lo)).astype(np.float32))
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32))
    active = torch.from_numpy(rs.rand(n) > 0.3)
    if site == "resort":
        return (S.coherence_key(o, d, scene.wide.bounds, P.RESORT_CELLS,
                                active), P.RESORT_BITS)
    if site == "packet":
        return PP.sort_key(scene.wide, o, d, active), PP.SORT_KEY_BITS
    k = 379  # treelet_1080p's treelet count
    nearest = torch.from_numpy(rs.randint(0, k + 1, n).astype(np.int32))
    wbvh = scene.wide._replace(t_roots=torch.zeros(k, dtype=torch.int32))
    key = nearest * PT.MAX_KEYED + PP.sort_key(wbvh, o, d)
    assert torch.equal(key, S.coherence_key(o, d, wbvh.bounds, PP.SORT_CELLS,
                                            major=nearest))
    return key, PT.key_bits(wbvh)


@pytest.mark.parametrize("site", ["resort", "packet", "treelet"])
def test_site_keys_sort_as_the_reference(site):
    """Each site's key: within its stated range or dead, int32, and
    sorted as the reference sorts it."""
    key, bits = _site_keys(site, 4097, 7)
    assert key.dtype == torch.int32
    k = key.numpy()
    assert ((k >= 0) & (k < 1 << bits) | (k == DEAD)).all()
    assert (k == DEAD).any() == (site != "treelet")
    rs = np.random.RandomState(8)
    _against_reference(k, _columns(rs, k.shape[0]), bits)


@pytest.mark.parametrize("cells", [4, 8])
def test_coherence_key_matches_reference(cells):
    """coherence_key's plain version against the reference's key
    expressions (accel/packet.py `_sort_key` for 4^3 cells; the resort's,
    integrator/path.py, for 8^3) bit for bit, on origins inside and
    outside the box and directions with zero components; with `major`
    as the treelet dispatch forms its key."""
    from moonshine_tpu.accel import packet as JP

    rs = np.random.RandomState(cells)
    n = 4099
    bounds = np.array([[-1.5, 0.0, 2.0], [3.0, 4.5, 2.0]], np.float32)
    o = (bounds[0] - 1 + rs.rand(n, 3) * 7).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d[rs.rand(n, 3) < 0.1] = 0.0
    active = rs.rand(n) > 0.3
    major = rs.randint(0, 40, n).astype(np.int32)
    got = S.coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(bounds), cells,
                          torch.from_numpy(active)).numpy()
    lo = jnp.asarray(bounds[0])
    inv_ext = 1.0 / jnp.maximum(jnp.asarray(bounds[1]) - lo, 1e-20)
    if cells == 4:
        tree = types.SimpleNamespace(bounds=jnp.asarray(bounds))
        want = np.asarray(JP._sort_key(tree, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(active)))
    else:  # moonshine_tpu/integrator/path.py _resort_state's key
        cell = jnp.clip(((jnp.asarray(o) - lo) * inv_ext * 8.0).astype(
            jnp.int32), 0, 7)
        dj = jnp.asarray(d)
        octant = ((dj[:, 0] > 0).astype(jnp.int32) * 4
                  + (dj[:, 1] > 0).astype(jnp.int32) * 2
                  + (dj[:, 2] > 0).astype(jnp.int32))
        key = ((cell[:, 0] * 8 + cell[:, 1]) * 8 + cell[:, 2]) * 8 + octant
        want = np.asarray(jnp.where(jnp.asarray(active), key, DEAD))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.max() == DEAD
    assert got[active].max() < 1 << S.key_bits(cells)
    with_major = S.coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(bounds), cells,
                                 major=torch.from_numpy(major)).numpy()
    no_mask = S.coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(bounds), cells).numpy()
    np.testing.assert_array_equal(
        with_major, major * cells ** 3 * 8 + no_mask)


def test_rows_and_out():
    """`rows` writes each output's first rows (by the permutation below
    the key's length, where they lie past it) into `out`, and nothing
    else of it."""
    rs = np.random.RandomState(2)
    n, m = 300, 500
    key = _keys(rs, n, 64)
    a = rs.randn(m, 3).astype(np.float32)
    b = rs.randint(0, 9, m).astype(np.int64)
    out = [torch.full((m, 3), -7.0), torch.full((m,), -7, dtype=torch.int64)]
    perm, got = S.sort_lanes(torch.from_numpy(key),
                             [torch.from_numpy(a), torch.from_numpy(b)], 6,
                             out=out, rows=[120, 450])
    order = np.argsort(key, kind="stable")
    assert got[0] is out[0] and got[1] is out[1]
    np.testing.assert_array_equal(out[0][:120].numpy(), a[order[:120]])
    assert (out[0][120:] == -7.0).all()
    np.testing.assert_array_equal(out[1][:n].numpy(), b[order])
    np.testing.assert_array_equal(out[1][n:450].numpy(), b[n:450])
    assert (out[1][450:] == -7).all()
    with pytest.raises(ValueError):
        S.sort_lanes(torch.from_numpy(key), [torch.from_numpy(a[:n - 1])],
                     6)


@pytest.mark.parametrize("n", [0, 1, 4097])
def test_unsort_lanes_inverts_the_sort(n):
    rs = np.random.RandomState(n)
    key = torch.from_numpy(_keys(rs, n, 9))
    cols = [torch.from_numpy(c) for c in _columns(rs, n)]
    perm, moved = S.sort_lanes(key, cols, 4)
    back = S.unsort_lanes(perm, moved)
    for c, g in zip(cols, back):
        assert torch.equal(c, g)


@pytest.mark.parametrize("bits", [0, 9, 12, 18])
def test_keys_past_the_range_sort_as_one_value(bits):
    """A key past [0, 2^bits), a negative one too, sorts as one value after
    every key in it, in lane order (the card's order too), and moves
    its lanes along; keys in range keep their stable argsort order."""
    rs = np.random.RandomState(bits)
    n = 5000
    live = 1 << bits
    key = rs.randint(0, live, n).astype(np.int32)
    wild = rs.rand(n)
    key[wild < 0.1] = DEAD
    key[(wild >= 0.1) & (wild < 0.2)] = -rs.randint(1, 2**31 - 1)
    key[(wild >= 0.2) & (wild < 0.25)] = 2**31 - 1
    key[(wild >= 0.25) & (wild < 0.3)] = live
    col = rs.randn(n, 3).astype(np.float32)
    perm, (got,) = S.sort_lanes(torch.from_numpy(key),
                                [torch.from_numpy(col)], bits)
    inside = (key >= 0) & (key < live)
    want = np.concatenate([np.flatnonzero(inside)[np.argsort(
        key[inside], kind="stable")], np.flatnonzero(~inside)])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), col[want])
    np.testing.assert_array_equal(
        S.mapped_key(torch.from_numpy(key), bits).numpy(),
        np.where(inside, key, live))


def test_sort_refuses_other_devices():
    key = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        S.sort_lanes(key, [], 2)
    with pytest.raises(ValueError):
        S.sort_lanes(torch.zeros(4, dtype=torch.int32), [], 31)
