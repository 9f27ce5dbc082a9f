"""The port's treelet schedule and treelet traversal against
moonshine_tpu/accel/treelet.py (Pallas kernel in interpret mode) and
against the port's own packet traversal, on the cases of
tests/test_treelet.py: 8-wide / 8-slot trees of up to 1500 triangles with
small `max_rows`, so that the tree splits into many treelets.

Tolerances: treelet plans, treelet boxes, pending words and nearest
treelets are equal bit for bit. Against the JAX kernel, is_hit and any
hit are equal, tri is equal except where the two t are equal (a tie may
keep either triangle), t agrees to 2e-6 relative plus 1e-6 absolute and
u, v to 1e-5: XLA's CPU compiler fuses the Moller-Trumbore products
differently from torch's separately rounded ones (a few ulps of t, more
relative to a t near 0 where the products cancel). Against the port's packet
plain version, which evaluates the same triangle expressions, t and is_hit
are equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.accel import treelet as JT
from moonshine_tpu.accel import wide as JW
from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import treelet as PT
from moonshine_tpu_torch.accel import wide as PW

from test_bvh import random_rays, random_tris

T_TOL = dict(rtol=2e-6, atol=1e-6)
UV_ATOL = 1e-5


def _pair(n_tris, seed, max_rows=48):
    """(JAX WideBVH with its treelet plan, port WideBVH) of one scene."""
    tris = random_tris(n_tris, seed=seed)
    jw, topo = JW.build_wide(tris, with_topology=True)
    roots = JW.plan_treelets(topo.ptr, max_rows=max_rows)
    lo, hi = JW._treelet_boxes(roots, np.asarray(jw.nodes),
                               np.asarray(jw.leaves))
    jw = jw._replace(t_roots=jnp.asarray(roots.astype(np.int32)),
                     t_lo=jnp.asarray(lo), t_hi=jnp.asarray(hi))
    pw = PW.build_wide(tris, device="cpu", max_rows=max_rows)
    return jw, pw


def _rays(n, seed, dead=0.2):
    o, d = random_rays(n, seed=seed)
    rs = np.random.RandomState(seed)
    active = rs.rand(n) > dead
    t_max = (rs.rand(n) * 12.0).astype(np.float32)
    return np.asarray(o), np.asarray(d), active, t_max


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n_tris,seed,max_rows", [(1500, 3, 48),
                                                  (800, 4, 48),
                                                  (1500, 3, 3),
                                                  (900, 5, None)])
def test_plan_and_boxes_match_reference(n_tris, seed, max_rows):
    tris = random_tris(n_tris, seed=seed)
    jw, topo = JW.build_wide(tris, with_topology=True)
    roots = JW.plan_treelets(topo.ptr, max_rows=max_rows)
    lo, hi = JW._treelet_boxes(roots, np.asarray(jw.nodes),
                               np.asarray(jw.leaves))
    pw = PW.build_wide(tris, device="cpu", max_rows=max_rows)
    np.testing.assert_array_equal(pw.t_roots.numpy(), roots)
    np.testing.assert_array_equal(pw.t_lo.numpy(), lo)
    np.testing.assert_array_equal(pw.t_hi.numpy(), hi)
    if max_rows is None:  # the default plan rides on the JAX tree too
        np.testing.assert_array_equal(pw.t_roots.numpy(),
                                      np.asarray(jw.t_roots))


@pytest.mark.parametrize("max_rows", [48, 3])
def test_pending_masks_match_reference(max_rows):
    """Bit words and nearest treelets equal the reference's; max_rows=3
    gives K > 32, so words carry bit 31 (negative in int32)."""
    jw, pw = _pair(1500, 3, max_rows)
    o, d, active, _ = _rays(2000, 6)
    t_eff = np.where(active, np.float32(1e12), np.float32(-1e30))
    t_eff[::7] = 2.5  # finite t_max prunes treelets beyond it
    jp, jn = JT._pending_masks(jw, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_eff))
    pp, pn = PT._pending_masks(pw, *_t(o, d, t_eff))
    assert pp.dtype == torch.int32 and pn.dtype == torch.int32
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    K = pw.t_roots.shape[0]
    assert (pn.numpy() < K).sum() > 100
    if K > 32:
        assert (pp.numpy() < 0).any()


def test_pending_masks_chunking(monkeypatch):
    """Chunking phase 1 over lanes does not change a word."""
    _, pw = _pair(1500, 3, 3)
    o, d, _, t_max = _rays(1000, 7)
    want = PT._pending_masks(pw, *_t(o, d, t_max))
    monkeypatch.setattr(PT, "PENDING_CHUNK", 96)
    got = PT._pending_masks(pw, *_t(o, d, t_max))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_tris,seed,max_rows", [(900, 5, 48),
                                                  (1200, 7, 24)])
def test_closest_hit_matches_reference(n_tris, seed, max_rows):
    jw, pw = _pair(n_tris, seed, max_rows)
    o, d, active, _ = _rays(700, seed + 1)
    want = JT.closest_hit_treelet(jw, jnp.asarray(o), jnp.asarray(d), 1e12,
                                  active_in=jnp.asarray(active),
                                  interpret=True)
    got = PT.closest_hit_treelet(pw, *_t(o, d), 1e12,
                                 active_in=torch.from_numpy(active))
    w_tri, g_tri = np.asarray(want.tri), got.tri.numpy()
    np.testing.assert_array_equal(g_tri >= 0, w_tri >= 0)
    hit = w_tri >= 0
    assert hit.sum() >= 20 and not hit[~active].any()
    w_t, g_t = np.asarray(want.t), got.t.numpy()
    np.testing.assert_allclose(g_t[hit], w_t[hit], **T_TOL)
    np.testing.assert_array_equal(g_t[~hit], w_t[~hit])  # = t_max
    tie = hit & (g_tri != w_tri)
    np.testing.assert_allclose(g_t[tie], w_t[tie], **T_TOL)
    same = hit & (g_tri == w_tri)
    for g, w in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same],
                                   atol=UV_ATOL)
    assert (got.u.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("n_tris,seed,max_rows", [(900, 11, 48),
                                                  (1200, 13, 24)])
def test_any_hit_matches_reference(n_tris, seed, max_rows):
    jw, pw = _pair(n_tris, seed, max_rows)
    o, d, active, t_max = _rays(640, seed + 1)
    want = np.asarray(JT.any_hit_treelet(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        active_in=jnp.asarray(active), interpret=True))
    got = PT.any_hit_treelet(pw, *_t(o, d, t_max),
                             active_in=torch.from_numpy(active))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 10 and not want[~active].any()


@pytest.mark.parametrize("max_rows", [48, 3])
def test_treelet_matches_packet_plain(max_rows):
    """On one tree the treelet schedule finds what the packet traversal
    finds: the same t (exactly), is_hit and occlusion."""
    _, pw = _pair(1500, 3, max_rows)
    o, d, active, t_max = _rays(3000, 9)
    o, d, act, tm = _t(o, d, active, t_max)
    want = PP.closest_hit_plain(pw, o, d, 1e12, active_in=act)
    got = PT.closest_hit_treelet(pw, o, d, 1e12, active_in=act)
    assert torch.equal(got.t, want.t)
    assert torch.equal(got.tri >= 0, want.tri >= 0)
    assert (got.tri == want.tri).float().mean() > 0.99
    occ = PT.any_hit_treelet(pw, o, d, tm, active_in=act)
    assert torch.equal(occ, PP.any_hit_plain(pw, o, d, tm, active_in=act))
    assert int(occ.sum()) > 50


def test_dead_lanes_scalar_tmax_and_counts():
    """Dead lanes return the caller's t_max, tri -1, u = v = 0; a scalar
    t_max equals the per-lane one; the CPU path launches no kernel; the
    counted plain version returns the same hits and what it visited."""
    _, pw = _pair(900, 5)
    o, d, active, _ = _rays(1500, 21)
    o, d, act = _t(o, d, active)
    PT.reset_launch_counts()
    h = PT.closest_hit_treelet(pw, o, d, torch.full((1500,), 3.0),
                               active_in=act)
    h2 = PT.closest_hit_treelet(pw, o, d, 3.0, active_in=act)
    for a, b in zip(h, h2):
        assert torch.equal(a, b)
    dead = ~act
    assert (h.tri[dead] == -1).all() and (h.t[dead] == 3.0).all()
    assert (h.u[dead] == 0).all() and (h.v[dead] == 0).all()
    assert (h.t[h.tri >= 0] < 3.0).all()
    assert torch.equal(PT.any_hit_treelet(pw, o, d, 3.0, active_in=act),
                       h.tri >= 0)
    assert PT.LAUNCHES == {"treelet_pending": 0, "treelet_closest_hit": 0,
                           "treelet_any_hit": 0}
    h3, visits = PT.closest_hit_treelet_plain(pw, o, d, 3.0, active_in=act,
                                              count_visits=True)
    for a, b in zip(h, h3):
        assert torch.equal(a, b)
    assert 0 < visits.node_rows <= pw.num_nodes
    assert 0 < visits.leaf_rows <= pw.num_leaves
    assert visits.nodes >= visits.node_rows
    assert visits.leaf_tris <= visits.leaves * pw.leaf_slots


def test_available_follows_the_reference():
    _, pw = _pair(900, 5)
    assert PT.available(pw)
    assert not PT.available(pw._replace(t_roots=None))
    assert not PT.available(pw._replace(t_roots=pw.t_roots[:1]))
    wide16 = PW.build_wide(random_tris(900, seed=5), width=16, leaf_cap=12,
                           device="cpu")
    assert not PT.available(wide16)
    o, d, _, _ = _rays(10, 1)
    with pytest.raises(ValueError, match="treelet plan"):
        PT.closest_hit_treelet(pw._replace(t_roots=None), *_t(o, d), 1e12)


def _subtree_levels(ptr, r):
    """Node levels of the subtree under wide row r, walked recursively."""
    kids = [int(c) for c in ptr[r] if c >= 0]
    return 1 + max((_subtree_levels(ptr, c) for c in kids), default=0)


@pytest.mark.parametrize("n_tris,seed,max_rows", [(1500, 3, 48),
                                                  (1500, 3, 3),
                                                  (900, 5, None),
                                                  (1500, 3, 10**9)])
def test_treelet_boxes_bound_their_root_rows(n_tris, seed, max_rows):
    """The premise of the closest-hit skip: a node treelet's box is
    exactly the min / max of its root row's occupied child boxes, and
    every child box has lo <= hi, so a ray's entry into any child is at
    or beyond its entry into the box. Also the treelet stack bound:
    (width - 1) * the deepest treelet's node levels + 1, at most the
    tree's max_stack (max_rows=10**9 makes the whole tree one treelet)."""
    pw = PW.build_wide(random_tris(n_tris, seed=seed), device="cpu",
                       max_rows=max_rows)
    w = pw.width
    rows = pw.nodes.reshape(pw.num_nodes, -1).numpy()
    roots = pw.t_roots.numpy()
    node_roots = roots[roots >= 0]
    assert len(node_roots) >= 1
    for t in np.nonzero(roots >= 0)[0]:
        row = rows[roots[t]]
        used = row[6 * w:7 * w] != -1.0
        lo = row[0:3 * w].reshape(3, w)[:, used]
        hi = row[3 * w:6 * w].reshape(3, w)[:, used]
        assert (lo <= hi).all()
        np.testing.assert_array_equal(pw.t_lo[t].numpy(), lo.min(axis=1))
        np.testing.assert_array_equal(pw.t_hi[t].numpy(), hi.max(axis=1))
    ptr = rows[:, 6 * w:7 * w].astype(np.int64)
    levels = max(_subtree_levels(ptr, r) for r in node_roots)
    assert pw.treelet_stack == (w - 1) * levels + 1 <= pw.max_stack
    if max_rows == 10**9:
        assert len(roots) == 1 and pw.treelet_stack == pw.max_stack


@pytest.mark.parametrize("n_tris,seed,max_rows", [(900, 5, 48),
                                                  (1200, 7, 24)])
def test_skip_beyond_t_best_keeps_the_hits(n_tris, seed, max_rows):
    """The plain dispatch with the skip (the kernel's rule) gives the JAX
    kernel's hits (interpret mode; tolerances as in
    test_closest_hit_matches_reference) and, bit for bit, what the walk
    without the skip gives, in fewer node visits: exactly one fewer for
    each skipped (lane, treelet) root. The walk without the skip is the
    same dispatch with unbounded treelet boxes, which no ray enters
    beyond its t_best (the boxes matter to the walk only there)."""
    jw, pw = _pair(n_tris, seed, max_rows)
    o, d, active, _ = _rays(700, seed + 1)
    want = JT.closest_hit_treelet(jw, jnp.asarray(o), jnp.asarray(d), 1e12,
                                  active_in=jnp.asarray(active),
                                  interpret=True)
    o_t, d_t, act = _t(o, d, active)
    t_eff = torch.where(act, torch.tensor(1e12), torch.tensor(-1e30))
    perm, srt = PT._sort_lanes(pw, o_t, d_t, t_eff)
    unsort = lambda x: torch.empty_like(x).index_copy_(0, perm.long(), x)
    unbounded = pw._replace(t_lo=torch.full_like(pw.t_lo, -np.inf),
                            t_hi=torch.full_like(pw.t_hi, np.inf))
    h, v = PT._dispatch_plain(pw, *srt, False, count_visits=True)
    h0, v0 = PT._dispatch_plain(unbounded, *srt, False, count_visits=True)
    for a, b in zip(h, h0):
        assert torch.equal(a, b)
    assert v.roots_skipped > 0 and v0.roots_skipped == 0
    assert v.nodes + v.roots_skipped == v0.nodes
    assert v.leaves == v0.leaves and v.leaf_tris == v0.leaf_tris
    got = PT.closest_hit_treelet(pw, o_t, d_t, 1e12, active_in=act)
    for a, b in zip(got, (unsort(x) for x in h)):
        np.testing.assert_array_equal(a.numpy()[act.numpy()],
                                      b.numpy()[act.numpy()])
    w_tri, g_tri = np.asarray(want.tri), got.tri.numpy()
    np.testing.assert_array_equal(g_tri >= 0, w_tri >= 0)
    hit = w_tri >= 0
    assert hit.sum() >= 20
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               **T_TOL)
    same = hit & (g_tri == w_tri)
    assert same.mean() > 0.9 * hit.mean()
    for g, w in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same],
                                   atol=UV_ATOL)


def test_one_treelet_is_the_whole_tree():
    """A plan of one treelet (the root) walks the whole tree under the
    treelet stack bound: the packet traversal's hits."""
    pw = PW.build_wide(random_tris(1500, seed=3), device="cpu",
                       max_rows=10**9)
    assert pw.t_roots.tolist() == [0]
    o, d, active, t_max = _rays(1500, 17)
    o, d, act, tm = _t(o, d, active, t_max)
    got = PT.closest_hit_treelet(pw, o, d, 1e12, active_in=act)
    want = PP.closest_hit_plain(pw, o, d, 1e12, active_in=act)
    assert torch.equal(got.t, want.t)
    assert torch.equal(got.tri >= 0, want.tri >= 0)
    assert torch.equal(PT.any_hit_treelet(pw, o, d, tm, active_in=act),
                       PP.any_hit_plain(pw, o, d, tm, active_in=act))


def _union_case(seed=11, k=100, n=4096):
    """Seeded treelet boxes and rays for phase 1's union premise: words of
    clustered boxes (as plan_treelets' depth-first ids make them) and of
    scattered ones, inverted boxes (lo 0, hi -1) among proper ones and one
    word of nothing else, a partial last word; rays with axis-parallel
    and zero direction components, rays inside boxes, t_max finite, 1e12,
    0 and negative."""
    rs = np.random.RandomState(seed)
    words = -(-k // 32)
    centre = rs.randn(words, 3) * 6
    centre[[0, 2], 0] += 20.0  # away from the inverted boxes' [-1, 0]^3
    spread = np.where(np.arange(words) % 2 == 0, 1.0, 6.0)[:, None]
    c = np.repeat(centre, 32, axis=0)[:k] + rs.randn(k, 3) * np.repeat(
        spread, 32, axis=0)[:k]
    ext = rs.rand(k, 3) * 1.5 + 0.05
    lo, hi = c - ext, c + ext
    inverted = rs.rand(k) < 0.1
    inverted[32:64] = True  # a word of inverted boxes alone
    lo[inverted], hi[inverted] = 0.0, -1.0
    o = rs.randn(n, 3) * 8
    inside = rs.rand(n) < 0.1
    o[inside] = c[rs.randint(0, k, int(inside.sum()))]
    o[:64] = rs.uniform(-1.0, 0.0, (64, 3))  # inside the inverted boxes
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axis = rs.rand(n) < 0.2
    d[axis] = np.eye(3)[rs.randint(0, 3, int(axis.sum()))] * rs.choice(
        [-1.0, 1.0], (int(axis.sum()), 1))
    d[rs.rand(n) < 0.1, 2] = 0.0
    t = np.where(rs.rand(n) < 0.5, 1e12, rs.rand(n) * 10)
    t[rs.rand(n) < 0.1] = 0.0
    t[rs.rand(n) < 0.1] = -1e30
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    tree = PW.WideBVH(*([None] * len(PW.WideBVH._fields)))._replace(
        t_roots=torch.arange(k, dtype=torch.int32), t_lo=f(lo), t_hi=f(hi))
    return tree, f(o), f(d), f(t), inverted


def test_word_unions_hold_every_entered_box():
    """The premise of phase 1's cull (csrc/treelet.cu): a ray that enters
    a treelet box, by phase 1's slab test, enters its word's union box
    (`treelet.word_unions`), inverted boxes and partial words included,
    so the words tested only where the union is entered equal the plain
    version's; and the unions of the proper boxes alone would not do:
    the slab test enters an inverted box (0, -1) as the box between its
    planes, [-1, 0]^3."""
    tree, o, d, t, inverted = _union_case()
    k = tree.t_roots.shape[0]
    pend, _ = PT._pending_masks_plain(tree, o, d, t)
    hit = PT.pending_bits(pend, k)
    entered = PT.entered_words(tree, o, d, t)
    word_hit = torch.stack([hit[:, w:w + 32].any(dim=1)
                            for w in range(0, k, 32)], dim=1)
    assert not (word_hit & ~entered).any()
    assert (entered & ~word_hit).any() and (~entered).any()
    culled = torch.where(entered, pend, torch.zeros_like(pend))
    assert torch.equal(culled, pend)
    assert (t <= 0).any() and not entered[t <= 0].any()
    # an all-inverted word: its union is [-1, 0]^3, entered from inside
    lo, hi = PT.word_unions(tree.t_lo, tree.t_hi)
    assert lo[1].tolist() == [-1.0] * 3 and hi[1].tolist() == [0.0] * 3
    assert hit[:64, 32:64].any()
    # each inverted box of a mixed word replaced by a proper one of it:
    # the union of the word's proper boxes alone
    mixed = [w for w in (0, 2, 3) if inverted[32 * w:32 * w + 32].any()]
    lo_p, hi_p = tree.t_lo.clone(), tree.t_hi.clone()
    for w in mixed:
        ids = np.arange(32 * w, min(32 * w + 32, k))
        first = ids[~inverted[ids]][0]
        lo_p[ids[inverted[ids]]] = tree.t_lo[first]
        hi_p[ids[inverted[ids]]] = tree.t_hi[first]
    entered_p = PT.entered_words(tree._replace(t_lo=lo_p, t_hi=hi_p), o, d,
                                 t)
    assert mixed and any((word_hit[:, w] & ~entered_p[:, w]).any()
                         for w in mixed)
