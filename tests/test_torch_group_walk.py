"""The exactness argument of the group design of the packet kernels
(csrc/traverse.cu, over rows) and the format-V kernels (csrc/vpacket.cu,
over tiles), which share the walk of csrc/group_walk.cuh, on the CPU.

The kernels trace one ray with a group of G lanes. Over rows, lane k tests
children k, k + G, ... of a node and slots k, k + G, ... of a leaf. Over
tiles, lane k owns sublanes k, k + G, ... (G divides 8), so child or slot
j = 8g + s is lane s % G's: it reads a child's six bounds as one float4
and one float2 from its sublane, a slot's ten fields as two float4s and a
float2, and walks its slots column group by column group. Either way the group pushes
a node's hit children at positions counted from the group's hit mask (top
+ popc(hits above j) when the ray runs forward on the node's axis, else
top + popc(hits below j)), and takes a closest-hit leaf's result as the
lexicographic minimum of (t, slot) over the lanes by xor shuffles. The
model below does the same in Python, reading rows and tiles at the
kernels' addresses, and must give what packet._walk's sequential leaf loop
and flip-and-cumsum pushes give: the same visits and t, tri, u, v and
occlusion bit for bit, equal-t ties included (duplicated triangles;
overlapping triangles in one plane, which a ray crosses at one exactly
computed t). The kernels' shared-memory layouts (packet.kernel_layout,
vpacket.kernel_layout) are checked against the tree: rows 0..R-1 are the
root and its internal children, and the bytes fit a block."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import lbvh, packet, vpacket
from moonshine_tpu_torch.accel.wide import build_wide

WIDTHS = (8, 16, 24, 32)
CAPS = (1, 7, 12, 24)
GROUPS = (2, 4, 8, 16, 32)
# (record format, lanes a ray) of the model's cases: any power-of-two
# group over rows; over tiles a lane owns whole sublanes, so G divides 8
FORMAT_GROUPS = ([("rows", G) for G in GROUPS]
                 + [("tiles", G) for G in (1, 2, 4, 8)])
NO_SLOT = 2**31 - 1  # the kernel's INT_MAX: a lane without a valid slot
SUBLANE = 128  # floats a tile's sublane


def tie_scene(seed, n_tris=120, n_rays=96):
    """Seeded triangles with exact equal-t ties and rays that meet them,
    as float32 numpy: (tris [T, 3, 3], o, d, active, t_max).

    Ten triangles appear twice. Ten overlapping triangles lie in the
    plane z = 0.5 with corners on a 1.0 grid (e1 x e2 = 16 for each, so
    rays straight down from z = 3 meet each at t = 2.5 exactly). A third
    of the rays aim at a duplicated triangle, a sixth go straight down
    onto the plane, the rest are random; 15% are dead, and t_max is finite
    (0.5 to 12)."""
    rs = np.random.RandomState(seed)
    base = (rs.randn(n_tris, 1, 3) * 4 + rs.randn(n_tris, 3, 3) * 0.5)
    dup = base[rs.choice(n_tris, 10, replace=False)]
    plane = []
    for x0 in (-3.0, -2.0, -1.0, 0.0, 1.0):
        plane.append([[x0, -2, 0.5], [x0 + 4, -2, 0.5], [x0, 2, 0.5]])
        plane.append([[x0 + 4, 2, 0.5], [x0, 2, 0.5], [x0 + 4, -2, 0.5]])
    tris = np.concatenate([base, dup, np.asarray(plane)]).astype(np.float32)

    n_dup, n_down = n_rays // 3, n_rays // 6
    n_rand = n_rays - n_dup - n_down
    o_rand = rs.randn(n_rand, 3) * 6
    d_rand = rs.randn(n_rand, 3)
    aim = dup[rs.randint(0, len(dup), n_dup)].mean(axis=1)
    o_dup = aim + rs.randn(n_dup, 3) * 3
    d_dup = aim - o_dup
    o_down = np.stack([rs.randint(-8, 16, n_down) * 0.25,
                       rs.randint(-7, 8, n_down) * 0.25,
                       np.full(n_down, 3.0)], axis=1)
    d_down = np.tile([0.0, 0.0, -1.0], (n_down, 1))
    o = np.concatenate([o_rand, o_dup, o_down]).astype(np.float32)
    d = np.concatenate([d_rand, d_dup, d_down])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rs.rand(n_rays) > 0.15
    t_max = rs.uniform(0.5, 12.0, n_rays).astype(np.float32)
    return tris, o, d, active, t_max


def _popc(x: int) -> int:
    return bin(x).count("1")


def lane_slots(n: int, G: int, fmt: str) -> list:
    """The children (or slots) j < n that each lane of a group of G tests,
    in the order it tests them: over rows k, k + G, ...; over tiles those
    of its sublanes s = k, k + G, ..., column group g (j = 8g + s) by
    column group, so in rising j as well."""
    if fmt == "rows":
        return [list(range(k, n, G)) for k in range(G)]
    return [[8 * g + s for g in range(-(-n // 8)) for s in range(k, 8, G)
             if 8 * g + s < n] for k in range(G)]


def group_push(hit, ptr, fwd: bool, top: int, stack: list, lanes) -> int:
    """The group's pushes: lane k owns children lanes[k]; the hit mask is
    the OR of the lanes' masks, and each lane writes its hit children
    where the popcounts place them. Returns the new top."""
    lane_mask = [sum(1 << j for j in own if hit[j]) for own in lanes]
    mask = 0
    for m in lane_mask:  # __reduce_or_sync
        mask |= m
    for k, own in enumerate(lanes):
        for j in own:
            if lane_mask[k] >> j & 1:
                below = _popc(mask & ((1 << j) - 1))
                above = _popc(mask) - below - 1
                stack[top + (above if fwd else below)] = ptr[j]
    return top + _popc(mask)


def group_leaf_min(t, valid, lanes):
    """(t, slot) of the group's lexicographic minimum: each lane's first
    least valid t over its slots lanes[k], then the xor butterfly over the
    lanes; (inf, NO_SLOT) when no slot is valid. Every lane ends on the
    same pair."""
    G = len(lanes)
    best = []
    for own in lanes:
        bt, bs = np.float32(np.inf), NO_SLOT
        for j in own:
            if valid[j] and t[j] < bt:
                bt, bs = t[j], j
        best.append((bt, bs))
    off = G // 2
    while off:
        nxt = []
        for k in range(G):
            (bt, bs), (ot, os_) = best[k], best[k ^ off]
            take = ot < bt or (ot == bt and os_ < bs)
            nxt.append((ot, os_) if take else (bt, bs))
        best = nxt
        off //= 2
    assert all(x == best[0] for x in best)
    assert best[0][1] == NO_SLOT or best[0][1] in lanes[best[0][1] % G]
    return best[0]


def sequential_leaf(t, valid, t_best):
    """visit.cuh's and packet._walk's leaf loop: strict < against the
    running t_best, in slot order; the slot kept, or None."""
    slot = None
    for j in range(len(t)):
        if valid[j] and t[j] < t_best:
            t_best, slot = t[j], j
    return slot


def walk_push(hit, ptr, fwd: bool, top: int, stack: list) -> int:
    """packet._walk's pushes for one lane (flip when forward, cumsum)."""
    hit, ptr = torch.tensor([hit]), torch.tensor([ptr])
    if fwd:
        hit, ptr = hit.flip(1), ptr.flip(1)
    pos = top + torch.cumsum(hit.to(torch.int64), 1) - 1
    for p, x in zip(pos[hit].tolist(), ptr[hit].tolist()):
        stack[p] = x
    return top + int(hit.sum())


@pytest.mark.parametrize("fmt,G", FORMAT_GROUPS)
@pytest.mark.parametrize("cap", CAPS)
def test_leaf_min_is_the_sequential_choice(cap, fmt, G):
    """On seeded leaves with many equal t (values from a set of five),
    empty and failing slots: the group's (t, slot) minimum over slots that
    beat t_best is the slot the sequential loop keeps, and the slot's
    owner (slot % G, which shuffles out its u, v and triangle) tests it."""
    rs = np.random.RandomState(cap * 100 + G)
    lanes = lane_slots(cap, G, fmt)
    assert sorted(sum(lanes, [])) == list(range(cap))
    for _ in range(300):
        t = rs.choice(np.float32([0.5, 1.0, 1.0, 2.0, 7.25]), cap)
        raw = rs.rand(cap) > 0.3
        t_best = np.float32(rs.choice([1.0, 2.0, 100.0]))
        bt, bs = group_leaf_min(t, raw & (t < t_best), lanes)
        want = sequential_leaf(t, raw, t_best)
        assert (None if bs == NO_SLOT else bs) == want
        if want is not None:
            assert bt == t[want]


@pytest.mark.parametrize("fmt,G", FORMAT_GROUPS)
@pytest.mark.parametrize("width", WIDTHS)
def test_push_positions_are_the_walks(width, fmt, G):
    """On seeded hit masks and both directions, the popcount positions
    fill the stack as packet._walk's flip-and-cumsum pushes do; lane k
    owns the children j with j % G == k in both formats."""
    lanes = lane_slots(width, G, fmt)
    assert all(sorted(own) == list(range(k, width, G))
               for k, own in enumerate(lanes))
    rs = np.random.RandomState(width * 100 + G)
    for _ in range(100):
        hit = (rs.rand(width) < rs.choice([0.1, 0.5, 0.9])).tolist()
        ptr = rs.permutation(1000)[:width].tolist()
        fwd = bool(rs.rand() < 0.5)
        top = int(rs.randint(0, 5))
        want, got = [None] * (top + width), [None] * (top + width)
        n_want = walk_push(hit, ptr, fwd, top, want)
        assert group_push(hit, ptr, fwd, top, got, lanes) == n_want
        assert got == want


def vector_loads(rec, off: int, sizes) -> torch.Tensor:
    """rec[off:] read as the kernel's vector loads of `sizes` floats, each
    at an address aligned to its own size (tiles are 16-byte aligned)."""
    out = []
    for n in sizes:
        assert off % n == 0, f"a {4 * n}-byte load at float {off}"
        out.append(rec[off:off + n])
        off += n
    return torch.cat(out)


def records(wbvh, fmt: str):
    """(node, leaf) readers at the kernels' addresses: node(i) gives node
    record i's child bounds [w, 6] (lo xyz, hi xyz), pointers [w] and sort
    axis; leaf(i) leaf record i's fields [10, S]. Over tiles, child j = 8g
    + s is a float4 and a float2 (a float2 and a float4 at odd g) at
    sublane s, column 6g, and slot j two float4s and a float2 (a float2
    and two float4s at odd g) at column 10g."""
    w, S = wbvh.width, wbvh.leaf_slots
    if fmt == "rows":
        nodes = wbvh.nodes.reshape(wbvh.num_nodes, -1)
        leaves = wbvh.leaves.reshape(wbvh.num_leaves, -1)
        return (lambda i: (nodes[i][:6 * w].reshape(6, w).T,
                           nodes[i][6 * w:7 * w], float(nodes[i][7 * w])),
                lambda i: leaves[i][:10 * S].reshape(10, S))
    v = vpacket.v_from_wide(wbvh)
    nodes = v.nodes.reshape(len(v.nodes), -1)
    leaves = v.leaves.reshape(len(v.leaves), -1)

    def node(i):
        b = torch.stack([vector_loads(
            nodes[i], j % 8 * SUBLANE + 6 * (j // 8),
            (4, 2) if j // 8 % 2 == 0 else (2, 4)) for j in range(w)])
        return (b, nodes[i][vpacket.PTR_LANE0:vpacket.PTR_LANE0 + w],
                float(nodes[i][vpacket.AXIS_LANE]))

    def leaf(i):
        return torch.stack([vector_loads(
            leaves[i], j % 8 * SUBLANE + 10 * (j // 8),
            (4, 4, 2) if j // 8 % 2 == 0 else (2, 4, 4)) for j in range(S)], 1)

    return node, leaf


def group_walk(wbvh, o, d, t_max, active, any_hit: bool, G: int,
               fmt: str = "rows"):
    """The kernels' walk in Python, one ray at a time, with the group's
    pushes and leaf choice over the records of `fmt` (rows, or the tiles
    of the same tree); the child and triangle tests are the plain
    version's expressions. Returns (result as the plain versions give it,
    node visits, leaf visits)."""
    t_eff = torch.where(active, t_max, packet._NEG)
    r, _, _, _ = packet._plain_state(wbvh, o, d, t_eff, False)
    o_c, d_c, inv, oinv, _ = r
    w, S = wbvh.width, wbvh.leaf_slots
    node_rec, leaf_rec = records(wbvh, fmt)
    children, slots = lane_slots(w, G, fmt), lane_slots(S, G, fmt)
    n = o.shape[0]
    t_out, tri_out = t_max.clone(), torch.full((n,), -1, dtype=torch.int32)
    u_out, v_out = torch.zeros(n), torch.zeros(n)
    occ_out = torch.zeros(n, dtype=torch.bool)
    n_nodes = n_leaves = 0
    for i in range(n):
        tmax = t_eff[i]
        t_best, tri, u, v = tmax, -1, torch.tensor(0.0), torch.tensor(0.0)
        stack = [None] * wbvh.max_stack
        top = 0
        if tmax > 0:
            stack[0], top = 0, 1
        while top:
            top -= 1
            node = stack[top]
            if node >= 0:
                n_nodes += 1
                b, ptr, axis = node_rec(node)
                t0 = [b[:, c] * inv[c][i] - oinv[c][i] for c in range(3)]
                t1 = [b[:, 3 + c] * inv[c][i] - oinv[c][i]
                      for c in range(3)]
                tnear = torch.maximum(
                    torch.maximum(torch.minimum(t0[0], t1[0]),
                                  torch.minimum(t0[1], t1[1])),
                    torch.minimum(t0[2], t1[2]))
                tfar = torch.minimum(
                    torch.minimum(torch.maximum(t0[0], t1[0]),
                                  torch.maximum(t0[1], t1[1])),
                    torch.maximum(t0[2], t1[2]))
                prune = tmax if any_hit else t_best
                hit = ((torch.clamp_min(tnear, 0.0)
                        <= torch.minimum(tfar, prune)) & (ptr != -1.0))
                ax = 0 if axis < 0.5 else (1 if axis < 1.5 else 2)
                top = group_push(hit.tolist(), ptr.long().tolist(),
                                 bool(d_c[ax][i] >= 0.0), top, stack,
                                 children)
                continue
            n_leaves += 1
            f = leaf_rec(-2 - node)
            v0, e1, e2 = ([f[c] for c in range(b, b + 3)] for b in (0, 3, 6))
            oi = [x[i].expand(S) for x in o_c]
            di = [x[i].expand(S) for x in d_c]
            used = f[9] >= 0.0
            if any_hit:
                occ = (packet._tri_any(v0, e1, e2, oi, di, tmax)
                       & used).tolist()
                if any(any(occ[j] for j in own) for own in slots):
                    occ_out[i] = True  # __any_sync
                    break
                continue
            valid, t, uu, vv = packet._tri_closest(v0, e1, e2, oi, di,
                                                   t_best)
            bt, bs = group_leaf_min(t.numpy(), (valid & used).numpy(), slots)
            if bs != NO_SLOT:
                t_best, tri, u, v = t[bs], int(f[9, bs]), uu[bs], vv[bs]
        if tri >= 0:
            t_out[i], tri_out[i], u_out[i], v_out[i] = t_best, tri, u, v
    out = occ_out if any_hit else packet.Hit(t_out, tri_out, u_out, v_out)
    return out, n_nodes, n_leaves


def _tensors(o, d, active, t_max):
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(active), torch.from_numpy(t_max))


@pytest.mark.parametrize("fmt", ["rows", "tiles"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("width", WIDTHS)
def test_group_walk_equals_plain_walk(width, cap, fmt):
    """The model's walk against the plain versions on a tree with exact
    ties: over rows (G = 2 and 4, the packet kernels' group sizes, and 8)
    closest_hit_plain and any_hit_plain, over tiles (G = 1, 2, 4 and 8)
    vpacket's and packet's; the same visits, and t, tri, u, v and
    occlusion bit for bit."""
    tris, *rays = tie_scene(seed=width + cap, n_tris=100, n_rays=48)
    o, d, active, t_max = _tensors(*rays)
    wbvh = build_wide(tris, leaf_cap=cap, width=width, device="cpu")
    want, vis = packet.closest_hit_plain(wbvh, o, d, t_max, active,
                                         count_visits=True)
    occ_want, occ_vis = packet.any_hit_plain(wbvh, o, d, t_max, active,
                                             count_visits=True)
    assert int(want.is_hit.sum()) >= 10
    if fmt == "tiles":
        v = vpacket.v_from_wide(wbvh)
        v_want, v_vis = vpacket.closest_hit_plain(v, o, d, t_max, active,
                                                  count_visits=True)
        v_occ, v_occ_vis = vpacket.any_hit_plain(v, o, d, t_max, active,
                                                 count_visits=True)
        assert all(torch.equal(g, x) for g, x in zip(v_want, want))
        assert torch.equal(v_occ, occ_want)
        assert (v_vis, v_occ_vis) == (vis, occ_vis)
    for G in ((2, 4, 8) if fmt == "rows" else (1, 2, 4, 8)):
        got, n_nodes, n_leaves = group_walk(wbvh, o, d, t_max, active,
                                            False, G, fmt)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        assert (n_nodes, n_leaves) == (vis.nodes, vis.leaves)
        occ, n_nodes, n_leaves = group_walk(wbvh, o, d, t_max, active,
                                            True, G, fmt)
        assert torch.equal(occ, occ_want)
        assert (n_nodes, n_leaves) == (occ_vis.nodes, occ_vis.leaves)


def test_tie_scene_has_ties():
    """The scene's rays meet exact equal-t hits: by brute force over every
    triangle (the plain closest-hit test), at least ten rays have two or
    more triangles at their least t."""
    tris, o, d, _, _ = tie_scene(seed=3)
    v = torch.from_numpy(tris)
    v0, e1, e2 = (list(x.T) for x in (v[:, 0], v[:, 1] - v[:, 0],
                                      v[:, 2] - v[:, 0]))
    ties = 0
    for i in range(len(o)):
        oi = [torch.tensor(x).expand(len(tris)) for x in o[i]]
        di = [torch.tensor(x).expand(len(tris)) for x in d[i]]
        valid, t, _, _ = packet._tri_closest(v0, e1, e2, oi, di,
                                             torch.tensor(1e12))
        if valid.any():
            ties += int((t[valid] == t[valid].min()).sum() >= 2)
    assert ties >= 10


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_top_rows_are_root_and_level_one(builder, width):
    """kernel_layout's R: rows 1..R-1 are exactly the root's internal
    children, and no deeper row points below R."""
    tris, *_ = tie_scene(seed=width, n_tris=3000, n_rays=6)
    binary = lbvh.build_sah(tris, leaf_size=4) if builder == "sah" else None
    wbvh = build_wide(tris, binary, leaf_cap=7, width=width, device="cpu")
    R = packet.kernel_layout(wbvh).top_rows
    ptr = wbvh.nodes.reshape(wbvh.num_nodes, -1)[:, 6 * width:7 * width]
    kids = sorted(int(p) for p in ptr[0] if p >= 0)
    assert 2 < R <= width + 1
    assert kids == list(range(1, R))
    deeper = ptr[1:]
    assert not ((deeper >= 0) & (deeper < R)).any()


@pytest.mark.parametrize("fmt", ["rows", "tiles"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("width", WIDTHS)
def test_shared_bytes_fit_a_block(width, cap, fmt):
    """At the deepest tree the kernels take (a stack of 512 entries) and
    the most top records a width can have (rows: the root and its
    internal children; tiles: none), the block's shared memory stays
    within the card's 227 KB."""
    tris, *_ = tie_scene(seed=cap, n_tris=60, n_rays=6)
    wbvh = build_wide(tris, leaf_cap=cap, width=width, device="cpu")
    depth = (packet.STACK_DEPTH - 1) // (width - 1)
    if fmt == "rows":
        tree = wbvh._replace(max_depth=depth, top_rows=width + 1)
        layout, top = packet.kernel_layout(tree), width + 1
        record = wbvh.nodes[0].numel() * 4
    else:
        tree = vpacket.v_from_wide(wbvh)._replace(max_depth=depth)
        layout, top = vpacket.kernel_layout(tree), 0
        record = 8 * SUBLANE * 4
    assert 256 < layout.stack_depth <= packet.STACK_DEPTH == 512
    assert layout.top_rows == top
    assert layout.shared_bytes <= packet.SHARED_BYTES_MAX
    assert layout.shared_bytes == (
        top * record + packet.GROUPS_PER_BLOCK * layout.stack_depth * 4)
