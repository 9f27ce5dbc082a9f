"""Wide BVH for packet traversal (port of the build path of
moonshine_tpu/accel/wide.py: `build_wide`, `assemble_rows`,
`plan_treelets` and `_treelet_boxes`).

Collapses the binary Karras or SAH tree into `width`-ary nodes (each wide
node repeatedly splits its largest-count child), bin-packs each node's
leaf children into fat leaves of up to `leaf_cap` fully unpacked
triangles, and sorts child slots along the node's dominant centroid axis.
It also partitions the tree into treelets (subtrees with their boxes),
the schedule of accel/treelet.py. The host build is numpy; `build_wide`
puts the rows on the requested device. Over a presplit binary tree
(`lbvh.build_sah(refs=...)`), `clip_sorted` carries the clipped reference
boxes, and leaf boxes are carved from them instead of from whole
triangles (build time only: the clipped boxes bound each leaf's part of
its triangles).

Row layout (w = width, S = leaf slots), as the reference documents it at
moonshine_tpu/accel/wide.py:283-297:

  nodes[m]:  cols c*w+j (c<6) = child-box component c of slot j
             (lox,loy,loz,hix,hiy,hiz); cols 6w+j = child pointer, f32
             (>= 0 wide node, -1 empty, <= -2 leaf ~ptr); col 7w = axis
  leaves[l]: cols c*S+j (c<9) = triangle component c of slot j
             (v0,e1,e2); cols 9S+j = original tri id (f32, -1 empty)

Records wider than 128 words are shaped [n, 2, 128] (256 words).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lbvh

LEAF_CAP = 8
WIDTH = 8
WIDTH_WIDE = 16


def _leaf_row_len(leaf_cap: int) -> int:
    return 128 if leaf_cap * 10 <= 128 else 256


def _node_row_len(width: int) -> int:
    return 128 if 7 * width + 1 <= 128 else 256


class WideTopology(NamedTuple):
    """Host record of the geometry-independent part of a wide BVH: the
    binary node behind each internal child slot, the child pointers, and
    each leaf bin's triangle ids."""

    int_ids: np.ndarray  # [W, width] i64 binary node per internal slot, -1 else
    ptr: np.ndarray  # [W, width] i64 child pointers (wide id / -1 / -2-leaf)
    node_axis: np.ndarray  # [W] i64
    orig: np.ndarray  # [L, cap] i64 original triangle ids
    in_range: np.ndarray  # [L, cap] bool occupied slots
    n_levels: int
    leaf_cap: int
    width: int
    # presplit builds: the clipped reference box of each leaf slot,
    # [L, cap, 3] each; None without presplit
    clip_lo: np.ndarray | None = None
    clip_hi: np.ndarray | None = None


class WideRows(NamedTuple):
    """Host result of `build_wide_rows` (numpy)."""

    nodes: np.ndarray  # [M, 128] or [M, 2, 128] f32
    leaves: np.ndarray  # [L, 128] or [L, 2, 128] f32
    bounds: np.ndarray  # [2, 3] f32
    n_levels: int
    t_roots: np.ndarray  # [K] i64 ptr-encoded treelet roots
    t_lo: np.ndarray  # [K, 3] f32
    t_hi: np.ndarray  # [K, 3] f32


class WideBVH(NamedTuple):
    """Device rows plus the tree's static facts as plain ints (the
    reference encodes depth, width and leaf slots in array shapes), and
    the treelet schedule: ptr-encoded subtree roots that tile the tree
    (>= 0 wide node, <= -2 leaf) with their boxes. The schedule is
    metadata only: traversal reads the same global rows."""

    nodes: torch.Tensor  # [M, 128] or [M, 2, 128] f32
    leaves: torch.Tensor  # [L, 128] or [L, 2, 128] f32
    bounds: torch.Tensor  # [2, 3] f32 scene AABB
    max_depth: int
    width: int
    leaf_slots: int
    num_nodes: int
    num_leaves: int
    num_tris: int
    t_roots: torch.Tensor | None = None  # [K] i32
    t_lo: torch.Tensor | None = None  # [K, 3] f32
    t_hi: torch.Tensor | None = None  # [K, 3] f32
    # rows 0..top_rows-1 are the root and its internal children (the rows
    # are breadth-first), as `top_rows` counts them from the root row
    top_rows: int = 1

    @property
    def max_stack(self) -> int:
        """Worst-case traversal stack occupancy: each visit pops one entry
        and pushes at most `width` children."""
        return (self.width - 1) * self.max_depth + 1


def assemble_rows(topo: WideTopology, b_min: np.ndarray, b_max: np.ndarray,
                  tri_verts: np.ndarray, use_clip: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Node/leaf rows from topology + binary-node AABBs + triangles.
    use_clip: leaf boxes from the topology's clipped reference boxes,
    when it carries them, instead of from the whole triangles."""
    W_n = len(topo.ptr)
    cap = topo.leaf_cap
    L = len(topo.orig)
    w = topo.width

    safe_orig = np.clip(topo.orig, 0, len(tri_verts) - 1)
    v = tri_verts[safe_orig]  # [L, cap, 3, 3]
    if use_clip and topo.clip_lo is not None:
        occ3 = topo.in_range[:, :, None]
        vlo = np.where(occ3, topo.clip_lo, np.inf).min(axis=1)
        vhi = np.where(occ3, topo.clip_hi, -np.inf).max(axis=1)
    else:
        occ = topo.in_range[:, :, None, None]
        vlo = np.where(occ, v, np.inf).min(axis=(1, 2))
        vhi = np.where(occ, v, -np.inf).max(axis=(1, 2))
    leaf_lo = np.where(np.isfinite(vlo), vlo, 0.0).astype(np.float32)
    leaf_hi = np.where(np.isfinite(vhi), vhi, 0.0).astype(np.float32)

    is_int = topo.int_ids >= 0
    is_leaf_slot = topo.ptr <= -2
    leaf_ids = np.where(is_leaf_slot, -2 - topo.ptr, 0)
    box_lo = np.zeros((W_n, w, 3), np.float32)
    box_hi = np.zeros((W_n, w, 3), np.float32)
    box_lo[is_int] = b_min[np.clip(topo.int_ids, 0, len(b_min) - 1)][is_int]
    box_hi[is_int] = b_max[np.clip(topo.int_ids, 0, len(b_max) - 1)][is_int]
    box_lo[is_leaf_slot] = leaf_lo[leaf_ids[is_leaf_slot]]
    box_hi[is_leaf_slot] = leaf_hi[leaf_ids[is_leaf_slot]]

    nodes = np.zeros((W_n, _node_row_len(w)), np.float32)
    nodes[:, 0:3 * w] = box_lo.transpose(0, 2, 1).reshape(W_n, 3 * w)
    nodes[:, 3 * w:6 * w] = box_hi.transpose(0, 2, 1).reshape(W_n, 3 * w)
    nodes[:, 6 * w:7 * w] = topo.ptr.astype(np.float32)
    nodes[:, 7 * w] = topo.node_axis.astype(np.float32)

    leaves = np.zeros((max(L, 1), _leaf_row_len(cap)), np.float32)
    leaves[:, 9 * cap:10 * cap] = -1.0
    if L:
        data = np.zeros((L, 9, cap), np.float32)
        data[:, 0:3] = v[:, :, 0].transpose(0, 2, 1)
        data[:, 3:6] = (v[:, :, 1] - v[:, :, 0]).transpose(0, 2, 1)
        data[:, 6:9] = (v[:, :, 2] - v[:, :, 0]).transpose(0, 2, 1)
        data *= topo.in_range[:, None, :]  # padding slots never hit
        leaves[:, 0:9 * cap] = data.reshape(L, 9 * cap)
        leaves[:, 9 * cap:10 * cap] = np.where(
            topo.in_range, topo.orig, -1).astype(np.float32)
    if nodes.shape[1] > 128:
        nodes = nodes.reshape(W_n, -1, 128)
    if leaves.shape[1] > 128:
        leaves = leaves.reshape(len(leaves), -1, 128)
    return nodes, leaves


def plan_treelets(ptr: np.ndarray, max_rows: int | None = None) -> np.ndarray:
    """Partition the wide tree into subtree treelets: walk down from the
    root, cutting a treelet wherever a subtree's row count (its node rows
    plus leaf rows) drops to `max_rows`. Leaf children hanging above a cut
    become singleton leaf treelets. Returns ptr-encoded roots covering
    every node and leaf exactly once; max_rows defaults to ~1/128 of the
    tree (at least 384)."""
    W = len(ptr)
    is_leaf_slot = ptr <= -2
    is_int_slot = ptr >= 0
    cost = 1 + is_leaf_slot.sum(axis=1).astype(np.int64)
    # children have larger wide ids than their parent (BFS layout), so one
    # reverse sweep accumulates subtree costs bottom-up
    child = np.clip(ptr, 0, W - 1)
    for r in range(W - 1, -1, -1):
        js = np.nonzero(is_int_slot[r])[0]
        if len(js):
            cost[r] += cost[child[r, js]].sum()
    total = int(cost[0])
    if max_rows is None:
        max_rows = max(384, total // 128)
    roots: list[int] = []
    stack = [0]
    while stack:
        r = stack.pop()
        if r <= -2 or cost[r] <= max_rows:
            roots.append(r)
            continue
        for j in range(ptr.shape[1]):
            c = int(ptr[r, j])
            if c != -1:
                stack.append(c)
    return np.asarray(roots, np.int64)


def _treelet_boxes(roots: np.ndarray, nodes: np.ndarray, leaves: np.ndarray,
                   w: int = WIDTH, cap: int = LEAF_CAP
                   ) -> tuple[np.ndarray, np.ndarray]:
    """AABB per treelet root from the assembled rows: a node treelet's box
    is the union of its row's occupied child boxes, a leaf treelet's box
    bounds its triangles; an empty one is inverted (never hit)."""
    nodes = nodes.reshape(len(nodes), -1)
    leaves = leaves.reshape(len(leaves), -1)
    K = len(roots)
    lo = np.zeros((K, 3), np.float32)
    hi = np.full((K, 3), -1.0, np.float32)
    is_node = roots >= 0
    if is_node.any():
        rows = nodes[roots[is_node].astype(np.int64)]
        slot_lo = rows[:, 0:3 * w].reshape(-1, 3, w)
        slot_hi = rows[:, 3 * w:6 * w].reshape(-1, 3, w)
        used = (rows[:, 6 * w:7 * w] != -1.0)[:, None, :]
        nlo = np.where(used, slot_lo, np.inf).min(axis=2)
        nhi = np.where(used, slot_hi, -np.inf).max(axis=2)
        ok = np.isfinite(nlo).all(axis=1, keepdims=True)
        lo[is_node] = np.where(ok, nlo, 0.0)
        hi[is_node] = np.where(ok, nhi, -1.0)
    is_leaf = ~is_node
    if is_leaf.any():
        lrows = leaves[(-2 - roots[is_leaf]).astype(np.int64)]
        data = lrows[:, 0:9 * cap].reshape(-1, 9, cap)
        v0 = data[:, 0:3]
        pts = np.stack([v0, v0 + data[:, 3:6], v0 + data[:, 6:9]], axis=0)
        occ = (lrows[:, 9 * cap:10 * cap] >= 0.0)[None, :, None, :]
        occ = np.broadcast_to(occ, pts.shape)
        llo = np.where(occ, pts, np.inf).min(axis=(0, 3))
        lhi = np.where(occ, pts, -np.inf).max(axis=(0, 3))
        ok = np.isfinite(llo).all(axis=1, keepdims=True)
        lo[is_leaf] = np.where(ok, llo, 0.0)
        hi[is_leaf] = np.where(ok, lhi, -1.0)
    return lo, hi


def build_wide_rows(tri_verts: np.ndarray, binary: lbvh.BVH | None = None,
                    leaf_cap: int = LEAF_CAP, width: int = WIDTH,
                    max_rows: int | None = None, clip_sorted=None
                    ) -> WideRows:
    """Host build of the rows and the treelet plan (`max_rows` as in
    plan_treelets). clip_sorted: (clip_lo, clip_hi) [R, 3], aligned with
    the binary tree's sorted order (lbvh.build_sah(refs=...)); leaf boxes
    then come from them."""
    if not 1 <= leaf_cap <= 24:
        raise ValueError(f"leaf_cap {leaf_cap} outside 1..24")
    if width not in (8, 16, 24, 32):
        raise ValueError(f"width {width} not in (8, 16, 24, 32)")
    tri_verts = np.asarray(tri_verts, np.float32)
    T = len(tri_verts)
    if binary is None:
        binary = lbvh.build(tri_verts, leaf_size=min(4, leaf_cap))

    b_left = np.asarray(binary.left).astype(np.int64)
    b_count = np.asarray(binary.count).astype(np.int64)
    b_escape = np.asarray(binary.escape).astype(np.int64)
    b_min = np.asarray(binary.aabb_min)
    b_max = np.asarray(binary.aabb_max)
    order = np.asarray(binary.tri_order).astype(np.int64)

    M = binary.num_nodes
    is_leaf = b_count > 0
    li_all = np.clip(b_left, 0, M - 1)  # left child (internal nodes)
    ri_all = np.clip(b_escape[li_all], 0, M - 1)  # right = escape(left)

    # triangle count + sorted-range start per binary node, bottom-up
    counts = np.where(is_leaf, b_count, 0)
    starts = np.where(is_leaf, b_left, -1)
    for _ in range(70):
        ready = ~is_leaf & (counts == 0)
        if not ready.any():
            break
        ok = ready & (counts[li_all] > 0) & (counts[ri_all] > 0)
        counts[ok] = (counts[li_all] + counts[ri_all])[ok]
        starts[ok] = np.minimum(starts[li_all], starts[ri_all])[ok]
    if not (counts > 0).all():
        raise RuntimeError("wide-BVH count propagation failed")

    # breadth-first expansion over flat frontiers of binary node ids
    frontier = np.asarray([[0] + [-1] * (width - 1)], np.int64)
    all_rows = []
    while len(frontier):
        slots = frontier.copy()
        # repeatedly split the largest splittable slot of each row
        for _ in range(width - 1):
            valid = slots >= 0
            sc = np.clip(slots, 0, M - 1)
            cnt = np.where(valid, counts[sc], -1)
            splittable = valid & ~is_leaf[sc] & (cnt > leaf_cap)
            has_free = (~valid).sum(axis=1) > 0
            cand = np.where(splittable, cnt, -1)
            best = cand.argmax(axis=1)
            rows = np.nonzero(
                has_free & (cand[np.arange(len(slots)), best] > 0))[0]
            if len(rows) == 0:
                break
            bcol = best[rows]
            node = slots[rows, bcol]
            slots[rows, bcol] = li_all[node]
            free_col = np.argmin(slots[rows] >= 0, axis=1)
            slots[rows, free_col] = ri_all[node]
        all_rows.append(slots)
        valid = slots >= 0
        child_internal = valid & (counts[np.clip(slots, 0, M - 1)] > leaf_cap)
        next_nodes = slots[child_internal]
        frontier = (
            np.concatenate([next_nodes[:, None],
                            np.full((len(next_nodes), width - 1), -1)], axis=1)
            if len(next_nodes) else np.zeros((0, width), np.int64)
        )

    slots_all = np.concatenate(all_rows, axis=0)
    W = len(slots_all)
    valid = slots_all >= 0
    sl = np.clip(slots_all, 0, M - 1)
    child_internal = valid & (counts[sl] > leaf_cap)
    child_leaf = valid & ~child_internal

    # wide ids of internal children: the next level's rows, in row-major
    # order of child_internal
    internal_order = (np.cumsum(child_internal.reshape(-1)) - 1).reshape(
        W, width)
    level_sizes = [len(r) for r in all_rows]
    level_of_row = np.repeat(np.arange(len(all_rows)), level_sizes)
    next_base = np.cumsum(level_sizes)
    int_before = np.zeros(len(all_rows) + 1, np.int64)
    row_starts = np.cumsum([0] + level_sizes)
    for k in range(len(all_rows)):
        int_before[k + 1] = int_before[k] + child_internal[
            row_starts[k]:row_starts[k + 1]].sum()
    child_wide_id = (next_base[level_of_row][:, None] + internal_order
                     - int_before[level_of_row][:, None])
    if W >= (1 << 24) or T >= (1 << 24):
        raise ValueError("f32 id encoding cap (2^24) exceeded")

    # leaf-bin packing: first-fit decreasing of each node's leaf children
    int_ids = np.full((W, width), -1, np.int64)
    ptr = np.full((W, width), -1, np.int64)
    orig_rows: list[np.ndarray] = []
    pos_rows: list[np.ndarray] = []  # sorted positions, for clipped boxes
    cent = np.zeros((W, width, 3), np.float64)
    with np.errstate(invalid="ignore"):
        b_cent = np.nan_to_num((b_min + b_max) * 0.5, posinf=0.0,
                               neginf=0.0)
    for r in range(W):
        col = 0
        for j in range(width):
            if child_internal[r, j]:
                int_ids[r, col] = slots_all[r, j]
                ptr[r, col] = child_wide_id[r, j]
                cent[r, col] = b_cent[slots_all[r, j]]
                col += 1
        js = [j for j in range(width) if child_leaf[r, j]]
        if not js:
            continue
        items = sorted(js, key=lambda j: -counts[slots_all[r, j]])
        bins: list[list[int]] = []
        bin_counts: list[int] = []
        for j in items:
            c = int(counts[slots_all[r, j]])
            for bi in range(len(bins)):
                if bin_counts[bi] + c <= leaf_cap:
                    bins[bi].append(j)
                    bin_counts[bi] += c
                    break
            else:
                bins.append([j])
                bin_counts.append(c)
        for members in bins:
            pos = np.concatenate([
                np.arange(starts[slots_all[r, j]],
                          starts[slots_all[r, j]] + counts[slots_all[r, j]])
                for j in members])
            orig_rows.append(order[pos])
            pos_rows.append(pos)
            ptr[r, col] = -2 - (len(orig_rows) - 1)
            cent[r, col] = b_cent[[slots_all[r, j] for j in members]].mean(
                axis=0)
            col += 1

    n_leaves = len(orig_rows)
    orig = np.full((max(n_leaves, 1), leaf_cap), -1, np.int64)
    in_range = np.zeros((max(n_leaves, 1), leaf_cap), bool)
    for i, ids in enumerate(orig_rows):
        orig[i, :len(ids)] = ids
        in_range[i, :len(ids)] = True
    orig = np.clip(orig, 0, max(T - 1, 0))
    clip_lo = clip_hi = None
    if clip_sorted is not None:
        clip_lo = np.zeros((max(n_leaves, 1), leaf_cap, 3), np.float32)
        clip_hi = np.zeros_like(clip_lo)
        for i, pos in enumerate(pos_rows):
            clip_lo[i, :len(pos)] = clip_sorted[0][pos]
            clip_hi[i, :len(pos)] = clip_sorted[1][pos]

    # ordered traversal: child slots ascending by centroid along the
    # node's dominant axis, recorded in col 7w
    slot_used = ptr != -1
    cmin = np.where(slot_used[:, :, None], cent, np.inf).min(axis=1)
    cmax = np.where(slot_used[:, :, None], cent, -np.inf).max(axis=1)
    spread = np.where(np.isfinite(cmin) & np.isfinite(cmax), cmax - cmin, 0.0)
    node_axis = spread.argmax(axis=1)
    key = np.where(
        slot_used,
        np.take_along_axis(cent, node_axis[:, None, None], axis=2)[..., 0],
        np.inf,
    )
    slot_order = np.argsort(key, axis=1, kind="stable")
    topo = WideTopology(
        int_ids=np.take_along_axis(int_ids, slot_order, axis=1),
        ptr=np.take_along_axis(ptr, slot_order, axis=1),
        node_axis=node_axis, orig=orig, in_range=in_range,
        n_levels=max(len(all_rows), 1), leaf_cap=leaf_cap, width=width,
        clip_lo=clip_lo, clip_hi=clip_hi,
    )
    nodes, leaves = assemble_rows(topo, b_min, b_max, tri_verts,
                                  use_clip=clip_sorted is not None)
    bounds = np.stack([tri_verts.min(axis=(0, 1)),
                       tri_verts.max(axis=(0, 1))]).astype(np.float32)
    roots = plan_treelets(topo.ptr, max_rows)
    t_lo, t_hi = _treelet_boxes(roots, nodes, leaves, width, leaf_cap)
    return WideRows(nodes, leaves, bounds, topo.n_levels, roots, t_lo, t_hi)


def wide_from_rows(nodes, leaves, bounds, max_depth: int, width: int,
                   leaf_slots: int, num_tris: int, device, t_roots=None,
                   t_lo=None, t_hi=None) -> WideBVH:
    """WideBVH with its rows on `device` (rows from either package)."""
    put = lambda a, dt=np.float32: (
        None if a is None else torch.tensor(np.asarray(a, dt), device=device))
    return WideBVH(
        nodes=put(nodes), leaves=put(leaves), bounds=put(bounds),
        max_depth=int(max_depth), width=int(width),
        leaf_slots=int(leaf_slots), num_nodes=len(nodes),
        num_leaves=len(leaves), num_tris=int(num_tris),
        t_roots=put(t_roots, np.int32), t_lo=put(t_lo), t_hi=put(t_hi),
        top_rows=top_rows(nodes, width),
    )


def top_rows(nodes, width: int) -> int:
    """1 + the root's internal children: in the breadth-first layout those
    children are rows 1..m, so rows 0..m are the top two levels."""
    root = np.asarray(nodes).reshape(len(nodes), -1)[0]
    return 1 + int((root[6 * width:7 * width] >= 0).sum())


def build_wide(tri_verts: np.ndarray, binary: lbvh.BVH | None = None,
               leaf_cap: int = LEAF_CAP, width: int = WIDTH,
               device="cuda", max_rows: int | None = None,
               clip_sorted=None) -> WideBVH:
    """tri_verts: [T, 3, 3] world space -> WideBVH on `device`
    (clip_sorted as in build_wide_rows)."""
    r = build_wide_rows(tri_verts, binary, leaf_cap, width, max_rows,
                        clip_sorted)
    return wide_from_rows(r.nodes, r.leaves, r.bounds, r.n_levels, width,
                          leaf_cap, len(tri_verts), device, r.t_roots,
                          r.t_lo, r.t_hi)
