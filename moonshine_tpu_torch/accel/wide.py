"""Wide BVH for packet traversal (port of the build path of
moonshine_tpu/accel/wide.py: `build_wide` and `assemble_rows`).

Collapses the binary Karras tree into `width`-ary nodes (each wide node
repeatedly splits its largest-count child), bin-packs each node's leaf
children into fat leaves of up to `leaf_cap` fully unpacked triangles,
and sorts child slots along the node's dominant centroid axis. The host
build is numpy; `build_wide` puts the rows on the requested device.

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


class WideBVH(NamedTuple):
    """Device rows plus the tree's static facts as plain ints (the
    reference encodes depth, width and leaf slots in array shapes)."""

    nodes: torch.Tensor  # [M, 128] or [M, 2, 128] f32
    leaves: torch.Tensor  # [L, 128] or [L, 2, 128] f32
    bounds: torch.Tensor  # [2, 3] f32 scene AABB
    max_depth: int
    width: int
    leaf_slots: int
    num_nodes: int
    num_leaves: int
    num_tris: int

    @property
    def max_stack(self) -> int:
        """Worst-case traversal stack occupancy: each visit pops one entry
        and pushes at most `width` children."""
        return (self.width - 1) * self.max_depth + 1


def assemble_rows(topo: WideTopology, b_min: np.ndarray, b_max: np.ndarray,
                  tri_verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Node/leaf rows from topology + binary-node AABBs + triangles."""
    W_n = len(topo.ptr)
    cap = topo.leaf_cap
    L = len(topo.orig)
    w = topo.width

    safe_orig = np.clip(topo.orig, 0, len(tri_verts) - 1)
    v = tri_verts[safe_orig]  # [L, cap, 3, 3]
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


def build_wide_rows(tri_verts: np.ndarray, binary: lbvh.BVH | None = None,
                    leaf_cap: int = LEAF_CAP, width: int = WIDTH):
    """Host build. Returns (nodes, leaves, bounds, n_levels) as numpy."""
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
            orig_rows.append(np.concatenate([
                order[starts[slots_all[r, j]]:
                      starts[slots_all[r, j]] + counts[slots_all[r, j]]]
                for j in members
            ]))
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
    )
    nodes, leaves = assemble_rows(topo, b_min, b_max, tri_verts)
    bounds = np.stack([tri_verts.min(axis=(0, 1)),
                       tri_verts.max(axis=(0, 1))]).astype(np.float32)
    return nodes, leaves, bounds, topo.n_levels


def wide_from_rows(nodes, leaves, bounds, max_depth: int, width: int,
                   leaf_slots: int, num_tris: int, device) -> WideBVH:
    """WideBVH with its rows on `device` (rows from either package)."""
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return WideBVH(
        nodes=put(nodes), leaves=put(leaves), bounds=put(bounds),
        max_depth=int(max_depth), width=int(width),
        leaf_slots=int(leaf_slots), num_nodes=len(nodes),
        num_leaves=len(leaves), num_tris=int(num_tris),
    )


def build_wide(tri_verts: np.ndarray, binary: lbvh.BVH | None = None,
               leaf_cap: int = LEAF_CAP, width: int = WIDTH,
               device="cpu") -> WideBVH:
    """tri_verts: [T, 3, 3] world space -> WideBVH on `device`."""
    nodes, leaves, bounds, depth = build_wide_rows(tri_verts, binary,
                                                   leaf_cap, width)
    return wide_from_rows(nodes, leaves, bounds, depth, width, leaf_cap,
                          len(tri_verts), device)
