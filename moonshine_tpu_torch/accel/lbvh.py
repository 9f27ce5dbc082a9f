"""Karras LBVH construction on the host (port of the numpy build path of
moonshine_tpu/accel/lbvh.py: `build(..., as_numpy=True)`).

A radix tree over Morton-sorted triangle centroids (Karras 2012), built
with vectorised numpy and flattened into (left, count, escape) arrays.
The port only collapses it into the wide BVH (wide.py); the binary tree
never goes to the device. 64-bit keys (30-bit Morton << 32 | index) are
strictly increasing, so every pass loop below converges within 70
iterations even for coincident geometry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SENTINEL = np.int32(-1)  # escape target meaning "traversal done"


class BVH(NamedTuple):
    """Flattened host BVH. Node 0 is the root. count[i] == 0 marks an
    internal node whose left child is left[i] (the right child is the left
    subtree's escape); count[i] > 0 marks a leaf over
    tri_order[left[i] : left[i] + count[i]]."""

    aabb_min: np.ndarray  # [M, 3] f32
    aabb_max: np.ndarray  # [M, 3] f32
    left: np.ndarray  # [M] i32
    count: np.ndarray  # [M] i32
    escape: np.ndarray  # [M] i32
    tri_order: np.ndarray  # [T] i32 Morton-sorted triangle permutation
    num_nodes: int
    num_tris: int
    parent: np.ndarray  # [M] i32, -1 for the root


def _to_bvh(aabb_min, aabb_max, left, count, escape, order, num_nodes,
            num_tris, parent):
    return BVH(
        aabb_min=np.asarray(aabb_min, np.float32),
        aabb_max=np.asarray(aabb_max, np.float32),
        left=np.asarray(left, np.int32),
        count=np.asarray(count, np.int32),
        escape=np.asarray(escape, np.int32),
        tri_order=np.asarray(order, np.int32),
        num_nodes=num_nodes,
        num_tris=num_tris,
        parent=np.asarray(parent, np.int32),
    )


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v to every third bit."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0,1]^3. [N,3] -> [N] uint64."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def _bit_length_u32(x: np.ndarray) -> np.ndarray:
    """Position of the highest set bit (0 for x == 0)."""
    out = np.zeros(x.shape, np.int64)
    v = x.astype(np.uint32).copy()
    for shift in (16, 8, 4, 2, 1):
        mask = v >= (np.uint32(1) << np.uint32(shift))
        out = np.where(mask, out + shift, out)
        v = np.where(mask, v >> np.uint32(shift), v)
    return out + (v > 0)


def _clz64(x: np.ndarray) -> np.ndarray:
    """Leading zeros of a uint64 array (64 for x == 0), in 32-bit halves."""
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    clz_hi = 32 - _bit_length_u32(hi)
    clz_lo = 32 - _bit_length_u32(lo)
    return np.where(hi != 0, clz_hi, 32 + clz_lo).astype(np.int64)


def _karras_topology(keys: np.ndarray):
    """Radix-tree topology over strictly increasing uint64 keys. Internal
    node i in [0, n-2] has children encoded as: >= 0 internal node id,
    < 0 leaf ~child. Returns (left, right, range_lo, range_hi)."""
    n = len(keys)
    idx = np.arange(n - 1, dtype=np.int64)

    def delta(i, j):
        ok = (j >= 0) & (j < n)
        jc = np.clip(j, 0, n - 1)
        return np.where(ok, _clz64(keys[i] ^ keys[jc]), -1)

    d = np.sign(delta(idx, idx + 1) - delta(idx, idx - 1)).astype(np.int64)
    delta_min = delta(idx, idx - d)

    # exponential search for an upper bound on the range length
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = delta(idx, idx + lmax * d) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if (lmax > 4 * n).all():
            break

    # binary search for the other end j
    length = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        probe = delta(idx, idx + (length + t) * d) > delta_min
        length = np.where((t >= 1) & probe, length + t, length)
        t = t // 2
    j = idx + length * d

    # binary search for the split position
    delta_node = delta(idx, j)
    s = np.zeros(n - 1, np.int64)
    t = (length + 1) // 2
    while True:
        probe = delta(idx, idx + (s + t) * d) > delta_node
        s = np.where((t >= 1) & probe, s + t, s)
        if (t <= 1).all():
            break
        t = (t + 1) // 2
    gamma = idx + s * d + np.minimum(d, 0)

    lo = np.minimum(idx, j)
    hi = np.maximum(idx, j)
    left = np.where(lo == gamma, ~gamma, gamma)
    right = np.where(hi == gamma + 1, ~(gamma + 1), gamma + 1)
    return left.astype(np.int64), right.astype(np.int64), lo, hi


def build(tri_verts: np.ndarray, leaf_size: int = 4) -> BVH:
    """Flattened Karras BVH over [T, 3, 3] world-space triangles. The
    reference may pad the node arrays to a power of two; padding nodes are
    unreachable from the root, so the wide rows built from either tree are
    identical and the port never pads."""
    tri_verts = np.asarray(tri_verts, np.float32)
    T = len(tri_verts)
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    centroids = tri_verts.mean(axis=1)
    lo, hi = centroids.min(axis=0), centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3d((centroids - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int64)
    keys = (codes[order] << np.uint64(32)) | np.arange(T, dtype=np.uint64)

    if T <= max(leaf_size, 1):
        return _single_leaf_bvh(tri_verts, order, T)

    left_c, right_c, range_lo, range_hi = _karras_topology(keys)
    n_internal = T - 1
    range_size = range_hi - range_lo + 1

    # an internal node whose range fits in a leaf collapses into one
    keep_internal = range_size > leaf_size
    keep_internal[0] = True

    def resolve_child(child):
        is_karras_leaf = child < 0
        ci = np.where(is_karras_leaf, ~child, child)
        cc = np.clip(ci, 0, n_internal - 1)
        child_lo = np.where(is_karras_leaf, ci, range_lo[cc])
        child_hi = np.where(is_karras_leaf, ci, range_hi[cc])
        child_is_leaf = is_karras_leaf | ~keep_internal[cc]
        return ci, child_lo, child_hi, child_is_leaf

    li, llo, lhi, lleaf = resolve_child(left_c)
    ri, rlo, rhi, rleaf = resolve_child(right_c)

    kept_ids = np.nonzero(keep_internal)[0]
    n_kept = len(kept_ids)
    new_id = np.full(n_internal, -1, np.int64)
    new_id[kept_ids] = np.arange(n_kept)

    # output nodes: kept internal nodes first, then leaves
    n_leaves = int(lleaf[kept_ids].sum() + rleaf[kept_ids].sum())
    M = n_kept + n_leaves
    node_left = np.zeros(M, np.int64)
    node_count = np.zeros(M, np.int64)
    node_lo = np.zeros(M, np.int64)
    node_hi = np.zeros(M, np.int64)
    child_left = np.full(M, -1, np.int64)
    child_right = np.full(M, -1, np.int64)
    parent = np.full(M, -1, np.int64)

    node_lo[:n_kept] = range_lo[kept_ids]
    node_hi[:n_kept] = range_hi[kept_ids]

    leaf_cursor = n_kept
    l_is_leaf_k = lleaf[kept_ids]
    n_left_leaves = int(l_is_leaf_k.sum())
    left_leaf_slots = np.arange(leaf_cursor, leaf_cursor + n_left_leaves)
    leaf_cursor += n_left_leaves
    r_is_leaf_k = rleaf[kept_ids]
    n_right_leaves = int(r_is_leaf_k.sum())
    right_leaf_slots = np.arange(leaf_cursor, leaf_cursor + n_right_leaves)

    cl = np.where(l_is_leaf_k, -1,
                  new_id[np.clip(li[kept_ids], 0, n_internal - 1)])
    cl[l_is_leaf_k] = left_leaf_slots
    cr = np.where(r_is_leaf_k, -1,
                  new_id[np.clip(ri[kept_ids], 0, n_internal - 1)])
    cr[r_is_leaf_k] = right_leaf_slots
    child_left[:n_kept] = cl
    child_right[:n_kept] = cr
    parent[cl] = np.arange(n_kept)
    parent[cr] = np.arange(n_kept)

    node_lo[left_leaf_slots] = llo[kept_ids][l_is_leaf_k]
    node_hi[left_leaf_slots] = lhi[kept_ids][l_is_leaf_k]
    node_lo[right_leaf_slots] = rlo[kept_ids][r_is_leaf_k]
    node_hi[right_leaf_slots] = rhi[kept_ids][r_is_leaf_k]
    leaves = slice(n_kept, M)
    node_count[leaves] = node_hi[leaves] - node_lo[leaves] + 1
    node_left[:n_kept] = child_left[:n_kept]
    node_left[leaves] = node_lo[leaves]  # leaves: triangle offset

    # escape(left child) = right sibling; escape(right child) =
    # escape(parent); escape(root) = SENTINEL
    escape = np.full(M, -2, np.int64)
    escape[0] = -1
    ids = np.arange(M)
    for _ in range(70):
        unresolved = escape == -2
        if not unresolved.any():
            break
        valid_p = parent >= 0
        pc = np.clip(parent, 0, M - 1)
        is_left = valid_p & (child_left[pc] == ids)
        cand = np.where(is_left, child_right[pc], escape[pc])
        ready = valid_p & (is_left | (cand != -2))
        escape = np.where(unresolved & ready, cand, escape)
    if (escape == -2).any():
        raise RuntimeError("escape link propagation did not converge")

    # AABBs: leaves over their small sorted ranges, internal nodes bottom-up
    sorted_verts = tri_verts[order]
    tri_min = sorted_verts.min(axis=1)
    tri_max = sorted_verts.max(axis=1)
    aabb_min = np.empty((M, 3), np.float32)
    aabb_max = np.empty((M, 3), np.float32)
    for k in range(1, leaf_size + 1):
        sel = node_count == k
        if not sel.any():
            continue
        base = node_lo[sel]
        mins = tri_min[base]
        maxs = tri_max[base]
        for j in range(1, k):
            mins = np.minimum(mins, tri_min[base + j])
            maxs = np.maximum(maxs, tri_max[base + j])
        aabb_min[sel] = mins
        aabb_max[sel] = maxs
    done = node_count > 0
    for _ in range(70):
        if done.all():
            break
        can = (~done & done[np.clip(child_left, 0, M - 1)]
               & done[np.clip(child_right, 0, M - 1)])
        if not can.any():
            break
        aabb_min[can] = np.minimum(aabb_min[child_left[can]],
                                   aabb_min[child_right[can]])
        aabb_max[can] = np.maximum(aabb_max[child_left[can]],
                                   aabb_max[child_right[can]])
        done |= can
    if not done.all():
        raise RuntimeError("AABB propagation did not converge")

    escape = np.where(escape == -1, SENTINEL, escape)
    return _to_bvh(aabb_min, aabb_max, node_left, node_count, escape, order,
                   M, T, parent)


def _single_leaf_bvh(tri_verts, order, count):
    """Degenerate tree: the root is the only (leaf) node."""
    sorted_verts = tri_verts[order]
    return _to_bvh(sorted_verts.min(axis=(0, 1))[None],
                   sorted_verts.max(axis=(0, 1))[None],
                   np.zeros(1), np.full(1, count), np.full(1, SENTINEL),
                   order, 1, len(tri_verts), np.full(1, -1))
