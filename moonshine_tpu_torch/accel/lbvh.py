"""Binary BVH construction on the host (port of the numpy build paths of
moonshine_tpu/accel/lbvh.py: `build(..., as_numpy=True)` and
`build_sah(..., as_numpy=True)`).

`build` is a radix tree over Morton-sorted triangle centroids (Karras
2012); `build_sah` splits top-down by the binned surface-area heuristic.
Both are vectorised numpy flattened into (left, count, escape) arrays.
The port collapses them into the wide BVH (wide.py), and `device_bvh`
puts the binary tree itself on the device for the per-lane fallback walk
(traverse.py). Karras' 64-bit keys (30-bit Morton << 32 |
index) are strictly increasing, so its pass loops converge within 70
iterations even for coincident geometry; the SAH build bounds its depth
with median splits past 48 levels.

`presplit_refs` splits large triangles into spatial-split references
(tri id, clipped box), SBVH-style; `build_sah(refs=...)` then partitions
references instead of triangles (the reference's `MSN_PRESPLIT` path, off
by default). Not ported: the reference's power-of-two node padding
(padding nodes are unreachable, so the wide rows are the same without
it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def device_bvh(bvh: BVH, device) -> BVH:
    """The BVH's arrays as tensors on `device` (float32 boxes, int64
    indices); a missing `parent` stays None."""
    put = lambda a, dt: (None if a is None else
                         torch.tensor(np.asarray(a, dt), device=device))
    return bvh._replace(
        aabb_min=put(bvh.aabb_min, np.float32),
        aabb_max=put(bvh.aabb_max, np.float32),
        left=put(bvh.left, np.int64),
        count=put(bvh.count, np.int64),
        escape=put(bvh.escape, np.int64),
        tri_order=put(bvh.tri_order, np.int64),
        parent=put(bvh.parent, np.int64),
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


def _ranges_to_members(lo: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [lo[i], lo[i]+lens[i]) index ranges without Python loops."""
    total = int(lens.sum())
    out = np.ones(total, np.int64)
    out[0] = lo[0]
    cl = np.cumsum(lens)[:-1]
    out[cl] = lo[1:] - (lo[:-1] + lens[:-1]) + 1
    return np.cumsum(out)


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Half surface area of boxes [..., 3]; 0 for empty (inverted) boxes."""
    e = hi - lo
    a = e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]
    return np.where((e >= 0).all(axis=-1), a, 0.0)


def _clip_tri_aabb(v, axis, p, left):
    """AABB of each triangle clipped to the half-space (coord <= p[k] when
    left else >= p[k]) along `axis`, in float64. v: [K, 3, 3], p: [K].
    Returns (lo, hi) [K, 3]; an inverted box means the triangle misses
    that side."""
    K = len(v)
    d = v[:, :, axis] - p[:, None]  # [K, 3] signed vertex-plane distance
    inside = (d <= 0) if left else (d >= 0)
    # candidates: the vertices on the kept side and the three edge-plane
    # crossings (computed for every edge, masked by validity)
    pts = np.empty((K, 6, 3), np.float64)
    ok = np.empty((K, 6), bool)
    pts[:, 0:3] = v
    ok[:, 0:3] = inside
    for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        di, dj = d[:, i], d[:, j]
        cross = (di * dj) < 0
        t = np.where(cross, di / np.where(di == dj, 1.0, di - dj), 0.0)
        pts[:, 3 + e] = v[:, i] + t[:, None] * (v[:, j] - v[:, i])
        ok[:, 3 + e] = cross
    okk = ok[:, :, None]
    return (np.where(okk, pts, np.inf).min(axis=1),
            np.where(okk, pts, -np.inf).max(axis=1))


def presplit_refs(tri_verts: np.ndarray, max_refs_factor: float = 1.35,
                  area_factor: float = 8.0, rounds: int = 16):
    """SBVH-style pre-splitting: triangles whose box half-area is far above
    the median become several references (tri id, clipped sub-box), so the
    builder can carve tight boxes around large wall and floor triangles
    instead of leaves that span the scene. Traversal still intersects the
    whole triangle at every reference, so duplicates change the visits,
    never the hits (the spatial-split argument of Stich et al., SBVH).

    Each round splits the references above `area_factor` x the median
    half-area (the largest first, within the budget of
    T * max_refs_factor references) at the middle of their longest axis;
    the left half keeps the slot, the right half is appended. Returns
    (ref_tri [R] i64, ref_lo [R, 3] f32, ref_hi [R, 3] f32): the float64
    clips rounded outward to float32 (nextafter), so a reference box never
    shrinks past the true clipped extent."""
    tri_verts = np.asarray(tri_verts, np.float32)
    T = len(tri_verts)
    ref_tri = np.arange(T, dtype=np.int64)
    ref_lo = tri_verts.min(axis=1).astype(np.float64)
    ref_hi = tri_verts.max(axis=1).astype(np.float64)
    budget = int(T * max_refs_factor)
    for _ in range(rounds):
        free = budget - len(ref_tri)
        if free <= 0:
            break
        area = _half_area(ref_lo, ref_hi)
        thresh = max(float(np.median(area)) * area_factor, 1e-30)
        cand = np.flatnonzero(area > thresh)
        if len(cand) == 0:
            break
        if len(cand) > free:
            cand = cand[np.argsort(area[cand])[::-1][:free]]
        v = tri_verts[ref_tri[cand]].astype(np.float64)
        ext = ref_hi[cand] - ref_lo[cand]
        axis = ext.argmax(axis=1)
        p = (ref_lo[cand] + ref_hi[cand])[np.arange(len(cand)), axis] * 0.5
        l_lo = np.empty_like(ref_lo[cand])
        l_hi = np.empty_like(l_lo)
        r_lo = np.empty_like(l_lo)
        r_hi = np.empty_like(l_lo)
        for a in range(3):  # per-axis groups, each clip vectorised
            g = np.flatnonzero(axis == a)
            if not len(g):
                continue
            l_lo[g], l_hi[g] = _clip_tri_aabb(v[g], a, p[g], True)
            r_lo[g], r_hi[g] = _clip_tri_aabb(v[g], a, p[g], False)
        # stay inside the parent reference's box and cap at the plane
        sel = np.arange(len(cand))
        l_lo = np.maximum(l_lo, ref_lo[cand])
        l_hi = np.minimum(l_hi, ref_hi[cand])
        l_hi[sel, axis] = np.minimum(l_hi[sel, axis], p)
        r_lo = np.maximum(r_lo, ref_lo[cand])
        r_hi = np.minimum(r_hi, ref_hi[cand])
        r_lo[sel, axis] = np.maximum(r_lo[sel, axis], p)
        both = (l_lo <= l_hi).all(axis=1) & (r_lo <= r_hi).all(axis=1)
        if not both.any():
            break
        c2 = cand[both]
        ref_lo[c2] = l_lo[both]
        ref_hi[c2] = l_hi[both]
        ref_tri = np.concatenate([ref_tri, ref_tri[c2]])
        ref_lo = np.concatenate([ref_lo, r_lo[both]])
        ref_hi = np.concatenate([ref_hi, r_hi[both]])
    lo32 = ref_lo.astype(np.float32)
    hi32 = ref_hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > ref_lo,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < ref_hi,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return ref_tri, lo32, hi32


def build_sah(tri_verts: np.ndarray, leaf_size: int = 4, n_bins: int = 16,
              refs=None):
    """Top-down binned-SAH BVH over [T, 3, 3] triangles, in the same
    flattened layout as `build`. Each level bins every frontier node's
    items along its dominant centroid axis, sweeps the bins for the
    least-SAH partition and partitions the item order in place, all as
    segment operations over the whole frontier.

    refs: (ref_tri, ref_lo, ref_hi) from `presplit_refs`. The build then
    partitions the R references by their clipped boxes, `tri_order` maps
    the R sorted positions to triangle ids (with duplicates) and node
    boxes come from the clipped boxes; returns (bvh, clip_lo_sorted,
    clip_hi_sorted), the [R, 3] clipped boxes in sorted order, for the
    wide collapse's leaf boxes. Without refs, returns the BVH."""
    tri_verts = np.asarray(tri_verts, np.float32)
    if refs is not None:
        ref_tri, ref_lo, ref_hi = refs
        cent = ((ref_lo + ref_hi) * 0.5).astype(np.float64)
        tmin = ref_lo.astype(np.float64)
        tmax = ref_hi.astype(np.float64)
        T = len(ref_tri)
    else:
        T = len(tri_verts)
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if T <= leaf_size:
        if refs is not None:
            raise ValueError(f"{T} references: a presplit build needs more "
                             f"than leaf_size ({leaf_size})")
        return _single_leaf_bvh(tri_verts, np.arange(T, dtype=np.int64), T)
    if refs is None:
        cent = tri_verts.mean(axis=1).astype(np.float64)
        tmin = tri_verts.min(axis=1).astype(np.float64)
        tmax = tri_verts.max(axis=1).astype(np.float64)

    order = np.arange(T, dtype=np.int64)
    # emitted nodes (root = 0): ranges + children; leaves resolved at the end
    node_lo = [np.asarray([0], np.int64)]
    node_len = [np.asarray([T], np.int64)]
    link_parent, link_left, link_right = [], [], []
    n_nodes = 1
    # frontier: output node ids + their [lo, len) ranges over `order`
    f_node = np.asarray([0], np.int64)
    f_lo = np.asarray([0], np.int64)
    f_len = np.asarray([T], np.int64)
    n_levels = 0

    while len(f_node):
        n_levels += 1
        F = len(f_node)
        starts = np.concatenate([[0], np.cumsum(f_len)[:-1]])
        member = _ranges_to_members(f_lo, f_len)  # positions in `order`
        tri = order[member]
        seg = np.repeat(np.arange(F, dtype=np.int64), f_len)
        c = cent[tri]

        cb_min = np.minimum.reduceat(c, starts, axis=0)
        cb_max = np.maximum.reduceat(c, starts, axis=0)
        ext = cb_max - cb_min
        axis = ext.argmax(axis=1)  # [F]

        ax_c = c[np.arange(len(c)), axis[seg]]
        ax_lo = cb_min[seg, axis[seg]]
        ax_ext = np.maximum(ext[seg, axis[seg]], 1e-30)
        b = np.minimum(((ax_c - ax_lo) / ax_ext * n_bins).astype(np.int64),
                       n_bins - 1)

        # per-(seg, bin) triangle counts and AABB unions
        key = seg * n_bins + b
        cnt = np.bincount(key, minlength=F * n_bins).reshape(F, n_bins)
        ord2 = np.argsort(key, kind="stable")
        ks = key[ord2]
        gstart = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        gkey = ks[gstart]
        bmin = np.full((F * n_bins, 3), np.inf)
        bmax = np.full((F * n_bins, 3), -np.inf)
        bmin[gkey] = np.minimum.reduceat(tmin[tri][ord2], gstart, axis=0)
        bmax[gkey] = np.maximum.reduceat(tmax[tri][ord2], gstart, axis=0)
        bmin = bmin.reshape(F, n_bins, 3)
        bmax = bmax.reshape(F, n_bins, 3)

        # SAH sweep: split after bin k (left = bins <= k)
        lmin = np.minimum.accumulate(bmin, axis=1)
        lmax = np.maximum.accumulate(bmax, axis=1)
        rmin = np.minimum.accumulate(bmin[:, ::-1], axis=1)[:, ::-1]
        rmax = np.maximum.accumulate(bmax[:, ::-1], axis=1)[:, ::-1]
        lcnt = np.cumsum(cnt, axis=1)
        rcnt = f_len[:, None] - lcnt  # count of bins > k at column k
        cost = (_half_area(lmin, lmax)[:, :-1] * lcnt[:, :-1]
                + _half_area(rmin, rmax)[:, 1:] * rcnt[:, :-1])
        cost = np.where((lcnt[:, :-1] == 0) | (rcnt[:, :-1] == 0), np.inf,
                        cost)
        best = cost.argmin(axis=1)  # [F] split-after bin
        degenerate = ~np.isfinite(cost[np.arange(F), best])
        if n_levels > 48:
            # depth guard: median splits from here on keep the depth
            # within the bottom-up passes' bounds
            degenerate[:] = True

        # left flag per member; degenerate segments split at the median
        go_left = b <= best[seg]
        local = np.arange(len(member)) - starts[seg]
        go_left = np.where(degenerate[seg], local < (f_len[seg] + 1) // 2,
                           go_left)

        # stable partition of each segment: left block then right block
        part = np.argsort(seg * 2 + (~go_left).astype(np.int64),
                          kind="stable")
        order[member] = tri[part]

        n_left = np.bincount(seg, weights=go_left.astype(np.float64),
                             minlength=F).astype(np.int64)
        l_lo, l_len = f_lo, n_left
        r_lo, r_len = f_lo + n_left, f_len - n_left

        # emit children; those still above leaf_size join the next frontier
        ids_l = n_nodes + np.arange(F, dtype=np.int64)
        ids_r = n_nodes + F + np.arange(F, dtype=np.int64)
        n_nodes += 2 * F
        node_lo.extend([l_lo, r_lo])
        node_len.extend([l_len, r_len])
        link_parent.append(f_node)
        link_left.append(ids_l)
        link_right.append(ids_r)

        split_l = l_len > leaf_size
        split_r = r_len > leaf_size
        f_node = np.concatenate([ids_l[split_l], ids_r[split_r]])
        f_lo = np.concatenate([l_lo[split_l], r_lo[split_r]])
        f_len = np.concatenate([l_len[split_l], r_len[split_r]])
        if len(f_node):
            srt = np.argsort(f_lo, kind="stable")  # keep ranges sorted
            f_node, f_lo, f_len = f_node[srt], f_lo[srt], f_len[srt]

    node_lo = np.concatenate(node_lo)
    node_len = np.concatenate(node_len)
    child_left = np.full(n_nodes, -1, np.int64)
    child_right = np.full(n_nodes, -1, np.int64)
    child_left[np.concatenate(link_parent)] = np.concatenate(link_left)
    child_right[np.concatenate(link_parent)] = np.concatenate(link_right)
    if refs is None:
        return _finalize_topdown(tri_verts, order, node_lo, node_len,
                                 child_left, child_right, 2 * n_levels + 6)
    clip_lo = tmin[order].astype(np.float32)
    clip_hi = tmax[order].astype(np.float32)
    bvh = _finalize_topdown(tri_verts, ref_tri[order], node_lo, node_len,
                            child_left, child_right, 2 * n_levels + 6,
                            item_min=clip_lo, item_max=clip_hi)
    return bvh, clip_lo, clip_hi


def _finalize_topdown(tri_verts, order, node_lo, node_len, child_left,
                      child_right, depth_bound, item_min=None,
                      item_max=None) -> BVH:
    """Escape links, parent links and AABBs for a top-down tree over
    contiguous ranges of `order` (node ids in emit order). item_min /
    item_max, [len(order), 3] in sorted order, replace the triangles'
    boxes (the presplit build's clipped reference boxes). num_tris is
    len(order): with references it exceeds the triangle count."""
    M = len(node_lo)
    is_leaf = child_left < 0

    parent = np.full(M, -1, np.int64)
    valid = child_left >= 0
    parent[child_left[valid]] = np.flatnonzero(valid)
    parent[child_right[valid]] = np.flatnonzero(valid)

    # escape(left child) = right sibling; escape(right child) =
    # escape(parent); escape(root) = SENTINEL
    escape = np.full(M, -2, np.int64)
    escape[0] = -1
    for _ in range(depth_bound):
        unresolved = escape == -2
        if not unresolved.any():
            break
        p = np.clip(parent, 0, M - 1)
        is_left = child_left[p] == np.arange(M)
        cand = np.where(is_left, child_right[p], escape[p])
        ready = (parent >= 0) & (is_left | (cand != -2))
        escape = np.where(unresolved & ready, cand, escape)
    if (escape == -2).any():
        raise RuntimeError("escape link propagation did not converge")

    # AABBs straight from ranges (every node covers order[lo:lo+len)),
    # chunked so the member scratch stays bounded
    if item_min is not None:
        tri_min, tri_max = item_min, item_max
    else:
        sorted_verts = tri_verts[order]
        tri_min = sorted_verts.min(axis=1)
        tri_max = sorted_verts.max(axis=1)
    aabb_min = np.empty((M, 3), np.float32)
    aabb_max = np.empty((M, 3), np.float32)
    for i_grp in range(0, M, 1 << 16):
        sl = slice(i_grp, min(i_grp + (1 << 16), M))
        lens = node_len[sl]
        mem = _ranges_to_members(node_lo[sl], lens)
        st = np.concatenate([[0], np.cumsum(lens)[:-1]])
        aabb_min[sl] = np.minimum.reduceat(tri_min[mem], st, axis=0)
        aabb_max[sl] = np.maximum.reduceat(tri_max[mem], st, axis=0)

    node_left = np.where(is_leaf, node_lo, child_left)
    node_count = np.where(is_leaf, node_len, 0)
    escape = np.where(escape == -1, SENTINEL, escape)
    return _to_bvh(aabb_min, aabb_max, node_left, node_count, escape, order,
                   M, len(order), parent)


def refit_host(left: np.ndarray, count: np.ndarray, escape: np.ndarray,
               tri_order: np.ndarray, tri_verts: np.ndarray,
               depth_bound: int = 70) -> tuple[np.ndarray, np.ndarray]:
    """Node boxes for moved triangles on a fixed topology (the reference's
    host refit, lbvh.py:806 there): leaf boxes from their triangles, then
    parents from their two children in sweeps until nothing changes (at
    most `depth_bound`). Returns (aabb_min, aabb_max) [M, 3] float32."""
    tri_verts = np.asarray(tri_verts, np.float32)
    sorted_verts = tri_verts[np.asarray(tri_order)]
    tri_min = sorted_verts.min(axis=1)
    tri_max = sorted_verts.max(axis=1)
    left = np.asarray(left)
    count = np.asarray(count)
    escape = np.asarray(escape)
    M = len(left)
    T = len(tri_verts)
    is_leaf = count > 0
    lo = np.full((M, 3), np.inf, np.float32)
    hi = np.full((M, 3), -np.inf, np.float32)
    for j in range(int(count.max(initial=0))):
        take = is_leaf & (j < count)
        idx = np.clip(left + j, 0, T - 1)
        lo[take] = np.minimum(lo[take], tri_min[idx[take]])
        hi[take] = np.maximum(hi[take], tri_max[idx[take]])
    left_child = np.clip(left, 0, M - 1)
    right_child = np.clip(escape[left_child], 0, M - 1)
    internal = ~is_leaf
    for _ in range(depth_bound):
        nlo = np.where(internal[:, None],
                       np.minimum(lo[left_child], lo[right_child]), lo)
        nhi = np.where(internal[:, None],
                       np.maximum(hi[left_child], hi[right_child]), hi)
        if np.array_equal(nlo, lo) and np.array_equal(nhi, hi):
            break
        lo, hi = nlo, nhi
    return lo, hi
