"""Treelet-scheduled traversal (port of moonshine_tpu/accel/treelet.py).

The wide tree is partitioned into K subtrees, "treelets" (wide.py's
`plan_treelets`), whose roots and boxes ride on the WideBVH. A traversal
then runs in three steps:

  1. `_pending_masks`: every ray against every treelet box, giving a
     pending bit mask [N, ceil(K/32)] (uint32 words held in int32, bit
     31 negative, equal to the reference's bit for bit) and the nearest
     pending treelet per ray (K if none); the CUDA kernel of
     csrc/treelet.cu for CUDA tensors, torch ops
     (`_pending_masks_plain`) for CPU tensors.
  2. One stable sort of the rays by `nearest * MAX_KEYED + sort_key`
     (the coherence key, 4^3 origin cells x 8 octants, the reference's
     `_subkey`; the sort makes it from the rays and `nearest`), which
     moves the rays, their pending words and nearest treelets along
     (core/sortutil.py: kernels of csrc/sort.cu for CUDA tensors, the
     first of which makes the keys).
  3. One launch of the CUDA kernel of csrc/treelet.cu on the sorted
     rays (CUDA tensors), or `_dispatch_plain` (CPU tensors): each ray
     walks its own pending treelets, its nearest first and then the rest
     in ascending id, with its t_best pruning across treelets; a
     closest-hit ray skips a pending node-root treelet whose box it
     enters beyond its t_best (the root visit would push nothing); an
     any-hit ray stops at its first occluder. Results go back to lane
     order.

The contract is that of packet.closest_hit_packet_hbm /
any_hit_packet_hbm. The child box test is the reference treelet
kernel's own form, `(b - o) * inv` slabs and `tnear <= tfar & tfar >= 0
& tnear <= prune`; kernel and plain version both follow it.

The reference's TPU schedule (a block-shared stack, block-OR'd masks, a
DMA ring of rows) is not carried over: each CUDA thread walks its own
stack, in shared memory, sized by the deepest treelet
(`WideBVH.treelet_stack`). `available` keeps the reference's rule
(8-wide nodes, 8-slot leaves, at least two treelets) for dispatch,
though the kernel takes every width the build makes (8, 16, 24, 32).
"""

from __future__ import annotations

import torch

from ..core import sortutil
from . import native
from .launch import Counts, call_on, count_launch
from .packet import (
    _NEG,
    SORT_CELLS,
    Hit,
    _check_launch,
    _check_rays,
    _device_kind,
    _plain_result,
    _plain_state,
    _t_max_lanes,
    _visits,
    _walk,
)
from .wide import LEAF_CAP, WIDTH, WideBVH

_INF = 3.0e37
MAX_KEYED = SORT_CELLS ** 3 * 8  # subkey space: 4^3 origin cells x 8
# lanes per phase-1 chunk: its [chunk, 32] float32 temporaries stay at
# 128 MB each, under 1 GB in all
PENDING_CHUNK = 1 << 20

LAUNCHES = Counts({"treelet_pending": 0, "treelet_closest_hit": 0,
                   "treelet_any_hit": 0})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def available(wbvh: WideBVH) -> bool:
    """The reference's rule: a treelet plan of two or more roots over an
    8-wide / 8-slot tree."""
    return (wbvh.t_roots is not None and wbvh.t_roots.shape[0] >= 2
            and wbvh.width == WIDTH and wbvh.leaf_slots == LEAF_CAP)


def _safe_inv(d):
    tiny = 1e-12
    return 1.0 / torch.where(torch.abs(d) < tiny,
                             torch.where(d >= 0, tiny, -tiny), d)


def _pending_masks(wbvh: WideBVH, o, d, tmax_vec):
    """Phase 1: pend [N, ceil(K/32)] int32 bit words of the treelets each
    ray enters, and nearest [N] int32, the pending treelet with the
    smallest entry t (K if none). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; the two are equal bit for bit."""
    if _device_kind(o) == "cpu":
        return _pending_masks_plain(wbvh, o, d, tmax_vec)
    return _pending_kernel(native.treelet_lib(), wbvh, o, d, tmax_vec)


def _pending_kernel(lib, wbvh: WideBVH, o, d, tmax_vec):
    """One launch of `lib`'s phase-1 kernel on CUDA tensors."""
    K = wbvh.t_roots.shape[0]
    N = o.shape[0]
    if N >= 2**31 or K >= 2**30:
        raise ValueError("too many rays or treelets for one launch")
    for name, x in (("t_lo", wbvh.t_lo), ("t_hi", wbvh.t_hi),
                    ("t_max", tmax_vec)):
        if x.dtype != torch.float32 or x.device != o.device:
            raise ValueError(f"{name} must be float32 on the rays' device")
    o, d = o.contiguous(), d.contiguous()
    t_lo, t_hi = wbvh.t_lo.contiguous(), wbvh.t_hi.contiguous()
    tmax_vec = tmax_vec.contiguous()
    pend = torch.empty((N, -(-K // 32)), dtype=torch.int32, device=o.device)
    nearest = torch.empty(N, dtype=torch.int32, device=o.device)
    if N:
        rc = call_on(lib.pending, o.device, t_lo.data_ptr(),
                      t_hi.data_ptr(), K, o.data_ptr(), d.data_ptr(),
                      tmax_vec.data_ptr(), N, pend.data_ptr(),
                      nearest.data_ptr())
        if rc != 0:
            raise RuntimeError(f"treelet phase-1 kernel launch failed: "
                               f"cudaError {rc}")
        count_launch(LAUNCHES, "treelet_pending")
    return pend, nearest


def _pending_masks_plain(wbvh: WideBVH, o, d, tmax_vec):
    """The phase-1 kernel's plain version in torch ops on any device:
    per-(ray, treelet) slab tests, chunked over lanes and over 32-treelet
    words, one axis at a time (a max or min of three is exact in any
    order, so this equals the reference's [N, 32, 3] form)."""
    K = wbvh.t_roots.shape[0]
    K32 = -(-K // 32)
    N = o.shape[0]
    dev = o.device
    pend = torch.empty((N, K32), dtype=torch.int32, device=dev)
    nearest = torch.empty(N, dtype=torch.int32, device=dev)
    # bit j of a word as an int64 holding the int32 value (bit 31 taken as
    # -2^31): distinct powers of two, so a sum of them is their OR
    bit = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    bit = torch.where(bit >= 2**31, bit - 2**32, bit)
    for a in range(0, N, PENDING_CHUNK):
        b = min(a + PENDING_CHUNK, N)
        oc, tm = o[a:b], tmax_vec[a:b, None]
        inv = _safe_inv(d[a:b])
        active = tm > 0.0
        best_t = torch.full((b - a,), _INF, dtype=torch.float32, device=dev)
        best_k = torch.full((b - a,), K, dtype=torch.int32, device=dev)
        for w in range(K32):
            k0, k1 = w * 32, min(w * 32 + 32, K)
            tn = tf = None
            for c in range(3):
                t0 = (wbvh.t_lo[None, k0:k1, c] - oc[:, c, None]) \
                    * inv[:, c, None]
                t1 = (wbvh.t_hi[None, k0:k1, c] - oc[:, c, None]) \
                    * inv[:, c, None]
                near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
                del t0, t1
                tn = near if tn is None else torch.maximum(tn, near)
                tf = far if tf is None else torch.minimum(tf, far)
            hitm = (tn <= tf) & (tf >= 0.0) & (tn <= tm) & active
            pend[a:b, w] = (hitm * bit[:k1 - k0]).sum(dim=1).to(torch.int32)
            te = torch.where(hitm, torch.clamp_min(tn, 0.0), _INF)
            t_local = te.amin(dim=1)
            k_local = te.argmin(dim=1)  # the first minimum, as jnp's
            better = t_local < best_t
            best_t = torch.where(better, t_local, best_t)
            best_k = torch.where(better, k_local.to(torch.int32) + k0,
                                 best_k)
        nearest[a:b] = best_k
    return pend, nearest


def word_unions(t_lo, t_hi):
    """The union box of each 32-treelet word that phase 1's kernel makes
    and tests a ray against before the word's boxes: per axis the least
    of min(lo, hi) and the greatest of max(lo, hi) over the word's
    treelets ([ceil(K/32), 3] each). The slab test takes a box's planes
    in either order, so an inverted box (an empty treelet's, lo 0, hi -1)
    counts as the box between its planes and is not left out."""
    K = t_lo.shape[0]
    pad = -(-K // 32) * 32 - K
    lo, hi = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=float("-inf"))
    return (lo.reshape(-1, 32, 3).amin(dim=1),
            hi.reshape(-1, 32, 3).amax(dim=1))


def entered_words(wbvh: WideBVH, o, d, tmax_vec):
    """[N, ceil(K/32)] bool: the words whose union box (`word_unions`)
    the ray enters, by phase 1's own test (the plain version run on the
    unions as boxes); a dead ray enters none. Phase 1's kernel tests a
    word's 32 boxes only there, so its words equal the plain version's
    where every ray that enters a box enters its word's union."""
    lo, hi = word_unions(wbvh.t_lo, wbvh.t_hi)
    unions = wbvh._replace(t_roots=torch.zeros(lo.shape[0], dtype=torch.int32,
                                               device=lo.device),
                           t_lo=lo, t_hi=hi)
    pend, _ = _pending_masks_plain(unions, o, d, tmax_vec)
    return pending_bits(pend, lo.shape[0])


def pending_bits(pend, k: int):
    """[N, k] bool: bit j of each row's words, j < k."""
    j = torch.arange(k, device=pend.device)
    return ((pend[:, j >> 5] >> (j & 31)) & 1) == 1


def _pending_bit(pend, tid: int):
    return ((pend[:, tid >> 5] >> (tid & 31)) & 1) == 1


def _box_entry(wbvh: WideBVH, tid: int, o, inv, lanes):
    """tnear of `lanes` into treelet tid's box, phase 1's expressions."""
    near = [torch.minimum((wbvh.t_lo[tid, c] - o[c][lanes]) * inv[c][lanes],
                          (wbvh.t_hi[tid, c] - o[c][lanes]) * inv[c][lanes])
            for c in range(3)]
    return torch.maximum(torch.maximum(near[0], near[1]), near[2])


def _dispatch_plain(wbvh: WideBVH, o_s, d_s, t_s, pend_s, first_s,
                    any_hit: bool, count_visits: bool = False):
    """The kernel's plain version on sorted lanes: the lane's nearest
    pending treelet first, then its other pending treelets in ascending
    id, each walked from its root with the lane state carried across.
    A closest-hit lane skips a node-root treelet whose box it enters
    beyond its t_best, as the kernel does (each skip, counted in
    Visits.roots_skipped, saves one root visit that would push
    nothing)."""
    K = wbvh.t_roots.shape[0]
    roots = wbvh.t_roots.to(torch.int64)
    node_root = (wbvh.t_roots >= 0).tolist()
    # the kernel's stack bound: a walk that outgrew it would raise here
    r, st, stack, counts = _plain_state(wbvh, o_s, d_s, t_s, count_visits,
                                        wbvh.treelet_stack)
    live = t_s > 0.0
    first = first_s.to(torch.int64)
    lanes = torch.nonzero(live & (first < K)).squeeze(1)
    _walk(wbvh, r, st, lanes, roots[first[lanes]], any_hit, True, stack,
          counts)
    for tid in range(K):
        sel = live & _pending_bit(pend_s, tid) & (first != tid)
        if any_hit:
            sel &= ~st["occ"]
        lanes = torch.nonzero(sel).squeeze(1)
        if not any_hit and node_root[tid] and lanes.numel():
            beyond = _box_entry(wbvh, tid, r[0], r[2], lanes) \
                > st["t_best"][lanes]
            if counts is not None:
                counts["roots_skipped"] += int(beyond.sum())
            lanes = lanes[~beyond]
        if lanes.numel():
            _walk(wbvh, r, st, lanes, roots[tid].expand(lanes.shape[0]),
                  any_hit, True, stack, counts)
    out = _plain_result(st, t_s, any_hit)
    return (out, _visits(counts)) if count_visits else out


def _dispatch_kernel(wbvh: WideBVH, o_s, d_s, t_s, pend_s, first_s,
                     any_hit: bool, lib=None):
    """One launch of the walk (`lib`'s, by default this checkout's) on
    sorted lanes."""
    lib = lib or native.treelet_lib()
    n = o_s.shape[0]
    _check_launch(lib, wbvh, n)
    if wbvh.t_roots.dtype != torch.int32 or not wbvh.t_roots.is_contiguous():
        raise ValueError("t_roots must be contiguous int32")
    for name, x in (("t_lo", wbvh.t_lo), ("t_hi", wbvh.t_hi)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    # rows are read as float4s: 16-byte aligned, a multiple of 4 floats long
    for name, x in (("nodes", wbvh.nodes), ("leaves", wbvh.leaves)):
        if x.data_ptr() % 16 or x[0].numel() % 4:
            raise ValueError(f"{name} rows must be 16-byte aligned")
    if not 1 <= wbvh.treelet_stack <= lib.stack_capacity:
        raise ValueError(f"treelet stack bound {wbvh.treelet_stack} outside "
                         f"1..{lib.stack_capacity}")
    dev = o_s.device
    o_s, d_s, t_s = o_s.contiguous(), d_s.contiguous(), t_s.contiguous()
    pend_s, first_s = pend_s.contiguous(), first_s.contiguous()
    args = [
        wbvh.nodes.data_ptr(), wbvh.leaves.data_ptr(),
        wbvh.nodes[0].numel(), wbvh.leaves[0].numel(),
        wbvh.width, wbvh.leaf_slots,
        wbvh.t_roots.data_ptr(), wbvh.t_lo.data_ptr(), wbvh.t_hi.data_ptr(),
        wbvh.t_roots.shape[0], wbvh.treelet_stack,
        pend_s.data_ptr(), pend_s.shape[1], first_s.data_ptr(),
        o_s.data_ptr(), d_s.data_ptr(), t_s.data_ptr(), n,
    ]
    if any_hit:
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        if n:
            rc = call_on(lib.any_hit, dev, *args, occ.data_ptr())
            if rc != 0:
                raise RuntimeError(f"treelet any-hit kernel launch failed: "
                                   f"cudaError {rc}")
            count_launch(LAUNCHES, "treelet_any_hit")
        return occ
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        rc = call_on(lib.closest_hit, dev, *args, t.data_ptr(),
                      tri.data_ptr(), u.data_ptr(), v.data_ptr())
        if rc != 0:
            raise RuntimeError(f"treelet closest-hit kernel launch failed: "
                               f"cudaError {rc}")
        count_launch(LAUNCHES, "treelet_closest_hit")
    return Hit(t=t, tri=tri, u=u, v=v)


def key_bits(wbvh: WideBVH) -> int:
    """Bits of the dispatch's sort key, nearest * MAX_KEYED + sort_key:
    nearest lies in [0, K] (K: no pending treelet), so every key lies
    below (K + 1) * MAX_KEYED."""
    return ((wbvh.t_roots.shape[0] + 1) * MAX_KEYED - 1).bit_length()


def _sort_lanes(wbvh: WideBVH, ray_o, ray_d, t_eff, plain: bool = False):
    """Phase 1 and the sort (their plain versions with plain=True): (perm
    int32, (o, d, t_eff, pend, nearest) in the sorted lane order the
    kernel takes)."""
    phase1 = _pending_masks_plain if plain else _pending_masks
    pend, nearest = phase1(wbvh, ray_o, ray_d, t_eff)
    sort = sortutil.sort_lanes_plain if plain else sortutil.sort_lanes
    key = sortutil.KeyIn(ray_o, ray_d, wbvh.bounds, SORT_CELLS, major=nearest)
    perm, lanes = sort(key, [ray_o, ray_d, t_eff, pend, nearest],
                       key_bits(wbvh))
    return perm, tuple(lanes)


def _run(wbvh: WideBVH, ray_o, ray_d, t_max, active_in, any_hit: bool,
         plain: bool, count_visits: bool = False):
    _check_rays(wbvh, ray_o, ray_d, active_in)
    if wbvh.t_roots is None:
        raise ValueError("the tree carries no treelet plan")
    if not plain and _device_kind(ray_o) == "cpu":
        plain = True
    n = ray_o.shape[0]
    t_caller = _t_max_lanes(t_max, n, ray_o.device)
    t_eff = (t_caller if active_in is None
             else torch.where(active_in, t_caller, _NEG))
    perm, sorted_lanes = _sort_lanes(wbvh, ray_o, ray_d, t_eff, plain)
    visits = None
    if plain:
        out = _dispatch_plain(wbvh, *sorted_lanes, any_hit,
                              count_visits=count_visits)
        if count_visits:
            out, visits = out
    else:
        out = _dispatch_kernel(wbvh, *sorted_lanes, any_hit)
    unsort = sortutil.unsort_lanes_plain if plain else sortutil.unsort_lanes
    if any_hit:
        res = unsort(perm, [out])[0]
    else:
        t, tri, u, v = unsort(perm, list(out))
        res = Hit(t=torch.where(tri >= 0, t, t_caller), tri=tri, u=u, v=v)
    return (res, visits) if count_visits else res


def closest_hit_treelet(wbvh: WideBVH, ray_o, ray_d, t_max,
                        active_in=None) -> Hit:
    """Treelet-scheduled closest hit: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Contract of
    packet.closest_hit_packet_hbm."""
    return _run(wbvh, ray_o, ray_d, t_max, active_in, False, plain=False)


def any_hit_treelet(wbvh: WideBVH, ray_o, ray_d, t_max,
                    active_in=None) -> torch.Tensor:
    """Treelet-scheduled occlusion in (0, t_max), bool [N]."""
    return _run(wbvh, ray_o, ray_d, t_max, active_in, True, plain=False)


def closest_hit_treelet_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                              active_in=None, count_visits: bool = False):
    """Plain torch treelet closest hit on any device (the kernel's
    reference). Returns a Hit, or (Hit, Visits) with count_visits."""
    return _run(wbvh, ray_o, ray_d, t_max, active_in, False, plain=True,
                count_visits=count_visits)


def any_hit_treelet_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                          active_in=None, count_visits: bool = False):
    """Plain torch treelet any hit on any device."""
    return _run(wbvh, ray_o, ray_d, t_max, active_in, True, plain=True,
                count_visits=count_visits)
