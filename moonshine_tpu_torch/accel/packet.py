"""Ray traversal over wide-BVH rows: closest hit and any hit (port of the
surface of moonshine_tpu/accel/packet.py).

`closest_hit_packet` and `any_hit_packet` launch the hand-written CUDA
kernels of csrc/traverse.cu for CUDA tensors, and run the plain torch
versions beside them (`closest_hit_plain`, `any_hit_plain`) for CPU
tensors; any other device raises. There is no fallback between the two:
a kernel that does not build or launch raises. On the card one kernel
serves every scene size; the `_hbm` names differ only in sorting the
rays by coherence first (`sort=True`, their default) and restoring lane
order after, as the reference's do. `fits_vmem` and `stack_ok` keep the
reference's residency rule and its two stack limits, so that dispatch
(integrator/path.py) picks what the reference would pick.

Contract (the JAX wrappers'): `active_in=False` lanes are dead (tmax
becomes -1e30 inside) and so are lanes with tmax <= 0. Closest hit
returns t = the caller's t_max, tri = -1, u = v = 0 for a dead or missed
lane; any hit returns a bool, True for an occluder in (0, t_max).

The plain versions are the kernels' reference: one stack per lane
([N, S] tensor), children pushed far-to-near by the lane's own direction
sign on the node's sort axis, the same expressions in the same order.
With count_visits=True they also return what the traversal touched
(`Visits`), from which a kernel's least time is bounded.
"""

from __future__ import annotations

import contextlib
import numbers
import threading
from typing import NamedTuple

import torch

from . import native
from .wide import WideBVH

_NEG = -1.0e30
_TINY = 1e-12

# The reference's stack limits: 512 entries for scenes whose rows fit its
# VMEM budget, 256 for scenes streamed from HBM. The CUDA kernel holds
# 512 (csrc/visit.cuh); integrator/path.py applies the 256 limit to
# HBM-class scenes as the reference does.
STACK_DEPTH = 512
HBM_STACK_DEPTH = 256
# Scene rows up to this size are "VMEM-class" in the reference. On the
# card it decides only which dispatch and resort default the reference
# would pick; it is not a memory limit.
VMEM_SCENE_BUDGET_BYTES = 10 * 1024 * 1024

# The CUDA kernels' blocks (csrc/group_walk.cuh's kBlockGroups, for rows
# and for format V): a block of GROUPS_PER_BLOCK lane groups, each tracing
# one ray with its own stack, shares one copy of the tree's top records;
# a block may hold at most SHARED_BYTES_MAX bytes of shared memory on the
# H100 (227 KB)
GROUPS_PER_BLOCK = 64
SHARED_BYTES_MAX = 232_448

# Kernel launches per kernel, for showing that a run went through them.
# A wrapper adds one exactly where it launches; callers reset to 0. A
# wrapper called while its thread captures a CUDA graph launches nothing:
# its count goes to the capture's tally, which each replay of the graph
# adds (integrator/graphs.py).
LAUNCHES = {"closest_hit": 0, "any_hit": 0}
# the Engine's pick launches from another thread while a frame does
# (engine/engine.py), so the counts add under a lock
_COUNT_LOCK = threading.Lock()
_CAPTURE = threading.local()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Hit(NamedTuple):
    t: torch.Tensor  # [N] f32, = t_max on a miss
    tri: torch.Tensor  # [N] i32 original triangle id, -1 on a miss
    u: torch.Tensor  # [N] f32 barycentric of vertex 1
    v: torch.Tensor  # [N] f32 barycentric of vertex 2
    # the instance of each hit: None here, where the triangle ids are of
    # flattened world rows (their instance is tri_shade column 26); the
    # two-level walk returns accel/tlas.py's TlasHit, whose `inst` holds it
    inst = None

    @property
    def is_hit(self):
        return self.tri >= 0


def row_bytes(wbvh: WideBVH) -> int:
    """Bytes of the node and leaf rows."""
    return sum(x.numel() * x.element_size()
               for x in (wbvh.nodes, wbvh.leaves))


def fits_vmem(wbvh: WideBVH) -> bool:
    return row_bytes(wbvh) <= VMEM_SCENE_BUDGET_BYTES


def stack_ok(wbvh: WideBVH, hbm: bool) -> bool:
    """True when the tree's worst-case stack occupancy fits the
    reference's stack for its residency."""
    return wbvh.max_stack <= (HBM_STACK_DEPTH if hbm else STACK_DEPTH)


class KernelLayout(NamedTuple):
    """What the CUDA kernel keeps in one block's shared memory."""

    top_rows: int  # R: node rows 0..R-1, the root and its internal children
    stack_depth: int  # entries of each group's stack: the tree's max_stack
    shared_bytes: int  # the R rows, then GROUPS_PER_BLOCK int32 stacks


def kernel_layout(wbvh: WideBVH) -> KernelLayout:
    """The shared-memory layout the kernel gets for this tree (plain
    Python: only the tree's static facts are read)."""
    row = wbvh.nodes.stride(0) * 4  # contiguous: the floats of a row
    stacks = GROUPS_PER_BLOCK * wbvh.max_stack * 4
    return KernelLayout(wbvh.top_rows, wbvh.max_stack,
                        wbvh.top_rows * row + stacks)


# --- plain torch versions ---

def _tri_closest(v0, e1, e2, o, d, t_best):
    """Moller-Trumbore with exact division; components as [n] tensors."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    det_c = torch.where(torch.abs(det) < _TINY, _TINY, det)
    inv_det = 1.0 / det_c
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    valid = ((torch.abs(det) > _TINY) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0) & (t < t_best))
    return valid, t, u, v


def _tri_any(v0, e1, e2, o, d, t_max):
    """Division-free occlusion test (numerators scaled by |det|)."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    s = torch.where(det >= 0.0, 1.0, -1.0)
    tx = o[0] - v0[0]
    ty = o[1] - v0[1]
    tz = o[2] - v0[2]
    u_n = (tx * px + ty * py + tz * pz) * s
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v_n = (d[0] * qx + d[1] * qy + d[2] * qz) * s
    t_n = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * s
    det_a = det * s
    return ((det_a > _TINY) & (u_n >= 0.0) & (v_n >= 0.0)
            & (u_n + v_n <= det_a) & (t_n > 0.0) & (t_n < t_max * det_a))


class Visits(NamedTuple):
    """What one plain traversal touched, for the kernels' bound: visits,
    occupied child slots tested at internal visits, occupied triangle
    slots tested at leaf visits, and distinct rows read; for the treelet
    walk also the (lane, treelet) root visits skipped because the lane
    entered the treelet's box beyond its t_best."""

    nodes: int
    leaves: int
    node_slots: int
    leaf_tris: int
    node_rows: int
    leaf_rows: int
    roots_skipped: int = 0


# fp32 operations per occupied slot, counted off the plain expressions
# (mul, add/sub, div, min/max, abs and compares; selects not counted): a
# child box test (both hit forms), a closest-hit Moller-Trumbore, and the
# division-free any-hit test
FLOPS_PER_NODE_SLOT = 25
FLOPS_PER_TRI_CLOSEST = 55
FLOPS_PER_TRI_ANY = 54


def _row_node_fields(wbvh: WideBVH, ids):
    """(lo, hi, ptr, axis) of node rows `ids`: lo and hi three [n, w]
    components, ptr [n, w], axis [n]."""
    w = wbvh.width
    rows = wbvh.nodes.reshape(wbvh.nodes.shape[0], -1)[ids]
    return ([rows[:, c * w:(c + 1) * w] for c in range(3)],
            [rows[:, (3 + c) * w:(4 + c) * w] for c in range(3)],
            rows[:, 6 * w:7 * w], rows[:, 7 * w])


def _row_leaf_fields(wbvh: WideBVH, ids):
    """Leaf rows `ids` as [n, 10, S]: field f (v0 xyz, e1 xyz, e2 xyz,
    tid) of slot j at [:, f, j]."""
    S = wbvh.leaf_slots
    rows = wbvh.leaves.reshape(wbvh.leaves.shape[0], -1)[ids]
    return rows[:, :10 * S].reshape(-1, 10, S)


def _walk(wbvh: WideBVH, r, st: dict, lanes, roots, any_hit: bool,
          treelet_form: bool, stack, counts: dict | None,
          node_fields=_row_node_fields, leaf_fields=_row_leaf_fields):
    """Traverse each lane of `lanes` from its root in `roots` until its
    stack empties (or, for any hit, it is occluded), updating the lane
    state `st` (t_best, tri, u, v, occ) in place.

    treelet_form selects the treelet kernel's child test,
    `(b - o) * inv` slabs and `tnear <= tfar & tfar >= 0 & tnear <=
    prune`; otherwise the packet kernel's `b * inv - oinv` slabs and
    `max(tnear, 0) <= min(tfar, prune)`. The two agree for live lanes up
    to rounding. node_fields and leaf_fields read the records (rows here,
    format-V tiles in vpacket.py)."""
    o, d, inv, oinv, ray_d = r
    dev = inv[0].device
    w, S = wbvh.width, wbvh.leaf_slots
    tmax, t_best, tri = st["tmax"], st["t_best"], st["tri"]
    best_u, best_v, occ = st["u"], st["v"], st["occ"]
    top = torch.zeros(tmax.shape[0], dtype=torch.int64, device=dev)
    stack[lanes, 0] = roots
    top[lanes] = 1

    while lanes.numel():
        top[lanes] -= 1
        node = stack[lanes, top[lanes]]
        internal = node >= 0

        li = lanes[internal]
        if li.numel():
            ids = node[internal]
            n = len(li)
            lo, hi, ptr, axis = node_fields(wbvh, ids)
            if treelet_form:
                t0 = [(lo[c] - o[c][li, None]) * inv[c][li, None]
                      for c in range(3)]
                t1 = [(hi[c] - o[c][li, None]) * inv[c][li, None]
                      for c in range(3)]
            else:
                t0 = [lo[c] * inv[c][li, None] - oinv[c][li, None]
                      for c in range(3)]
                t1 = [hi[c] * inv[c][li, None] - oinv[c][li, None]
                      for c in range(3)]
            tnear = torch.maximum(
                torch.maximum(torch.minimum(t0[0], t1[0]),
                              torch.minimum(t0[1], t1[1])),
                torch.minimum(t0[2], t1[2]))
            tfar = torch.minimum(
                torch.minimum(torch.maximum(t0[0], t1[0]),
                              torch.maximum(t0[1], t1[1])),
                torch.maximum(t0[2], t1[2]))
            prune = (tmax if any_hit else t_best)[li, None]
            if treelet_form:
                hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= prune)
            else:
                hit = (torch.clamp_min(tnear, 0.0)
                       <= torch.minimum(tfar, prune))
            used = ptr != -1.0
            hit &= used
            ax = torch.where(axis < 0.5, 0, torch.where(axis < 1.5, 1, 2))
            fwd = (ray_d[li].gather(1, ax[:, None])[:, 0] >= 0.0)[:, None]
            # push far first: slot w-1 first when the ray runs forward
            hit = torch.where(fwd, hit.flip(1), hit)
            ptr = torch.where(fwd, ptr.flip(1), ptr).to(torch.int64)
            pos = top[li, None] + torch.cumsum(hit.to(torch.int64), 1) - 1
            lane_idx = li[:, None].expand(n, w)
            stack[lane_idx[hit], pos[hit]] = ptr[hit]
            top[li] += hit.sum(1)
            if counts is not None:
                counts["nodes"] += n
                counts["node_slots"] += int(used.sum())
                counts["node_seen"][ids] = True

        ll = lanes[~internal]
        if ll.numel():
            ids = -2 - node[~internal]
            fields = leaf_fields(wbvh, ids)
            tid = fields[:, 9]
            ol = [c[ll] for c in o]
            dl = [c[ll] for c in d]
            comp = lambda k, j: fields[:, k, j]
            if any_hit:
                tm = tmax[ll]
                occ_l = occ[ll]
                for j in range(S):
                    v0, e1, e2 = ([comp(k, j) for k in range(b, b + 3)]
                                  for b in (0, 3, 6))
                    occ_l |= _tri_any(v0, e1, e2, ol, dl, tm) & (tid[:, j]
                                                                >= 0.0)
                occ[ll] = occ_l
            else:
                tb, tr = t_best[ll], tri[ll]
                bu, bv = best_u[ll], best_v[ll]
                for j in range(S):
                    v0, e1, e2 = ([comp(k, j) for k in range(b, b + 3)]
                                  for b in (0, 3, 6))
                    valid, t, u, v = _tri_closest(v0, e1, e2, ol, dl, tb)
                    valid &= tid[:, j] >= 0.0
                    tb = torch.where(valid, t, tb)
                    tr = torch.where(valid, tid[:, j].to(torch.int64), tr)
                    bu = torch.where(valid, u, bu)
                    bv = torch.where(valid, v, bv)
                t_best[ll], tri[ll] = tb, tr
                best_u[ll], best_v[ll] = bu, bv
            if counts is not None:
                counts["leaves"] += len(ll)
                counts["leaf_tris"] += int((tid >= 0.0).sum())
                counts["leaf_seen"][ids] = True

        keep = top[lanes] > 0
        if any_hit:
            keep &= ~occ[lanes]
        lanes = lanes[keep]


def _plain_state(wbvh: WideBVH, ray_o, ray_d, t_eff, count_visits: bool,
                 stack_depth: int | None = None):
    """(ray terms, lane state, stack, visit counters) for a plain walk
    over lanes whose effective t_max is `t_eff` (dead lanes <= 0); the
    stack holds `stack_depth` entries a lane (default: the tree's
    max_stack; a walk past it raises)."""
    N = ray_o.shape[0]
    dev = ray_o.device
    o = list(ray_o.unbind(1))
    d = list(ray_d.unbind(1))
    inv = []
    for c in d:
        sign_tiny = torch.where(c >= 0.0, _TINY, -_TINY)
        inv.append(1.0 / torch.where(torch.abs(c) < _TINY, sign_tiny, c))
    oinv = [o[c] * inv[c] for c in range(3)]
    st = dict(
        tmax=t_eff, t_best=t_eff.clone(),
        tri=torch.full((N,), -1, dtype=torch.int64, device=dev),
        u=torch.zeros(N, dtype=torch.float32, device=dev),
        v=torch.zeros(N, dtype=torch.float32, device=dev),
        occ=torch.zeros(N, dtype=torch.bool, device=dev),
    )
    stack = torch.zeros((N, stack_depth or wbvh.max_stack),
                        dtype=torch.int64, device=dev)
    counts = None
    if count_visits:
        counts = dict(
            nodes=0, leaves=0, node_slots=0, leaf_tris=0, roots_skipped=0,
            node_seen=torch.zeros(wbvh.nodes.shape[0], dtype=torch.bool,
                                  device=dev),
            leaf_seen=torch.zeros(wbvh.leaves.shape[0], dtype=torch.bool,
                                  device=dev))
    return (o, d, inv, oinv, ray_d), st, stack, counts


def _visits(counts: dict) -> Visits:
    return Visits(nodes=counts["nodes"], leaves=counts["leaves"],
                  node_slots=counts["node_slots"],
                  leaf_tris=counts["leaf_tris"],
                  node_rows=int(counts["node_seen"].sum()),
                  leaf_rows=int(counts["leaf_seen"].sum()),
                  roots_skipped=counts["roots_skipped"])


def _plain_result(st: dict, t_caller, any_hit: bool):
    if any_hit:
        return st["occ"]
    tri = st["tri"]
    t = torch.where(tri >= 0, st["t_best"], t_caller)
    return Hit(t=t, tri=tri.to(torch.int32), u=st["u"], v=st["v"])


def _traverse_plain(wbvh: WideBVH, ray_o, ray_d, t_caller, active_in,
                    any_hit: bool, count_visits: bool = False, **fields):
    tmax = (t_caller if active_in is None
            else torch.where(active_in, t_caller, _NEG))
    r, st, stack, counts = _plain_state(wbvh, ray_o, ray_d, tmax,
                                        count_visits)
    lanes = torch.nonzero(tmax > 0.0).squeeze(1)
    roots = torch.zeros_like(lanes)  # node 0 is the root
    _walk(wbvh, r, st, lanes, roots, any_hit, False, stack, counts,
          **fields)
    out = _plain_result(st, t_caller, any_hit)
    return (out, _visits(counts)) if count_visits else out


def _t_max_lanes(t_max, n, device) -> torch.Tensor:
    """t_max (scalar or [N]) as a contiguous float32 [N] tensor. A Python
    number is filled on the device (no host-to-device copy, so a CUDA
    graph may capture the call)."""
    if isinstance(t_max, numbers.Real):
        return torch.full((n,), t_max, dtype=torch.float32, device=device)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    if tm.ndim not in (0, 1) or (tm.ndim == 1 and tm.shape[0] != n):
        raise ValueError(f"t_max must be a scalar or [{n}], got "
                         f"{tuple(tm.shape)}")
    return tm.expand(n).contiguous()


def _check_rays(wbvh: WideBVH, ray_o, ray_d, active_in, device=None):
    """Raise unless the rays (float32 [N, 3]) and active_in (bool [N] or
    None) lie on the device of the tree's rows, or on `device`."""
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be float32 [N, 3], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if ray_o.shape != ray_d.shape:
        raise ValueError("ray_o and ray_d differ in shape")
    device = wbvh.nodes.device if device is None else device
    if ray_o.device != ray_d.device or ray_o.device != device:
        raise ValueError("rays and the tree must be on one device")
    if active_in is not None and (active_in.dtype != torch.bool
                                  or active_in.shape != ray_o.shape[:1]
                                  or active_in.device != ray_o.device):
        raise ValueError("active_in must be a bool [N] tensor on the rays' "
                         "device")


def closest_hit_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                      active_in=None, count_visits: bool = False):
    """Plain torch closest hit (the CUDA kernel's reference). Returns a
    Hit, or (Hit, Visits) with count_visits."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    t_caller = _t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
    return _traverse_plain(wbvh, ray_o, ray_d, t_caller, active_in, False,
                           count_visits)


def any_hit_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                  active_in=None, count_visits: bool = False):
    """Plain torch any hit (the CUDA kernel's reference). Returns bool
    [N], or (bool [N], Visits) with count_visits."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    t_caller = _t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
    return _traverse_plain(wbvh, ray_o, ray_d, t_caller, active_in, True,
                           count_visits)


def sort_key(wbvh: WideBVH, ray_o, ray_d, active=None):
    """Coherence key (the reference's _sort_key): 4^3 origin cells x 8
    direction octants, dead lanes keyed 1 << 20 so they sort last."""
    lo = wbvh.bounds[0]
    inv_ext = 1.0 / torch.clamp_min(wbvh.bounds[1] - lo, 1e-20)
    cell = torch.clamp(((ray_o - lo) * inv_ext * 4.0).to(torch.int32), 0, 3)
    octant = ((ray_d[:, 0] > 0).to(torch.int32) * 4
              + (ray_d[:, 1] > 0).to(torch.int32) * 2
              + (ray_d[:, 2] > 0).to(torch.int32))
    key = ((cell[:, 0] * 4 + cell[:, 1]) * 4 + cell[:, 2]) * 8 + octant
    if active is not None:
        key = torch.where(active, key, 1 << 20)
    return key


# --- CUDA wrappers ---

def _check_launch(lib, wbvh: WideBVH, n: int):
    """Raise unless a kernel of `lib` can take this tree and n rays."""
    if wbvh.max_stack > lib.stack_capacity:
        raise ValueError(
            f"tree needs a {wbvh.max_stack}-entry traversal stack; the "
            f"kernel holds {lib.stack_capacity}")
    for name, x in (("nodes", wbvh.nodes), ("leaves", wbvh.leaves)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if n >= 2**31:
        raise ValueError("too many rays for one launch")


def _launch_args(lib, wbvh: WideBVH, ray_o, ray_d, t_max, active_in):
    n = ray_o.shape[0]
    _check_launch(lib, wbvh, n)
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    t_lanes = _t_max_lanes(t_max, n, ray_o.device)
    act = None if active_in is None else active_in.contiguous()
    keep = (ray_o, ray_d, t_lanes, act)  # alive until the launch returns
    args = [
        wbvh.nodes.data_ptr(), wbvh.leaves.data_ptr(),
        wbvh.nodes.stride(0), wbvh.leaves.stride(0),  # floats a row
        wbvh.width, wbvh.leaf_slots,
        ray_o.data_ptr(), ray_d.data_ptr(), t_lanes.data_ptr(),
        None if act is None else act.data_ptr(), n,
    ]
    return args, keep


def _call_on(fn, device, *args) -> int:
    """fn(*args, stream): a C entry point called with `device` made the
    thread's current CUDA device and given that device's current stream.
    The entry points launch on the calling thread's current device (and
    a null stream means that device's), so a caller on another card's
    tensors launches on the right one."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def count_launch(counts: dict, key: str) -> None:
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:  # captured, not launched: counted at each replay
        tally.append((counts, key))
        return
    with _COUNT_LOCK:
        counts[key] += 1


@contextlib.contextmanager
def launch_tally():
    """The launches that this thread's wrappers make inside the block, as
    a list of (counts, key), instead of counting them: for a CUDA graph
    capture, whose kernels launch only when it is replayed."""
    tally = []
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def count_replay(tally) -> None:
    """Add a captured graph's launches (its `launch_tally`) to the counts:
    one replay launches each of them once."""
    with _COUNT_LOCK:
        for counts, key in tally:
            counts[key] += 1


def _device_kind(ray_o) -> str:
    kind = ray_o.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no traversal for device {ray_o.device}")
    return kind


def _launch(lib, counts: dict, key: str, wbvh, ray_o, ray_d, t_max,
            active_in, any_hit: bool, layout_of=kernel_layout):
    """One launch of `lib`'s closest-hit or any-hit kernel (the C entry
    points of traverse.cu or vpacket.cu) on checked rays; counts[key] adds
    one where the kernel launches. Entry points with a launch layout
    (`lib.layout`) also take the tree's (`layout_of(wbvh)`: this module's
    kernel_layout for rows, vpacket's for tiles) and 4 bytes for the ray
    counter, which the launch zeroes. Returns a Hit or a bool tensor."""
    args, _keep = _launch_args(lib, wbvh, ray_o, ray_d, t_max, active_in)
    n, dev = ray_o.shape[0], ray_o.device
    if any_hit:
        out = (torch.empty(n, dtype=torch.bool, device=dev),)
        fn = lib.any_hit
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        out = (t, torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty_like(t), torch.empty_like(t))
        fn = lib.closest_hit
    if n:
        if lib.layout:
            layout = layout_of(wbvh)
            next_ray = torch.empty(1, dtype=torch.int32, device=dev)
            args += [layout.top_rows, layout.stack_depth,
                     next_ray.data_ptr()]
        rc = _call_on(fn, dev, *args, *(x.data_ptr() for x in out))
        if rc != 0:
            raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
        count_launch(counts, key)
    return out[0] if any_hit else Hit(*out)


def closest_hit_packet(wbvh: WideBVH, ray_o, ray_d, t_max,
                       active_in=None) -> Hit:
    """Closest hit per ray: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return closest_hit_plain(wbvh, ray_o, ray_d, t_max, active_in)
    return _launch(native.traverse_lib(), LAUNCHES, "closest_hit", wbvh,
                   ray_o, ray_d, t_max, active_in, False)


def any_hit_packet(wbvh: WideBVH, ray_o, ray_d, t_max,
                   active_in=None) -> torch.Tensor:
    """Occlusion in (0, t_max) per ray as bool: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return any_hit_plain(wbvh, ray_o, ray_d, t_max, active_in)
    return _launch(native.traverse_lib(), LAUNCHES, "any_hit", wbvh, ray_o,
                   ray_d, t_max, active_in, True)


def _sorted(fn, wbvh: WideBVH, ray_o, ray_d, t_max, active_in):
    """fn on coherence-sorted rays (stable sort), results back in lane
    order. Each lane's result does not depend on its neighbours, so the
    sort changes speed only."""
    n = ray_o.shape[0]
    perm = torch.argsort(sort_key(wbvh, ray_o, ray_d, active_in),
                         stable=True)
    t_lanes = _t_max_lanes(t_max, n, ray_o.device)
    out = fn(wbvh, ray_o[perm], ray_d[perm], t_lanes[perm],
             None if active_in is None else active_in[perm])
    unsort = lambda x: torch.empty_like(x).index_copy_(0, perm, x)
    if isinstance(out, Hit):
        return Hit(*(unsort(x) for x in out))
    return unsort(out)


def closest_hit_packet_hbm(wbvh: WideBVH, ray_o, ray_d, t_max,
                           active_in=None, sort: bool = True) -> Hit:
    """The reference's HBM-streaming variant: the same kernel, on rays
    coherence-sorted first unless the caller keeps its batch sorted
    (sort=False: the integrator's per-bounce state resort)."""
    if not sort:
        return closest_hit_packet(wbvh, ray_o, ray_d, t_max, active_in)
    _check_rays(wbvh, ray_o, ray_d, active_in)
    return _sorted(closest_hit_packet, wbvh, ray_o, ray_d, t_max, active_in)


def any_hit_packet_hbm(wbvh: WideBVH, ray_o, ray_d, t_max,
                       active_in=None, sort: bool = True) -> torch.Tensor:
    if not sort:
        return any_hit_packet(wbvh, ray_o, ray_d, t_max, active_in)
    _check_rays(wbvh, ray_o, ray_d, active_in)
    return _sorted(any_hit_packet, wbvh, ray_o, ray_d, t_max, active_in)
