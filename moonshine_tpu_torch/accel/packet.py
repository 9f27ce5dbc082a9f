"""Ray traversal over wide-BVH rows: closest hit and any hit (port of the
surface of moonshine_tpu/accel/packet.py).

`closest_hit_packet` and `any_hit_packet` launch the hand-written CUDA
kernels of csrc/traverse.cu for CUDA tensors, and run the plain torch
versions beside them (`closest_hit_plain`, `any_hit_plain`) for CPU
tensors; any other device raises. There is no fallback between the two:
a kernel that does not build or launch raises. The `_hbm` names are the
same functions: on the card one kernel serves every scene size.

Contract (the JAX wrappers'): `active_in=False` lanes are dead (tmax
becomes -1e30 inside) and so are lanes with tmax <= 0. Closest hit
returns t = the caller's t_max, tri = -1, u = v = 0 for a dead or missed
lane; any hit returns a bool, True for an occluder in (0, t_max).

The plain versions are the kernels' reference: one stack per lane
([N, S] tensor), children pushed far-to-near by the lane's own direction
sign on the node's sort axis, the same expressions in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import native
from .wide import WideBVH

_NEG = -1.0e30
_TINY = 1e-12

# Kernel launches per kernel, for showing that a run went through them.
# A wrapper adds one exactly where it launches; callers reset to 0.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Hit(NamedTuple):
    t: torch.Tensor  # [N] f32, = t_max on a miss
    tri: torch.Tensor  # [N] i32 original triangle id, -1 on a miss
    u: torch.Tensor  # [N] f32 barycentric of vertex 1
    v: torch.Tensor  # [N] f32 barycentric of vertex 2

    @property
    def is_hit(self):
        return self.tri >= 0


def stack_ok(wbvh: WideBVH, capacity: int) -> bool:
    """True when the tree's worst-case stack occupancy fits `capacity`."""
    return wbvh.max_stack <= capacity


# --- plain torch versions ---

def _rays(ray_o, ray_d):
    o = [ray_o[:, c] for c in range(3)]
    d = [ray_d[:, c] for c in range(3)]
    inv = []
    for c in d:
        sign_tiny = torch.where(c >= 0.0, _TINY, -_TINY)
        inv.append(1.0 / torch.where(torch.abs(c) < _TINY, sign_tiny, c))
    oinv = [o[c] * inv[c] for c in range(3)]
    return o, d, inv, oinv


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


def _traverse_plain(wbvh: WideBVH, ray_o, ray_d, t_caller, active_in,
                    any_hit: bool):
    N = ray_o.shape[0]
    dev = ray_o.device
    tmax = (t_caller if active_in is None
            else torch.where(active_in, t_caller, _NEG))
    o, d, inv, oinv = _rays(ray_o, ray_d)
    w, S = wbvh.width, wbvh.leaf_slots
    nodes = wbvh.nodes.reshape(wbvh.nodes.shape[0], -1)
    leaves = wbvh.leaves.reshape(wbvh.leaves.shape[0], -1)

    stack = torch.zeros((N, wbvh.max_stack), dtype=torch.int64, device=dev)
    top = (tmax > 0.0).to(torch.int64)  # the root (node 0) is pre-pushed
    t_best = tmax.clone()
    tri = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(N, dtype=torch.float32, device=dev)
    best_v = torch.zeros(N, dtype=torch.float32, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)

    lanes = torch.nonzero(top > 0).squeeze(1)
    while lanes.numel():
        top[lanes] -= 1
        node = stack[lanes, top[lanes]]
        internal = node >= 0

        li = lanes[internal]
        if li.numel():
            rows = nodes[node[internal]]
            n = len(li)
            ptr = rows[:, 6 * w:7 * w]
            t0 = [rows[:, c * w:(c + 1) * w] * inv[c][li, None]
                  - oinv[c][li, None] for c in range(3)]
            t1 = [rows[:, (3 + c) * w:(4 + c) * w] * inv[c][li, None]
                  - oinv[c][li, None] for c in range(3)]
            tnear = torch.maximum(
                torch.maximum(torch.minimum(t0[0], t1[0]),
                              torch.minimum(t0[1], t1[1])),
                torch.minimum(t0[2], t1[2]))
            tfar = torch.minimum(
                torch.minimum(torch.maximum(t0[0], t1[0]),
                              torch.maximum(t0[1], t1[1])),
                torch.maximum(t0[2], t1[2]))
            prune = (tmax if any_hit else t_best)[li, None]
            hit = ((torch.clamp_min(tnear, 0.0) <= torch.minimum(tfar, prune))
                   & (ptr != -1.0))
            axis = rows[:, 7 * w]
            ax = torch.where(axis < 0.5, 0, torch.where(axis < 1.5, 1, 2))
            fwd = (ray_d[li].gather(1, ax[:, None])[:, 0] >= 0.0)[:, None]
            # push far first: slot w-1 first when the ray runs forward
            hit = torch.where(fwd, hit.flip(1), hit)
            ptr = torch.where(fwd, ptr.flip(1), ptr).to(torch.int64)
            pos = top[li, None] + torch.cumsum(hit.to(torch.int64), 1) - 1
            lane_idx = li[:, None].expand(n, w)
            stack[lane_idx[hit], pos[hit]] = ptr[hit]
            top[li] += hit.sum(1)

        ll = lanes[~internal]
        if ll.numel():
            rows = leaves[-2 - node[~internal]]
            tid = rows[:, 9 * S:10 * S]
            ol = [c[ll] for c in o]
            dl = [c[ll] for c in d]
            comp = lambda k, j: rows[:, k * S + j]
            if any_hit:
                tm = tmax[ll]
                occ_l = torch.zeros(len(ll), dtype=torch.bool, device=dev)
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

        keep = top[lanes] > 0
        if any_hit:
            keep &= ~occ[lanes]
        lanes = lanes[keep]

    if any_hit:
        return occ
    t = torch.where(tri >= 0, t_best, t_caller)
    return Hit(t=t, tri=tri.to(torch.int32), u=best_u, v=best_v)


def _t_max_lanes(t_max, n, device) -> torch.Tensor:
    """t_max (scalar or [N]) as a contiguous float32 [N] tensor."""
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    if tm.ndim not in (0, 1) or (tm.ndim == 1 and tm.shape[0] != n):
        raise ValueError(f"t_max must be a scalar or [{n}], got "
                         f"{tuple(tm.shape)}")
    return tm.expand(n).contiguous()


def _check_rays(wbvh: WideBVH, ray_o, ray_d, active_in):
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be float32 [N, 3], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if ray_o.shape != ray_d.shape:
        raise ValueError("ray_o and ray_d differ in shape")
    if ray_o.device != ray_d.device or ray_o.device != wbvh.nodes.device:
        raise ValueError("rays and BVH rows must be on one device")
    if active_in is not None and (active_in.dtype != torch.bool
                                  or active_in.shape != ray_o.shape[:1]
                                  or active_in.device != ray_o.device):
        raise ValueError("active_in must be a bool [N] tensor on the rays' "
                         "device")


def closest_hit_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                      active_in=None) -> Hit:
    """Plain torch closest hit (the CUDA kernel's reference)."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    t_caller = _t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
    return _traverse_plain(wbvh, ray_o, ray_d, t_caller, active_in, False)


def any_hit_plain(wbvh: WideBVH, ray_o, ray_d, t_max,
                  active_in=None) -> torch.Tensor:
    """Plain torch any hit (the CUDA kernel's reference)."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    t_caller = _t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
    return _traverse_plain(wbvh, ray_o, ray_d, t_caller, active_in, True)


# --- CUDA wrappers ---

def _launch_args(lib, wbvh: WideBVH, ray_o, ray_d, t_max, active_in):
    if not stack_ok(wbvh, lib.stack_capacity):
        raise ValueError(
            f"tree needs a {wbvh.max_stack}-entry traversal stack; the "
            f"kernel holds {lib.stack_capacity}")
    for name, x in (("nodes", wbvh.nodes), ("leaves", wbvh.leaves)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    n = ray_o.shape[0]
    if n >= 2**31:
        raise ValueError("too many rays for one launch")
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    t_lanes = _t_max_lanes(t_max, n, ray_o.device)
    act = None if active_in is None else active_in.contiguous()
    keep = (ray_o, ray_d, t_lanes, act)  # alive until the launch returns
    args = [
        wbvh.nodes.data_ptr(), wbvh.leaves.data_ptr(),
        wbvh.nodes[0].numel(), wbvh.leaves[0].numel(),
        wbvh.width, wbvh.leaf_slots,
        ray_o.data_ptr(), ray_d.data_ptr(), t_lanes.data_ptr(),
        None if act is None else act.data_ptr(), n,
    ]
    return args, keep


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _device_kind(ray_o) -> str:
    kind = ray_o.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no traversal for device {ray_o.device}")
    return kind


def closest_hit_packet(wbvh: WideBVH, ray_o, ray_d, t_max,
                       active_in=None) -> Hit:
    """Closest hit per ray: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return closest_hit_plain(wbvh, ray_o, ray_d, t_max, active_in)
    lib = native.traverse_lib()
    args, _keep = _launch_args(lib, wbvh, ray_o, ray_d, t_max, active_in)
    n = ray_o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=ray_o.device)
    tri = torch.empty(n, dtype=torch.int32, device=ray_o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        rc = lib.closest_hit(*args, t.data_ptr(), tri.data_ptr(),
                             u.data_ptr(), v.data_ptr(),
                             _stream(ray_o.device))
        if rc != 0:
            raise RuntimeError(f"closest-hit kernel launch failed: "
                               f"cudaError {rc}")
        LAUNCHES["closest_hit"] += 1
    return Hit(t=t, tri=tri, u=u, v=v)


def any_hit_packet(wbvh: WideBVH, ray_o, ray_d, t_max,
                   active_in=None) -> torch.Tensor:
    """Occlusion in (0, t_max) per ray as bool: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_rays(wbvh, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return any_hit_plain(wbvh, ray_o, ray_d, t_max, active_in)
    lib = native.traverse_lib()
    args, _keep = _launch_args(lib, wbvh, ray_o, ray_d, t_max, active_in)
    n = ray_o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=ray_o.device)
    if n:
        rc = lib.any_hit(*args, occ.data_ptr(), _stream(ray_o.device))
        if rc != 0:
            raise RuntimeError(f"any-hit kernel launch failed: "
                               f"cudaError {rc}")
        LAUNCHES["any_hit"] += 1
    return occ


# the reference's HBM-streaming variants: on the card the same kernel
closest_hit_packet_hbm = closest_hit_packet
any_hit_packet_hbm = any_hit_packet
