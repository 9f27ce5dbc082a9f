"""Per-lane stackless traversal of the binary BVH (port of
moonshine_tpu/accel/traverse.py).

The dispatch's fourth mode (integrator/path.py `_hbm_mode` -> "lanes"):
where a scene has no wide tree, or is HBM-class with a stack bound over
the reference's HBM limit, every lane walks the binary BVH on its own
cursor. Skip links (`escape`) make the walk stackless: a missed box or a
finished leaf moves the cursor to its escape, a hit internal node to its
left child; a leaf tests a fixed bundle of `leaf_size` triangles
(Moller-Trumbore). The loop runs while any cursor is >= 0. `any_hit`
stops a lane at its first occluder.

The reference has no Pallas kernel here (its walk is one jnp while_loop),
so neither has the port: these are torch ops on whichever device the
tensors are on. Each iteration works on the lanes still walking only; a
lane's result does not depend on the others, so this changes speed, not
results. `brute_force_closest` is the O(N*T) oracle the tests use.

`CALLS` counts calls of `closest_hit` and `any_hit`, so that a render can
show that it went through this mode.
"""

from __future__ import annotations

import torch

from .lbvh import BVH
from .packet import Hit

_TINY = 1e-12
# triangles per brute-force step ([N, chunk] temporaries)
_BRUTE_CHUNK = 256

CALLS = {"closest_hit": 0, "any_hit": 0}


def reset_call_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _safe_inv(d):
    sgn = torch.where(d >= 0.0, 1.0, -1.0)
    return 1.0 / torch.where(torch.abs(d) < _TINY, sgn * _TINY, d)


def _aabb_hit(amin, amax, o, inv_d, t_best):
    t0 = (amin - o) * inv_d
    t1 = (amax - o) * inv_d
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_best)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _tri_intersect(v0, v1, v2, o, d, t_min, t_best):
    """Moller-Trumbore over [..., 3] components. Returns (hit, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < _TINY, _TINY, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) > _TINY) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_best))
    return hit, t, u, v


def _start(bvh: BVH, ray_o, ray_d, t_max, active_in):
    """(t_max per lane, 1/d, lanes that start at the root)."""
    n = ray_o.shape[0]
    if bvh.aabb_min.device != ray_o.device:
        raise ValueError("rays and BVH must be on one device")
    t_lanes = torch.as_tensor(t_max, dtype=torch.float32,
                              device=ray_o.device).expand(n).clone()
    walking = (torch.ones(n, dtype=torch.bool, device=ray_o.device)
               if active_in is None else active_in.clone())
    return t_lanes, _safe_inv(ray_d), torch.nonzero(walking).squeeze(1)


def _visit(bvh: BVH, cur, lanes, ray_o, inv_d, prune):
    """One node per walking lane: (node ids, box hit, left, count)."""
    node = cur[lanes]
    box_hit = _aabb_hit(bvh.aabb_min[node], bvh.aabb_max[node], ray_o[lanes],
                        inv_d[lanes], prune)
    return node, box_hit, bvh.left[node], bvh.count[node]


def closest_hit(bvh: BVH, sorted_tri_verts, ray_o, ray_d, t_max,
                leaf_size: int = 4, active_in=None) -> Hit:
    """Closest intersection along each ray. Inactive lanes return a miss
    (t = t_max, tri = -1, u = v = 0)."""
    CALLS["closest_hit"] += 1
    n = ray_o.shape[0]
    t_best, inv_d, lanes = _start(bvh, ray_o, ray_d, t_max, active_in)
    cur = torch.full((n,), -1, dtype=torch.int64, device=ray_o.device)
    cur[lanes] = 0
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=ray_o.device)
    best_u = torch.zeros(n, dtype=torch.float32, device=ray_o.device)
    best_v = torch.zeros_like(best_u)
    n_tris = bvh.tri_order.shape[0]
    while lanes.numel():
        tb = t_best[lanes]
        node, box_hit, left, count = _visit(bvh, cur, lanes, ray_o, inv_d, tb)
        is_leaf = count > 0
        leaf_do = box_hit & is_leaf
        o, d = ray_o[lanes], ray_d[lanes]
        bt, bu, bv = best_tri[lanes], best_u[lanes], best_v[lanes]
        for j in range(leaf_size):
            s_idx = torch.clamp(left + j, 0, n_tris - 1)
            tri = sorted_tri_verts[s_idx]
            h, t, u, v = _tri_intersect(tri[:, 0], tri[:, 1], tri[:, 2], o, d,
                                        0.0, tb)
            take = leaf_do & (j < count) & h
            tb = torch.where(take, t, tb)
            bt = torch.where(take, bvh.tri_order[s_idx].to(torch.int32), bt)
            bu = torch.where(take, u, bu)
            bv = torch.where(take, v, bv)
        t_best[lanes], best_tri[lanes] = tb, bt
        best_u[lanes], best_v[lanes] = bu, bv
        nxt = torch.where(box_hit & ~is_leaf, left, bvh.escape[node])
        cur[lanes] = nxt
        lanes = lanes[nxt >= 0]
    return Hit(t=t_best, tri=best_tri, u=best_u, v=best_v)


def any_hit(bvh: BVH, sorted_tri_verts, ray_o, ray_d, t_max,
            leaf_size: int = 4, active_in=None) -> torch.Tensor:
    """True where any occluder lies in (0, t_max). Lanes stop at their
    first hit."""
    CALLS["any_hit"] += 1
    n = ray_o.shape[0]
    t_lanes, inv_d, lanes = _start(bvh, ray_o, ray_d, t_max, active_in)
    cur = torch.full((n,), -1, dtype=torch.int64, device=ray_o.device)
    cur[lanes] = 0
    occluded = torch.zeros(n, dtype=torch.bool, device=ray_o.device)
    n_tris = bvh.tri_order.shape[0]
    while lanes.numel():
        tm = t_lanes[lanes]
        node, box_hit, left, count = _visit(bvh, cur, lanes, ray_o, inv_d, tm)
        is_leaf = count > 0
        leaf_do = box_hit & is_leaf
        o, d = ray_o[lanes], ray_d[lanes]
        found = torch.zeros_like(leaf_do)
        for j in range(leaf_size):
            s_idx = torch.clamp(left + j, 0, n_tris - 1)
            tri = sorted_tri_verts[s_idx]
            h, _, _, _ = _tri_intersect(tri[:, 0], tri[:, 1], tri[:, 2], o, d,
                                        0.0, tm)
            found |= leaf_do & (j < count) & h
        occluded[lanes] |= found
        nxt = torch.where(box_hit & ~is_leaf, left, bvh.escape[node])
        nxt = torch.where(found, -1, nxt)  # lane done at its first hit
        cur[lanes] = nxt
        lanes = lanes[nxt >= 0]
    return occluded


def brute_force_closest(tri_verts, ray_o, ray_d, t_max) -> Hit:
    """O(N*T) reference intersector for tests: every ray against every
    triangle in index order, a later triangle taken only at a strictly
    smaller t (the reference's sequential scan, `_BRUTE_CHUNK` triangles
    at a time)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    t_best = torch.as_tensor(t_max, dtype=torch.float32,
                             device=dev).expand(n).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    o, d = ray_o[:, None], ray_d[:, None]
    for s in range(0, tri_verts.shape[0], _BRUTE_CHUNK):
        tri = tri_verts[s:s + _BRUTE_CHUNK][None]
        h, t, u, v = _tri_intersect(tri[:, :, 0], tri[:, :, 1], tri[:, :, 2],
                                    o, d, 0.0, t_best[:, None])
        # the chunk's first triangle at its smallest valid t
        t_h = torch.where(h, t, torch.inf)
        t_min, _ = t_h.min(dim=1)
        first = torch.argmax((h & (t_h == t_min[:, None])).to(torch.int8),
                             dim=1)
        take = h.any(dim=1)
        pick = lambda x: x.gather(1, first[:, None])[:, 0]
        t_best = torch.where(take, t_min, t_best)
        best_tri = torch.where(take, (first + s).to(torch.int32), best_tri)
        best_u = torch.where(take, pick(u), best_u)
        best_v = torch.where(take, pick(v), best_v)
    return Hit(t=t_best, tri=best_tri, u=best_u, v=best_v)
