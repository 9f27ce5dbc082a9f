"""Two-level instancing: a top-level tree over instance boxes and one
shared object-space tree (BLAS) per unique geometry group (port of
moonshine_tpu/accel/tlas.py; the upstream engine's BLAS dedup,
Accel.zig:313-343).

Past the flatten cap (scene/world.py) the world-space flatten would hold
one row per instanced triangle; this structure keeps one object-space
BLAS per unique (mesh, material, sampled) group and a top level whose
leaves are instances. A ray walks the top level by skip links; at an
instance leaf it moves into object space (d is not renormalised, so t
stays world t), walks that instance's BLAS to its escape (-1) and
resumes the top level at the leaf's escape. Any hit stops at the first
occluder. Hits return the object triangle id and the instance id;
shading transforms the object rows per lane (integrator/path.py
`_inst_world`).

`build_tlas` is the host numpy build, on `lbvh.build`, with the
reference's arrays: each BLAS and the top level padded to a power of two
(unreachable nodes), BLAS links made absolute, hidden instances rooted at
-1 with their box collapsed to their translation, the top level built
over the degenerate triangles (lo, hi, lo) with one instance a leaf.

`device_tlas` also derives the kernel's records from those arrays
(`build_walk`, a `TlasWalk` in the TLAS's `walk` field): 8-wide nodes
collapsed from the binary top level and BLASes, in order, each child a
box and a code in two float4s, and each triangle as v0, e1, e2.
`build_tlas` returns the reference's arrays alone (`walk` None).

`closest_hit_tlas` and `any_hit_tlas` launch the CUDA kernel of
csrc/tlas.cu for CUDA tensors and run the plain versions for CPU
tensors; any other device raises. The plain versions
(`closest_hit_tlas_plain`, `any_hit_tlas_plain`) are the reference's
lockstep walk in torch ops, each iteration over the lanes still walking
(a lane's result does not depend on the others), built from
accel/traverse.py's box and triangle tests. The kernel walks the
records near child first and breaks equal-t ties by (top-level leaf
position, BLAS slot), the order in which the plain walk meets its
leaves, with the same expressions, so both are bit-equal (csrc/tlas.cu's
header gives the argument). With count_visits=True the plain versions
also return what the walk touched (`TlasVisits`), from which the
kernel's least time is bounded; `walk_visits` counts what the kernel's
own walk touches, through a counting build of it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lbvh, native
from .packet import (
    _call_on, _check_rays, _device_kind, _t_max_lanes, count_launch,
)
from .traverse import _aabb_hit, _safe_inv, _tri_intersect

BLAS_LEAF = 4  # triangles a BLAS leaf (the reference's traverse.py bundle)

# Kernel launches, as packet.LAUNCHES: one where a wrapper launches.
LAUNCHES = {"tlas_closest_hit": 0, "tlas_any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TLAS(NamedTuple):
    """The two-level structure's arrays (numpy from `build_tlas`, tensors
    from `device_tlas`: float32 boxes and triangles, int32 links). BLAS
    links are absolute; -1 leaves a BLAS."""

    top_min: object  # [Mt, 3]
    top_max: object  # [Mt, 3]
    top_left: object  # [Mt] child or sorted-leaf position
    top_count: object  # [Mt] 0 internal, 1 leaf
    top_escape: object  # [Mt] -1 = done
    top_inst: object  # [I] leaf position -> instance id
    blas_min: object  # [Mb, 3]
    blas_max: object  # [Mb, 3]
    blas_left: object  # [Mb] absolute node index / sorted triangle offset
    blas_count: object  # [Mb]
    blas_escape: object  # [Mb] -1 = leave the BLAS
    blas_tris: object  # [Ts, 3, 3] object-space corners, BLAS order
    blas_tri_id: object  # [Ts] -> object triangle id (tri_shade row)
    inst_root: object  # [I] BLAS root, -1 for a hidden instance
    inst_inv: object  # [I, 12] world -> object, 3x3 row-major then t
    num_instances: int
    num_obj_tris: int
    walk: object = None  # TlasWalk, from device_tlas


ARRAY_FIELDS = TLAS._fields[:15]  # the reference's arrays


class TlasWalk(NamedTuple):
    """The kernel's records (`build_walk`), derived from a TLAS's arrays.

    nodes: [N, WIDE, 8] float32; child j of node n is (lo xyz, code) and
    (hi xyz, 0), the code's int32 bits in a float: >= 0 a node, -1 an
    empty child (a hidden instance too), -2 - x a leaf, x the top-level
    leaf position or, in a BLAS, slot * 4 + count - 1. Node 0 is the top
    level's root. tris: [Ts, 12] float32, slot s as v0 xyz and its
    triangle id's bits, e1 = v1 - v0 and 0, e2 = v2 - v0 and 0.
    inst_root: [I] int32, each instance's BLAS root node, -1 hidden.
    stack_depth: the most entries the walk's stack holds."""

    nodes: object
    tris: object
    inst_root: object
    stack_depth: int


WIDE = 8  # children a node of the records (csrc/tlas.cu kW)


class TlasHit(NamedTuple):
    """packet.Hit with the instance of each hit (-1 on a miss)."""

    t: torch.Tensor
    tri: torch.Tensor  # object triangle id, -1 on a miss
    u: torch.Tensor
    v: torch.Tensor
    inst: torch.Tensor  # [N] i32

    @property
    def is_hit(self):
        return self.tri >= 0


class WalkVisits(NamedTuple):
    """What the kernel's own walk touched (`walk_visits`): top-level and
    BLAS node visits, the boxes they tested (non-empty children),
    instance entries, leaf visits and the triangles they tested."""

    top: int
    blas: int
    boxes: int
    entries: int
    leaves: int
    tris: int


class TlasVisits(NamedTuple):
    """What one plain walk touched: top-level and BLAS node visits,
    instance entries, leaf visits and the triangles they tested."""

    top: int
    blas: int
    entries: int
    leaves: int
    tris: int


# fp32 operations, counted off the plain expressions (mul, add/sub, div,
# min/max, abs and compares; selects not counted): a box test (either
# level), a triangle test, and an instance entry (the object-space ray
# and its three reciprocals)
FLOPS_PER_BOX = 25
FLOPS_PER_TRI = 60
FLOPS_PER_ENTRY = 42


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _padded(bvh: lbvh.BVH):
    """(min, max, left, count, escape) padded to a power of two as the
    reference's builder pads them: empty boxes, leaves of one triangle at
    offset 0, escape -1; no link reaches them."""
    m = len(bvh.left)
    pad = _next_pow2(m) - m
    mn = np.pad(np.asarray(bvh.aabb_min, np.float32), ((0, pad), (0, 0)),
                constant_values=np.inf)
    mx = np.pad(np.asarray(bvh.aabb_max, np.float32), ((0, pad), (0, 0)),
                constant_values=-np.inf)
    left = np.pad(np.asarray(bvh.left, np.int64), (0, pad))
    count = np.pad(np.asarray(bvh.count, np.int32), (0, pad),
                   constant_values=1)
    esc = np.pad(np.asarray(bvh.escape, np.int64), (0, pad),
                 constant_values=-1)
    return mn, mx, left, count, esc


def build_tlas(meshes, instances) -> tuple[TLAS, dict, dict]:
    """Host build: (TLAS of numpy arrays, obj_info, groups). obj_info holds
    the object-space flatten of one copy of each unique geometry group
    (positions, normals, uvs and the id columns, inst_ids all -1: the
    instance is per hit here), for the shading rows; groups maps a group
    key to its (first object triangle, count)."""
    from ..scene.world import _flatten_object

    keys, key_of_inst = [], []
    for inst in instances:
        k = tuple((g.mesh, g.material, g.sampled) for g in inst.geometries)
        key_of_inst.append(k)
        if k not in keys:
            keys.append(k)

    class _Geo(NamedTuple):
        mesh: int
        material: int
        sampled: bool

    class _Proto(NamedTuple):  # one instance of a group, for the flatten
        geometries: list
        visible: bool = True

    cache = _flatten_object(meshes, [_Proto([_Geo(*g) for g in k])
                                     for k in keys])
    if cache is None:
        raise ValueError("cannot build a TLAS over an empty scene")
    groups = {k: (s, e - s) for k, (s, e) in zip(keys, cache["slices"])}
    obj_info = dict(
        positions=cache["obj_p"], normals=cache["obj_n"], uvs=cache["uvs"],
        mat_ids=cache["mat_ids"], sampled=cache["sampled"],
        inst_ids=np.full(len(cache["obj_p"]), -1, np.int32),
        geo_ids=cache["geo_ids"], prim_ids=cache["prim_ids"])

    cols = {k: [] for k in ("min", "max", "left", "count", "escape", "tris",
                            "tid")}
    group_root, group_box = {}, {}
    node_off = tri_off = 0
    for k in keys:
        s, cnt = groups[k]
        verts = cache["obj_p"][s:s + cnt]
        bvh = lbvh.build(verts, leaf_size=BLAS_LEAF)
        mn, mx, left, count, esc = _padded(bvh)
        leaf = count > 0
        left[leaf] += tri_off
        left[~leaf] += node_off
        esc[esc >= 0] += node_off
        order = np.asarray(bvh.tri_order, np.int64)
        for name, x in (("min", mn), ("max", mx),
                        ("left", left.astype(np.int32)), ("count", count),
                        ("escape", esc.astype(np.int32)),
                        ("tris", verts[order]),
                        ("tid", (order + s).astype(np.int32))):
            cols[name].append(x)
        group_root[k] = node_off
        group_box[k] = (mn[0].copy(), mx[0].copy())
        node_off += len(left)
        tri_off += cnt

    n_inst = len(instances)
    inst_root = np.empty(n_inst, np.int32)
    inst_inv = np.empty((n_inst, 12), np.float32)
    box_lo = np.empty((n_inst, 3), np.float32)
    box_hi = np.empty((n_inst, 3), np.float32)
    for i, inst in enumerate(instances):
        k = key_of_inst[i]
        inst_root[i] = group_root[k]
        m = np.asarray(inst.transform, np.float32)
        lin, trans = m[:, :3], m[:, 3]
        inv_lin = np.linalg.inv(
            lin if abs(np.linalg.det(lin)) > 1e-20
            else lin + np.eye(3, dtype=np.float32) * 1e-6).astype(np.float32)
        inst_inv[i, :9] = inv_lin.reshape(9)
        inst_inv[i, 9:12] = -inv_lin @ trans
        lo, hi = group_box[k]
        corners = np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"),
                           axis=-1).reshape(8, 3)
        wc = corners @ lin.T + trans
        box_lo[i], box_hi[i] = wc.min(0), wc.max(0)
        if not inst.visible:
            # never entered; a point box at the instance's origin
            inst_root[i] = -1
            box_lo[i] = box_hi[i] = trans

    top = lbvh.build(np.stack([box_lo, box_hi, box_lo], axis=1), leaf_size=1)
    t_min, t_max, t_left, t_count, t_esc = _padded(top)
    return TLAS(
        top_min=t_min, top_max=t_max, top_left=t_left.astype(np.int32),
        top_count=t_count, top_escape=t_esc.astype(np.int32),
        top_inst=np.asarray(top.tri_order, np.int32),
        blas_min=np.concatenate(cols["min"]),
        blas_max=np.concatenate(cols["max"]),
        blas_left=np.concatenate(cols["left"]),
        blas_count=np.concatenate(cols["count"]),
        blas_escape=np.concatenate(cols["escape"]),
        blas_tris=np.concatenate(cols["tris"]).astype(np.float32),
        blas_tri_id=np.concatenate(cols["tid"]),
        inst_root=inst_root, inst_inv=inst_inv,
        num_instances=n_inst, num_obj_tris=tri_off,
    ), obj_info, groups


def _wide_children(left, count, escape, ids):
    """[len(ids), WIDE] binary children of wide nodes over binary nodes
    `ids`, in order (-1 empty): an internal node's two children (the
    right one the left one's escape), each internal one of those replaced
    by its two, twice; a leaf node is its own only child."""
    leaf = count[ids] > 0
    c = np.full((len(ids), WIDE), -1, np.int64)
    c[leaf, 0] = ids[leaf]
    lc = left[ids[~leaf]]
    c[~leaf, 0], c[~leaf, 1] = lc, escape[lc]
    rows = np.broadcast_to(np.arange(len(ids))[:, None], c.shape)
    for _ in range(2):  # 2 -> 4 -> 8
        valid = c >= 0
        inner = valid & (count[np.maximum(c, 0)] == 0)
        w = valid.astype(np.int64) + inner
        pos = np.cumsum(w, axis=1) - w
        lc = left[np.maximum(c, 0)]
        out = np.full(c.shape, -1, np.int64)
        out[rows[valid], pos[valid]] = np.where(inner, lc, c)[valid]
        out[rows[inner], pos[inner] + 1] = escape[lc[inner]]
        c = out
    return c


def _collapse(left, count, escape, roots):
    """Wide nodes over the binary trees at `roots`, breadth first: (their
    binary children [K, WIDE], the wide node of each binary node or -1,
    the most stack entries a walk from a root down to a leaf leaves
    behind, its siblings at each node)."""
    wid = np.full(len(left), -1, np.int64)
    kids, base, depth = [], 0, 0
    ids = np.asarray(roots, np.int64)
    acc = np.zeros(len(ids), np.int64)  # entries left at the ancestors
    while len(ids):
        wid[ids] = base + np.arange(len(ids))
        ch = _wide_children(left, count, escape, ids)
        kids.append(ch)
        base += len(ids)
        n_ch = (ch >= 0).sum(1)
        here = acc + n_ch - 1
        depth = max(depth, int(here.max()))
        inner = (ch >= 0) & (count[np.maximum(ch, 0)] == 0)
        ids = ch[inner]
        acc = np.broadcast_to(here[:, None], ch.shape)[inner]
    return np.concatenate(kids), wid, depth


def _records(kids, wid, count, mn, mx, code_of_leaf, offset):
    """[K, WIDE, 8] float32 child records of wide nodes (see TlasWalk)."""
    valid = kids >= 0
    x = np.maximum(kids, 0)
    code = np.where(count[x] == 0, wid[x] + offset, code_of_leaf[x])
    code = np.where(valid, code, -1).astype(np.int32)
    keep = (code != -1)[..., None]
    rec = np.zeros(kids.shape + (8,), np.float32)
    rec[..., 0:3] = np.where(keep, mn[x], 0.0)
    rec[..., 4:7] = np.where(keep, mx[x], 0.0)
    rec[..., 3] = code.view(np.float32)
    return rec


def build_walk(t: TLAS) -> TlasWalk:
    """The kernel's records (TlasWalk) from a TLAS of numpy arrays (the
    reference's, as `build_tlas` or a JAX build gives them). Wide node 0
    is the top level's root, the BLASes' nodes follow."""
    a = {k: np.asarray(getattr(t, k)) for k in ARRAY_FIELDS}
    t_left = a["top_left"].astype(np.int64)
    t_count = a["top_count"].astype(np.int64)
    t_esc = a["top_escape"].astype(np.int64)
    b_left = a["blas_left"].astype(np.int64)
    b_count = a["blas_count"].astype(np.int64)
    b_esc = a["blas_escape"].astype(np.int64)
    if (b_count > BLAS_LEAF).any() or (t_count > 1).any():
        raise ValueError("TLAS leaves hold more than BLAS_LEAF triangles "
                         "or more than one instance")
    inst_root = a["inst_root"].astype(np.int64)
    n_inst = len(inst_root)
    top_kids, top_wid, top_depth = _collapse(t_left, t_count, t_esc, [0])
    # a top-level leaf's code: -2 - its position, or -1 (never entered)
    # for a hidden instance
    pos = np.clip(t_left, 0, n_inst - 1)
    hidden = inst_root[a["top_inst"].astype(np.int64)[pos]] < 0
    top_codes = np.where(hidden, -1, -2 - t_left)
    roots = np.unique(inst_root[inst_root >= 0])
    b_codes = -2 - (b_left * 4 + np.maximum(b_count, 1) - 1)
    nodes = [_records(top_kids, top_wid, t_count, a["top_min"],
                      a["top_max"], top_codes, 0)]
    blas_depth = 0
    w_root = np.full(n_inst, -1, np.int64)
    if len(roots):
        b_kids, b_wid, blas_depth = _collapse(b_left, b_count, b_esc, roots)
        nodes.append(_records(b_kids, b_wid, b_count, a["blas_min"],
                              a["blas_max"], b_codes, len(top_kids)))
        vis = inst_root >= 0
        w_root[vis] = b_wid[inst_root[vis]] + len(top_kids)
    v = a["blas_tris"].astype(np.float32)
    tris = np.zeros((len(v), 12), np.float32)
    tris[:, 0:3] = v[:, 0]
    tris[:, 3] = a["blas_tri_id"].astype(np.int32).view(np.float32)
    tris[:, 4:7] = v[:, 1] - v[:, 0]
    tris[:, 8:11] = v[:, 2] - v[:, 0]
    # the top level's entries, one replaced by the BLAS root, then the
    # BLAS's own
    return TlasWalk(nodes=np.concatenate(nodes), tris=tris,
                    inst_root=w_root.astype(np.int32),
                    stack_depth=top_depth + blas_depth + 1)


def device_tlas(t: TLAS, device) -> TLAS:
    """The TLAS's arrays as contiguous tensors on `device` (float32 boxes,
    triangles and transforms, int32 links), with the kernel's records
    (`build_walk`) in `walk`."""
    def put(x):
        x = np.asarray(x)
        dt = np.float32 if x.dtype.kind == "f" else np.int32
        return torch.tensor(np.ascontiguousarray(x, dt), device=device)

    w = build_walk(t)
    return t._replace(**{name: put(getattr(t, name))
                         for name in ARRAY_FIELDS},
                      num_instances=int(t.num_instances),
                      num_obj_tris=int(t.num_obj_tris),
                      walk=w._replace(nodes=put(w.nodes), tris=put(w.tris),
                                      inst_root=put(w.inst_root)))


# --- plain torch versions ---

def _obj_ray(t: TLAS, inst, ray_o, ray_d):
    """World -> object space: row i of R times o (and d) written out as
    r0 x + r1 y + r2 z, then + t for the origin (the kernel's order)."""
    inv = t.inst_inv[inst]
    oo = torch.stack([inv[:, 3 * i] * ray_o[:, 0]
                      + inv[:, 3 * i + 1] * ray_o[:, 1]
                      + inv[:, 3 * i + 2] * ray_o[:, 2]
                      + inv[:, 9 + i] for i in range(3)], -1)
    dd = torch.stack([inv[:, 3 * i] * ray_d[:, 0]
                      + inv[:, 3 * i + 1] * ray_d[:, 1]
                      + inv[:, 3 * i + 2] * ray_d[:, 2] for i in range(3)],
                     -1)
    return oo, dd


def _check(t: TLAS, ray_o, ray_d, active_in):
    _check_rays(None, ray_o, ray_d, active_in, device=t.top_min.device)


def _walk_plain(t: TLAS, ray_o, ray_d, t_max, active_in, any_hit: bool,
                count_visits: bool):
    n = ray_o.shape[0]
    dev = ray_o.device
    t_lanes = _t_max_lanes(t_max, n, dev)
    inv_dw = _safe_inv(ray_d)
    long = lambda x: x.to(torch.int64)
    top_left, top_count, top_escape = (long(t.top_left), t.top_count,
                                       long(t.top_escape))
    top_inst, inst_root = long(t.top_inst), long(t.inst_root)
    blas_left, blas_count, blas_escape = (long(t.blas_left), t.blas_count,
                                          long(t.blas_escape))
    blas_tri_id = t.blas_tri_id
    n_tris = t.blas_tris.shape[0]

    walking = (torch.ones(n, dtype=torch.bool, device=dev)
               if active_in is None else active_in.clone())
    lanes = torch.nonzero(walking).squeeze(1)
    tcur = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tcur[lanes] = 0
    bcur = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inst = torch.zeros(n, dtype=torch.int64, device=dev)
    oo = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    dd = torch.zeros_like(oo)
    inv_do = torch.zeros_like(oo)
    t_best = t_lanes.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    hinst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    visits = dict(top=0, blas=0, entries=0, leaves=0, tris=0)

    while lanes.numel():
        in_b = bcur[lanes] >= 0
        # top level: lanes outside a BLAS
        ta = lanes[~in_b]
        if ta.numel():
            node = tcur[ta]
            prune = t_lanes[ta] if any_hit else t_best[ta]
            box = _aabb_hit(t.top_min[node], t.top_max[node], ray_o[ta],
                            inv_dw[ta], prune)
            leaf = top_count[node] > 0
            left = top_left[node]
            tcur[ta] = torch.where(box & ~leaf, left, top_escape[node])
            enter = box & leaf
            e = ta[enter]
            if e.numel():
                k = top_inst[left[enter]]
                inst[e] = k
                oo_n, dd_n = _obj_ray(t, k, ray_o[e], ray_d[e])
                oo[e], dd[e], inv_do[e] = oo_n, dd_n, _safe_inv(dd_n)
                bcur[e] = inst_root[k]
            if count_visits:
                visits["top"] += ta.numel()
                visits["entries"] += e.numel()
        # BLAS: lanes inside one (object-space ray)
        ba = lanes[in_b]
        if ba.numel():
            node = bcur[ba]
            tb = t_lanes[ba] if any_hit else t_best[ba]
            bbox = _aabb_hit(t.blas_min[node], t.blas_max[node], oo[ba],
                             inv_do[ba], tb)
            left = blas_left[node]
            cnt = blas_count[node]
            leaf = cnt > 0
            leaf_do = bbox & leaf
            o_b, d_b = oo[ba], dd[ba]
            found = torch.zeros_like(leaf_do)
            if not any_hit:
                bt, bu, bv, bi = tri[ba], u[ba], v[ba], hinst[ba]
                ki = inst[ba].to(torch.int32)
            for j in range(BLAS_LEAF):
                s = torch.clamp(left + j, 0, n_tris - 1)
                tv = t.blas_tris[s]
                h, tt, uu, vv = _tri_intersect(tv[:, 0], tv[:, 1], tv[:, 2],
                                               o_b, d_b, 0.0, tb)
                take = leaf_do & (j < cnt) & h
                if any_hit:
                    found |= take
                else:
                    tb = torch.where(take, tt, tb)
                    bt = torch.where(take, blas_tri_id[s], bt)
                    bu = torch.where(take, uu, bu)
                    bv = torch.where(take, vv, bv)
                    bi = torch.where(take, ki, bi)
            nxt = torch.where(bbox & ~leaf, left, blas_escape[node])
            if any_hit:
                occ[ba] |= found
                bcur[ba] = torch.where(found, -1, nxt)
                tcur[ba] = torch.where(found, -1, tcur[ba])
            else:
                t_best[ba], tri[ba], u[ba], v[ba], hinst[ba] = (tb, bt, bu,
                                                                bv, bi)
                bcur[ba] = nxt
            if count_visits:
                visits["blas"] += ba.numel()
                visits["leaves"] += int(leaf_do.sum())
                visits["tris"] += int(torch.where(
                    leaf_do, torch.clamp(cnt, max=BLAS_LEAF), 0).sum())
        lanes = lanes[(tcur[lanes] >= 0) | (bcur[lanes] >= 0)]

    out = occ if any_hit else TlasHit(t=t_best, tri=tri, u=u, v=v,
                                      inst=hinst)
    return (out, TlasVisits(**visits)) if count_visits else out


def closest_hit_tlas_plain(t: TLAS, ray_o, ray_d, t_max, active_in=None,
                           count_visits: bool = False):
    """Plain torch closest hit through both levels (the kernel's
    reference): a TlasHit (t = t_max, tri = inst = -1, u = v = 0 for a
    dead or missed lane), or (TlasHit, TlasVisits) with count_visits."""
    _check(t, ray_o, ray_d, active_in)
    return _walk_plain(t, ray_o, ray_d, t_max, active_in, False,
                       count_visits)


def any_hit_tlas_plain(t: TLAS, ray_o, ray_d, t_max, active_in=None,
                       count_visits: bool = False):
    """Plain torch occlusion in (0, t_max) through both levels: bool [N],
    or (bool [N], TlasVisits) with count_visits."""
    _check(t, ray_o, ray_d, active_in)
    return _walk_plain(t, ray_o, ray_d, t_max, active_in, True,
                       count_visits)


# --- CUDA wrappers ---

def _aligned(name, x, dtype):
    if (x.dtype != dtype or not x.is_contiguous()
            or x.data_ptr() % 16 != 0):
        raise ValueError(f"TLAS {name} must be contiguous {dtype}, 16-byte "
                         "aligned")
    return x


def _launch(t: TLAS, ray_o, ray_d, t_max, active_in, any_hit: bool,
            lib=None, counts=None):
    """One launch of csrc/tlas.cu's kernel; LAUNCHES adds one where it
    launches. lib: another build of it (the counting one, with its int64
    [6] `counts`, for `walk_visits`; another checkout's, for
    scripts/compare_tlas.py), whose launches LAUNCHES does not count."""
    w = t.walk
    if w is None:
        raise ValueError("the TLAS has no kernel records: make it with "
                         "device_tlas")
    own = lib is None
    lib = lib or native.tlas_lib()
    n, dev = ray_o.shape[0], ray_o.device
    if n >= 2**31:
        raise ValueError("too many rays for one launch")
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    t_lanes = _t_max_lanes(t_max, n, dev)
    act = None if active_in is None else active_in.contiguous()
    for name, x in (("top_inst", t.top_inst), ("walk.inst_root",
                                                w.inst_root)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"TLAS {name} must be contiguous int32")
    args = [_aligned("walk.nodes", w.nodes, torch.float32).data_ptr(),
            _aligned("walk.tris", w.tris, torch.float32).data_ptr(),
            _aligned("inst_inv", t.inst_inv, torch.float32).data_ptr(),
            t.top_inst.data_ptr(), w.inst_root.data_ptr(),
            t.num_instances, w.tris.shape[0],
            None if counts is None else counts.data_ptr(),
            ray_o.data_ptr(), ray_d.data_ptr(), t_lanes.data_ptr(),
            None if act is None else act.data_ptr(), n, w.stack_depth]
    if any_hit:
        out = (torch.empty(n, dtype=torch.bool, device=dev),)
        fn, key = lib.any_hit, "tlas_any_hit"
    else:
        tt = torch.empty(n, dtype=torch.float32, device=dev)
        out = (tt, torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty_like(tt), torch.empty_like(tt),
               torch.empty(n, dtype=torch.int32, device=dev))
        fn, key = lib.closest_hit, "tlas_closest_hit"
    if n:
        next_ray = torch.empty(1, dtype=torch.int32, device=dev)
        rc = _call_on(fn, dev, *args, next_ray.data_ptr(),
                      *(x.data_ptr() for x in out))
        if rc != 0:
            raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
        if own:
            count_launch(LAUNCHES, key)
    return out[0] if any_hit else TlasHit(*out)


def walk_visits(t: TLAS, ray_o, ray_d, t_max, active_in=None,
                any_hit: bool = False) -> WalkVisits:
    """What the kernel's walk visits on these CUDA rays, counted by the
    counting build of csrc/tlas.cu (never the timed one; LAUNCHES does
    not count it). The outputs equal the kernel's and are dropped."""
    _check(t, ray_o, ray_d, active_in)
    if _device_kind(ray_o) != "cuda":
        raise ValueError("walk_visits counts the CUDA kernel's walk")
    counts = torch.zeros(len(WalkVisits._fields), dtype=torch.int64,
                         device=ray_o.device)
    _launch(t, ray_o, ray_d, t_max, active_in, any_hit,
            lib=native.tlas_count_lib(), counts=counts)
    return WalkVisits(*(int(x) for x in counts.tolist()))


def closest_hit_tlas(t: TLAS, ray_o, ray_d, t_max, active_in=None
                     ) -> TlasHit:
    """Closest hit through both levels: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(t, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return closest_hit_tlas_plain(t, ray_o, ray_d, t_max, active_in)
    return _launch(t, ray_o, ray_d, t_max, active_in, False)


def any_hit_tlas(t: TLAS, ray_o, ray_d, t_max, active_in=None
                 ) -> torch.Tensor:
    """Occlusion in (0, t_max) through both levels, stopping at the first
    occluder: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(t, ray_o, ray_d, active_in)
    if _device_kind(ray_o) == "cpu":
        return any_hit_tlas_plain(t, ray_o, ray_d, t_max, active_in)
    return _launch(t, ray_o, ray_d, t_max, active_in, True)
