"""Format-V traversal: the wide BVH as (8, 128) tiles (port of the surface
of moonshine_tpu/accel/vpacket.py).

Format V stores every wide-BVH record as one (8, 128) float32 tile, laid
out for the TPU's vector unit (w = width, S = leaf slots):

  node tile:  sublane s, column 6g + c   = bound c (lox loy loz hix hiy
              hiz) of child j = 8g + s;
              sublane 0, column 64 + j   = child-j pointer (>= 0 node,
              -1 empty, <= -2 leaf), column 63 = the sort axis.
  leaf tile:  sublane s, column 10g + f  = field f (v0 xyz, e1 xyz, e2
              xyz, tid) of slot j = 8g + s; empty slots: zeros, tid -1.

It is the same tree as the rows it comes from (`tiles_from_rows`, bit
equal to the reference's), so traversal returns the same hits as
packet.py's. `closest_hit_vpacket` / `any_hit_vpacket` launch the CUDA
kernels of csrc/vpacket.cu for CUDA tensors and run the plain torch
versions (`closest_hit_plain`, `any_hit_plain`) for CPU tensors; any
other device raises, and a kernel that does not build or launch raises.
The `_hbm` names sort the rays by coherence first (`sort=True`, their
default) through packet._sorted. The contract is packet.py's.

The kernels walk the tree as the packet kernels do (csrc/group_walk.cuh):
a group of lanes traces one ray, and lane k of a group of G owns
sublanes k, k + G, ... of every tile, so it reads its children's bounds
and its slots' fields as contiguous runs; each group's stack lives in
shared memory (`kernel_layout`), and persistent warps take rays 32 at a
time from a counter.

The plain versions read the tiles at the addresses above, in
packet._walk's order and expressions (the packet slab form, `b * inv -
oinv` and `max(tnear, 0) <= min(tfar, prune)`). Empty child slots, and
the width padding of the last sublane group, are skipped by their
pointer (-1), as packet.py skips them. The reference instead relies on
the empty slots' inverted boxes (lo = +BIG, hi = -BIG), which its slab
test does enter, so it visits leaf 0 once for every empty slot of a
visited node; the port does not, which changes no result but the
winner of an exact-t tie.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import native, packet
from .packet import Hit, _check_rays, _device_kind, _t_max_lanes
from .wide import WideBVH

_BIG = 3.0e38
AXIS_LANE = 63
PTR_LANE0 = 64

LAUNCHES = {"v_closest_hit": 0, "v_any_hit": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class VWide(NamedTuple):
    """Tiled wide BVH (format V): the source WideBVH's tree, topology,
    child order and slot packing, re-laid-out as tiles."""

    nodes: torch.Tensor  # [M, 8, 128] f32
    leaves: torch.Tensor  # [L, 8, 128] f32
    bounds: torch.Tensor  # [2, 3] f32 scene AABB (ray-sort keys)
    max_depth: int
    width: int
    leaf_slots: int
    num_nodes: int
    num_leaves: int
    num_tris: int

    @property
    def max_stack(self) -> int:
        return (self.width - 1) * self.max_depth + 1


def tiles_from_rows(nodes_rows: np.ndarray, leaves_rows: np.ndarray,
                    width: int, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Relayout row-format records (wide.assemble_rows) into V tiles.
    Pure numpy, bit-equal to the reference's."""
    assert width <= 64, width
    assert cap <= 96, cap
    nodes_rows = nodes_rows.reshape(len(nodes_rows), -1)
    leaves_rows = leaves_rows.reshape(len(leaves_rows), -1)
    M, L = len(nodes_rows), len(leaves_rows)
    w = width
    G = -(-w // 8)
    GL = -(-cap // 8)

    # a width or cap that is not a multiple of 8 leaves the last group's
    # tail slots empty: inverted bounds and pointer -1 / tid -1, zero edges
    nt = np.zeros((M, 8, 128), np.float32)
    ptr = nodes_rows[:, 6 * w:7 * w]
    empty = ptr == -1.0
    for c in range(6):
        comp = np.full((M, 8 * G), _BIG if c < 3 else -_BIG, np.float32)
        comp[:, :w] = nodes_rows[:, c * w:(c + 1) * w]
        comp[:, :w][empty] = _BIG if c < 3 else -_BIG
        for g in range(G):
            nt[:, :, 6 * g + c] = comp[:, 8 * g:8 * g + 8]
    nt[:, 0, PTR_LANE0:PTR_LANE0 + w] = ptr
    nt[:, 0, PTR_LANE0 + w:PTR_LANE0 + 8 * G] = -1.0
    nt[:, 0, AXIS_LANE] = nodes_rows[:, 7 * w]

    lt = np.zeros((L, 8, 128), np.float32)
    for f in range(10):
        comp = np.full((L, 8 * GL), -1.0 if f == 9 else 0.0, np.float32)
        comp[:, :cap] = leaves_rows[:, f * cap:(f + 1) * cap]
        for g in range(GL):
            lt[:, :, 10 * g + f] = comp[:, 8 * g:8 * g + 8]
    return nt, lt


def v_from_wide(wbvh: WideBVH) -> VWide:
    """The V tiling of a built WideBVH, on the tree's device (a host numpy
    pass)."""
    nt, lt = tiles_from_rows(wbvh.nodes.cpu().numpy(),
                             wbvh.leaves.cpu().numpy(), wbvh.width,
                             wbvh.leaf_slots)
    dev = wbvh.nodes.device
    return VWide(
        nodes=torch.from_numpy(nt).to(dev),
        leaves=torch.from_numpy(lt).to(dev),
        bounds=wbvh.bounds, max_depth=wbvh.max_depth, width=wbvh.width,
        leaf_slots=wbvh.leaf_slots, num_nodes=wbvh.num_nodes,
        num_leaves=wbvh.num_leaves, num_tris=wbvh.num_tris,
    )


def tile_bytes(vbvh: VWide) -> int:
    return sum(x.numel() * x.element_size()
               for x in (vbvh.nodes, vbvh.leaves))


def fits_vmem(vbvh: VWide) -> bool:
    return tile_bytes(vbvh) <= packet.VMEM_SCENE_BUDGET_BYTES


def stack_ok(vbvh: VWide, hbm: bool) -> bool:
    return vbvh.max_stack <= (packet.HBM_STACK_DEPTH if hbm
                              else packet.STACK_DEPTH)


def used_floats(vbvh: VWide) -> tuple[int, int]:
    """Floats a traversal reads from one node tile and one leaf tile: the
    bound columns of every sublane, the axis and the pointers; the field
    columns of every sublane."""
    G = -(-vbvh.width // 8)
    GL = -(-vbvh.leaf_slots // 8)
    return 8 * 6 * G + 1 + vbvh.width, 8 * 10 * GL


# --- plain torch versions ---

def _tile_node_fields(vbvh: VWide, ids):
    """packet._row_node_fields from the tiles: child j = 8g + s reads its
    bounds at tile[s, 6g + c], its pointer at tile[0, 64 + j] and the
    node's axis at tile[0, 63]."""
    w = vbvh.width
    G = -(-w // 8)
    n = ids.shape[0]
    b = vbvh.nodes[ids, :, :6 * G]  # [n, 8 sublanes, 6G]
    b = b.reshape(n, 8, G, 6).permute(0, 2, 1, 3).reshape(n, 8 * G, 6)[:, :w]
    head = vbvh.nodes[ids, 0, AXIS_LANE:PTR_LANE0 + w]
    return ([b[:, :, c] for c in range(3)], [b[:, :, 3 + c] for c in range(3)],
            head[:, 1:], head[:, 0])


def _tile_leaf_fields(vbvh: VWide, ids):
    """packet._row_leaf_fields from the tiles: field f of slot j = 8g + s
    at tile[s, 10g + f]."""
    S = vbvh.leaf_slots
    GL = -(-S // 8)
    n = ids.shape[0]
    t = vbvh.leaves[ids, :, :10 * GL]  # [n, 8 sublanes, 10 GL]
    t = t.reshape(n, 8, GL, 10).permute(0, 2, 1, 3).reshape(n, 8 * GL, 10)
    return t[:, :S].transpose(1, 2)


def _plain(vbvh: VWide, ray_o, ray_d, t_max, active_in, any_hit: bool,
           count_visits: bool):
    _check_rays(vbvh, ray_o, ray_d, active_in)
    t_caller = _t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
    return packet._traverse_plain(
        vbvh, ray_o, ray_d, t_caller, active_in, any_hit, count_visits,
        node_fields=_tile_node_fields, leaf_fields=_tile_leaf_fields)


def closest_hit_plain(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                      count_visits: bool = False):
    """Plain torch closest hit over the tiles (the CUDA kernel's
    reference). Returns a Hit, or (Hit, packet.Visits) with
    count_visits."""
    return _plain(vbvh, ray_o, ray_d, t_max, active_in, False, count_visits)


def any_hit_plain(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                  count_visits: bool = False):
    """Plain torch any hit over the tiles. Returns bool [N], or (bool [N],
    packet.Visits) with count_visits."""
    return _plain(vbvh, ray_o, ray_d, t_max, active_in, True, count_visits)


# --- CUDA wrappers ---

def kernel_layout(vbvh: VWide) -> packet.KernelLayout:
    """The shared-memory layout the kernel gets for this tree: no top
    tiles, and packet.GROUPS_PER_BLOCK stacks of max_stack entries (plain
    Python: only the tree's static facts are read)."""
    return packet.KernelLayout(
        0, vbvh.max_stack, packet.GROUPS_PER_BLOCK * vbvh.max_stack * 4)


def _launch(vbvh: VWide, ray_o, ray_d, t_max, active_in, any_hit: bool):
    for name, x in (("nodes", vbvh.nodes), ("leaves", vbvh.leaves)):
        if tuple(x.shape[1:]) != (8, 128):
            raise ValueError(f"{name} must be [n, 8, 128] tiles")
    key = "v_any_hit" if any_hit else "v_closest_hit"
    return packet._launch(native.vpacket_lib(), LAUNCHES, key, vbvh, ray_o,
                          ray_d, t_max, active_in, any_hit,
                          layout_of=kernel_layout)


def closest_hit_vpacket(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                        sort: bool = False) -> Hit:
    """Closest hit per ray over the tiles: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; sort=True traces
    coherence-sorted rays and restores lane order."""
    _check_rays(vbvh, ray_o, ray_d, active_in)
    if sort:
        return packet._sorted(closest_hit_vpacket, vbvh, ray_o, ray_d, t_max,
                              active_in)
    if _device_kind(ray_o) == "cpu":
        return closest_hit_plain(vbvh, ray_o, ray_d, t_max, active_in)
    return _launch(vbvh, ray_o, ray_d, t_max, active_in, False)


def any_hit_vpacket(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                    sort: bool = False) -> torch.Tensor:
    """Occlusion in (0, t_max) per ray as bool, over the tiles."""
    _check_rays(vbvh, ray_o, ray_d, active_in)
    if sort:
        return packet._sorted(any_hit_vpacket, vbvh, ray_o, ray_d, t_max,
                              active_in)
    if _device_kind(ray_o) == "cpu":
        return any_hit_plain(vbvh, ray_o, ray_d, t_max, active_in)
    return _launch(vbvh, ray_o, ray_d, t_max, active_in, True)


def closest_hit_vpacket_hbm(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                            sort: bool = True) -> Hit:
    """The reference's HBM-streaming name: the same kernel, on
    coherence-sorted rays unless sort=False."""
    return closest_hit_vpacket(vbvh, ray_o, ray_d, t_max, active_in, sort)


def any_hit_vpacket_hbm(vbvh: VWide, ray_o, ray_d, t_max, active_in=None,
                        sort: bool = True) -> torch.Tensor:
    return any_hit_vpacket(vbvh, ray_o, ray_d, t_max, active_in, sort)
