"""The reference's scene, worked out again from the benchmark's plain
description (portbench/scenes): the world-space triangles (the instance
flatten of moonshine_tpu_torch/scene/world.py `_flatten_object` and
`_world_flat` restated), each material's constants as the frontend hands
them to the program, the sky's equal-area map (sky.py, on the device)
and its alias table (envmap.py, a frozen copy), the emitters' alias
table over the sampled triangles' areas, and, for the closest and any
hits, clusters of triangles in Morton order with their boxes (no BVH of
the program's).
Nothing here reads what the program built."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import alias_table, sky
from .envmap import EnvMap, envmap_from_arrays

GLASS, LAMBERT, MIRROR, STANDARD_PBR = 0, 1, 2, 3
CLUSTER = 64  # triangles a cluster


class Scene(NamedTuple):
    v0: torch.Tensor  # [T, 3] corner 0 (world)
    e1: torch.Tensor  # [T, 3] corner 1 - corner 0
    e2: torch.Tensor  # [T, 3] corner 2 - corner 0
    corners: torch.Tensor  # [T, 3, 3]
    normals: torch.Tensor  # [T, 3, 3]
    uvs: torch.Tensor  # [T, 3, 2]
    mat: torch.Tensor  # [T] material of each triangle
    sampled: torch.Tensor  # [T] bool: an NEE emitter
    mat_type: torch.Tensor  # [M] int32
    color: torch.Tensor  # [M, 3]
    metalness: torch.Tensor  # [M]
    roughness: torch.Tensor  # [M]
    ior: torch.Tensor  # [M]
    emissive: torch.Tensor  # [M, 3]
    env: EnvMap
    em_select: torch.Tensor  # [E]
    em_alias: torch.Tensor  # [E] int64
    em_corners: torch.Tensor  # [E, 9]
    em_emissive: torch.Tensor  # [E, 3]
    em_count: int
    em_weight_sum: float
    box_lo: torch.Tensor  # [K, 3] each cluster's box
    box_hi: torch.Tensor  # [K, 3]
    cluster_tris: torch.Tensor  # [K, CLUSTER] triangle ids, -1 padding

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])


def material_constants(mat: dict, as_engine: bool) -> tuple:
    """(type, color, metalness, roughness, ior, emissive) of a material
    as the program holds it: the kinds the glTF loader gives back, or
    (as_engine) the Engine's StandardPBR of each (a Lambert as metalness
    0 and roughness 1, a mirror as metalness 1 and roughness 0, glass as
    a white dielectric)."""
    kind = mat["kind"]
    color = tuple(mat["color"])
    if as_engine:
        color, metal, rough, ior = {
            "lambert": (color, 0.0, 1.0, 1.5),
            "mirror": ((1.0, 1.0, 1.0), 1.0, 0.0, 1.5),
            "glass": ((1.0, 1.0, 1.0), 0.0, 0.0, mat["ior"]),
            "pbr": (color, mat["metalness"], mat["roughness"], mat["ior"]),
        }[kind]
        return STANDARD_PBR, color, metal, rough, ior, mat["emissive"]
    white = (1.0, 1.0, 1.0)
    return {
        "pbr": (STANDARD_PBR, color, mat["metalness"], mat["roughness"],
                mat["ior"]),
        "lambert": (LAMBERT, color, 0.0, 1.0, 1.5),
        "mirror": (MIRROR, white, 0.0, 1.0, 1.5),
        "glass": (GLASS, white, 0.0, 1.0, mat["ior"]),
    }[kind] + (mat["emissive"],)


def flatten(desc: dict) -> dict:
    """World-space corners, normals (the geometric normal where a mesh
    has none), uvs ((0,0),(1,0),(1,1) where absent), material and
    sampled flag of every triangle of every instance, in instance
    order; normals by the inverse transpose, corners 1 and 2 swapped
    under a mirroring transform."""
    cols = {k: [] for k in ("p", "n", "uv", "mat", "sampled")}
    for inst in desc["instances"]:
        mesh = desc["meshes"][inst["mesh"]]
        idx = np.asarray(mesh["indices"], np.int64).reshape(-1, 3)
        F = len(idx)
        p = np.asarray(mesh["positions"], np.float32)[idx]
        if mesh["normals"] is not None:
            nrm = np.asarray(mesh["normals"], np.float32)[idx]
        else:
            gn = np.cross(p[:, 0] - p[:, 2], p[:, 1] - p[:, 2])
            gl = np.linalg.norm(gn, axis=-1, keepdims=True)
            nrm = np.repeat((gn / np.maximum(gl, 1e-20))[:, None, :], 3,
                            axis=1)
        if mesh["texcoords"] is not None:
            uv = np.asarray(mesh["texcoords"], np.float32)[idx]
        else:
            uv = np.broadcast_to(
                np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                (F, 3, 2)).copy()
        M = np.asarray(inst["transform"], np.float32)
        lin, trans = M[:, :3], M[:, 3]
        det = float(np.linalg.det(lin))
        nrm_m = np.linalg.inv(lin).T if abs(det) > 1e-20 else lin
        pw = p.astype(np.float32) @ lin.T + trans
        nw = nrm.astype(np.float32) @ nrm_m.T
        nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True),
                             1e-20)
        if det < 0.0:
            pw, nw, uv = pw[:, [0, 2, 1]], nw[:, [0, 2, 1]], uv[:, [0, 2, 1]]
        cols["p"].append(pw.astype(np.float32))
        cols["n"].append(nw.astype(np.float32))
        cols["uv"].append(uv.astype(np.float32))
        cols["mat"].append(np.full(F, inst["material"], np.int64))
        cols["sampled"].append(np.full(F, inst["sampled"], bool))
    return {k: np.concatenate(v) for k, v in cols.items()}


def _morton_clusters(verts: np.ndarray, pad: float):
    """Triangle ids in Morton order of their centroids, CLUSTER a
    cluster ([K, CLUSTER], -1 padding), and each cluster's box grown by
    `pad`."""
    cen = verts.mean(axis=1)
    lo, hi = cen.min(0), cen.max(0)
    q = ((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(cen), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    order = np.argsort(code, kind="stable")
    K = -(-len(order) // CLUSTER)
    tris = np.full(K * CLUSTER, -1, np.int64)
    tris[:len(order)] = order
    tris = tris.reshape(K, CLUSTER)
    pts = verts[np.maximum(tris, 0)]  # [K, C, 3, 3]
    box_lo = pts.min(axis=(1, 2)) - pad
    box_hi = pts.max(axis=(1, 2)) + pad
    return tris, box_lo.astype(np.float32), box_hi.astype(np.float32)


def build(desc: dict, as_engine: bool, device) -> Scene:
    """The reference's scene of `desc` on `device` (as_engine: the
    materials as the Engine holds them)."""
    flat = flatten(desc)
    verts = flat["p"]
    consts = [material_constants(m, as_engine) for m in desc["materials"]]
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    extent = float(np.max(verts.max(axis=(0, 1)) - verts.min(axis=(0, 1))))
    tris, box_lo, box_hi = _morton_clusters(verts, 1e-5 * extent + 1e-6)

    # the emitters: an alias table over the sampled triangles' areas
    em_tris = np.nonzero(flat["sampled"])[0]
    if len(em_tris):
        tv = verts[em_tris]
        areas = 0.5 * np.linalg.norm(
            np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1)
        table = alias_table.build(areas)
        em_count = int(table.count) if table.weight_sum > 0.0 else 0
        em_weight = float(np.float32(table.weight_sum))
        em_select, em_alias = table.select, table.alias.astype(np.int64)
        em_corners = tv.reshape(-1, 9)
        em_emissive = np.float32([consts[m][5] for m in flat["mat"][em_tris]])
    else:
        em_count, em_weight = 0, 0.0
        em_select, em_alias = np.ones(1, np.float32), np.zeros(1, np.int64)
        em_corners = np.zeros((1, 9), np.float32)
        em_emissive = np.zeros((1, 3), np.float32)

    env = envmap_from_arrays(
        sky.build(np.asarray(desc["sky"], np.float32)[..., :3], device),
        device)
    return Scene(
        v0=f32(verts[:, 0]), e1=f32(verts[:, 1] - verts[:, 0]),
        e2=f32(verts[:, 2] - verts[:, 0]), corners=f32(verts),
        normals=f32(flat["n"]), uvs=f32(flat["uv"]),
        mat=torch.tensor(flat["mat"], device=device),
        sampled=torch.tensor(flat["sampled"], device=device),
        mat_type=torch.tensor([c[0] for c in consts], dtype=torch.int32,
                              device=device),
        color=f32([c[1] for c in consts]),
        metalness=f32([c[2] for c in consts]),
        roughness=f32([c[3] for c in consts]),
        ior=f32([c[4] for c in consts]),
        emissive=f32([c[5] for c in consts]),
        env=env,
        em_select=f32(em_select),
        em_alias=torch.tensor(em_alias, device=device),
        em_corners=f32(em_corners), em_emissive=f32(em_emissive),
        em_count=em_count, em_weight_sum=em_weight,
        box_lo=f32(box_lo), box_hi=f32(box_hi),
        cluster_tris=torch.tensor(tris, device=device),
    )
