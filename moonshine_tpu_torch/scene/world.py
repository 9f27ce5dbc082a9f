"""World: host scene state -> flat device scene (port of the full-build
path of moonshine_tpu/scene/world.py).

Every instance of every triangle becomes one world-space record, so a hit
decodes with direct indexing: per-triangle corner positions (instance
transform), normals (inverse transpose; the geometric normal when a mesh
has none), texcoords ((0,0),(1,0),(1,1) when absent), with corners 1/2
swapped under mirroring transforms. The host build is numpy; it ends in
one dict of arrays plus a dict of static facts, which `scene_from_arrays`
puts on the device. The JAX package's built scene, flattened into the
same two dicts, goes through the same function, so both packages can
traverse byte-identical rows.

The binary tree is Karras below 50k triangles and binned SAH above (the
reference's rule); `MSN_WIDE` and `MSN_LEAF_CAP` override the wide layout
as in the reference. Not ported yet: refits and material/background
edits (every build() is a full build), spatial-split presplitting
(`MSN_PRESPLIT`, off by default in the reference), and two-level
instancing (a scene that would need it raises).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..accel import lbvh, wide as wide_bvh
from ..core import alias_table
from ..lights.envmap import (
    EnvMap, build_envmap, constant_envmap, envmap_from_arrays,
)
from .textures import MaterialAtlas, MaterialBlockBuilder, plane_from_rows
from .types import (
    Glass, Instance, Lambert, MaterialInfo, Mesh, Mirror, StandardPBR,
)

# material type codes (world.hlsl:31-36 enum order)
TYPE_GLASS, TYPE_LAMBERT, TYPE_MIRROR, TYPE_PBR = 0, 1, 2, 3

# past this many flattened triangles the reference switches to two-level
# instancing, which the port does not have yet
MAX_FLAT_TRIS = 16_000_000
# builder="auto" picks binned SAH above this many triangles, Karras below
SAH_MIN_TRIS = 50_000


class MaterialTable(NamedTuple):
    """One packed row per material (layout: moonshine_tpu/scene/world.py
    MaterialTable): 0 type | 5 ior | 1-4 BSDF rect or color+metalness |
    6 roughness, 10-11 normal rg | 7-9 emissive | 12-15 emissive rect."""

    packed: torch.Tensor  # [M, 16] f32


class EmitterTable(NamedTuple):
    """Alias table over world-space areas of sampled triangles; `rows`
    packs what NEE reads per drawn emitter: 0:9 corners | 9:15 uvs |
    15:18 emissive | 18:22 emissive rect | 22 original tri id."""

    select: torch.Tensor  # [E] f32
    alias: torch.Tensor  # [E] i64
    tri: torch.Tensor  # [E] i64
    rows: torch.Tensor  # [E, 25] f32
    count: int  # 0 when no emitter has area
    weight_sum: float  # total emissive area (float32 value)


class DeviceScene(NamedTuple):
    wide: wide_bvh.WideBVH
    # one packed row per triangle: 0-8 corners, 9-17 normals, 18-23 uvs,
    # 24 material id, 25 sampled, 26 instance, 27 geometry, 28 primitive,
    # 32-47 the triangle's MaterialTable row
    tri_shade: torch.Tensor  # [T, 48] f32
    materials: MaterialTable
    mat_atlas: MaterialAtlas
    env: EnvMap
    emitters: EmitterTable
    # the scene holds a mirror or glass material
    has_delta: bool
    # the binary tree and its triangles in traversal (tri_order) order, for
    # the per-lane fallback walk (accel/traverse.py); None when the arrays
    # a scene came from did not carry them
    bvh: lbvh.BVH | None = None
    tri_verts_sorted: torch.Tensor | None = None  # [T, 3, 3] f32

    @property
    def num_tris(self) -> int:
        return int(self.tri_shade.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_shade.device


def scene_from_arrays(arrays: dict, statics: dict, device) -> DeviceScene:
    """DeviceScene on `device` from host arrays and static facts.

    arrays (numpy): wide.{nodes,leaves,bounds,t_roots,t_lo,t_hi}, tri_shade,
    materials.packed, mat_atlas.{bsdf,emissive}.data (float32 values of
    the bf16 planes), env.{rgbl,select,alias}, emitters.{select,alias,
    tri,rows}. statics: wide.{max_depth,width,leaf_slots},
    mat_atlas.{bsdf,emissive}.{width,chunks},
    mat_atlas.{bsdf_constant,emissive_constant,normals_flat},
    env.integral, emitters.{count,weight_sum}, has_delta. Optional arrays:
    bvh.{aabb_min,aabb_max,left,count,escape,tri_order} (and bvh.parent)
    with tri_verts_sorted, the binary tree of the fallback walk."""
    a, s = arrays, statics
    put = lambda x, dt=np.float32: torch.tensor(np.asarray(x, dt),
                                                 device=device)
    tri_shade = put(a["tri_shade"])
    wide = wide_bvh.wide_from_rows(
        a["wide.nodes"], a["wide.leaves"], a["wide.bounds"],
        s["wide.max_depth"], s["wide.width"], s["wide.leaf_slots"],
        len(tri_shade), device, a["wide.t_roots"], a["wide.t_lo"],
        a["wide.t_hi"])
    planes = {
        k: plane_from_rows(a[f"mat_atlas.{k}.data"], s[f"mat_atlas.{k}.width"],
                           s[f"mat_atlas.{k}.chunks"], device)
        for k in ("bsdf", "emissive")
    }
    atlas = MaterialAtlas(
        bsdf=planes["bsdf"], emissive=planes["emissive"],
        bsdf_constant=bool(s["mat_atlas.bsdf_constant"]),
        emissive_constant=bool(s["mat_atlas.emissive_constant"]),
        normals_flat=bool(s["mat_atlas.normals_flat"]),
    )
    env = envmap_from_arrays(
        {k: a[f"env.{k}"] for k in ("rgbl", "select", "alias")}
        | {"integral": s["env.integral"]}, device)
    emitters = EmitterTable(
        select=put(a["emitters.select"]),
        alias=put(a["emitters.alias"], np.int64),
        tri=put(a["emitters.tri"], np.int64),
        rows=put(a["emitters.rows"]),
        count=int(s["emitters.count"]),
        weight_sum=float(s["emitters.weight_sum"]),
    )
    bvh = tri_sorted = None
    if "bvh.aabb_min" in a:
        bvh = lbvh.device_bvh(lbvh.BVH(
            aabb_min=a["bvh.aabb_min"], aabb_max=a["bvh.aabb_max"],
            left=a["bvh.left"], count=a["bvh.count"],
            escape=a["bvh.escape"], tri_order=a["bvh.tri_order"],
            num_nodes=len(a["bvh.left"]), num_tris=len(a["bvh.tri_order"]),
            parent=a.get("bvh.parent")), device)
        tri_sorted = put(a["tri_verts_sorted"])
    return DeviceScene(
        wide=wide, tri_shade=tri_shade,
        materials=MaterialTable(packed=put(a["materials.packed"])),
        mat_atlas=atlas, env=env, emitters=emitters,
        has_delta=bool(s["has_delta"]), bvh=bvh, tri_verts_sorted=tri_sorted,
    )


class World:
    """Mutable host scene; `build(device)` freezes it into a DeviceScene."""

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[MaterialInfo] = []
        self.instances: list[Instance] = []
        self._backgrounds: list = []  # (equirect | None, size) per handle
        self._active_background: int | None = None

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, info: MaterialInfo) -> int:
        self.materials.append(info)
        return len(self.materials) - 1

    def add_instance(self, instance: Instance) -> int:
        self.instances.append(instance)
        return len(self.instances) - 1

    def add_background(self, equirect_rgb: np.ndarray | None,
                       size: int | None = None) -> int:
        """Register an environment map; None = 1x1 white."""
        self._backgrounds.append((equirect_rgb, size))
        return len(self._backgrounds) - 1

    def use_background(self, handle: int):
        if not 0 <= handle < len(self._backgrounds):
            raise IndexError(f"no background {handle}")
        self._active_background = handle

    def set_background(self, equirect_rgb: np.ndarray | None,
                       size: int | None = None):
        """Register and select in one call."""
        self.use_background(self.add_background(equirect_rgb, size))

    def build(self, device="cuda", builder: str = "auto") -> DeviceScene:
        """Full build onto `device`. builder: "karras", "sah", or "auto"
        (SAH above SAH_MIN_TRIS triangles, Karras below)."""
        return scene_from_arrays(*self.build_arrays(builder), device)

    def build_arrays(self, builder: str = "auto") -> tuple[dict, dict]:
        """Host half of build(): (arrays, statics) for scene_from_arrays."""
        if builder not in ("auto", "karras", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        flat_tris = sum(len(self.meshes[g.mesh].indices)
                        for inst in self.instances for g in inst.geometries)
        if flat_tris > MAX_FLAT_TRIS:
            raise NotImplementedError(
                f"scene flattens to {flat_tris:,} triangles (cap "
                f"{MAX_FLAT_TRIS:,}); two-level instancing is not ported")

        packed, planes = _build_materials(self.materials,
                                          MaterialBlockBuilder())

        flat = _flatten(self.meshes, self.instances)
        if flat is None:
            # empty scene: one degenerate triangle that is never hit
            normals = np.zeros((1, 3, 3), np.float32)
            normals[:, :, 2] = 1.0
            flat = dict(verts=np.zeros((1, 3, 3), np.float32),
                        normals=normals, uvs=np.zeros((1, 3, 2), np.float32),
                        mat_ids=np.zeros(1, np.int32),
                        sampled=np.zeros(1, bool),
                        inst_ids=np.full(1, -1, np.int32),
                        geo_ids=np.zeros(1, np.int32),
                        prim_ids=np.zeros(1, np.int32))
        verts = flat["verts"]
        T = len(verts)
        if builder == "auto":
            builder = "sah" if T > SAH_MIN_TRIS else "karras"
        bvh = lbvh.build_sah(verts) if builder == "sah" else lbvh.build(verts)
        width, leaf_cap = _wide_layout(T)
        rows = wide_bvh.build_wide_rows(verts, binary=bvh, leaf_cap=leaf_cap,
                                        width=width)

        emitter_tris = np.nonzero(flat["sampled"])[0]
        em = _build_emitters(verts, emitter_tris, flat["uvs"],
                             flat["mat_ids"], packed)
        env = self._build_env()
        tri_shade = _pack_tri_shade(flat, packed)

        arrays = {
            "wide.nodes": rows.nodes, "wide.leaves": rows.leaves,
            "wide.bounds": rows.bounds, "wide.t_roots": rows.t_roots,
            "wide.t_lo": rows.t_lo, "wide.t_hi": rows.t_hi,
            "tri_shade": tri_shade, "materials.packed": packed,
            "mat_atlas.bsdf.data": planes["bsdf"][0],
            "mat_atlas.emissive.data": planes["emissive"][0],
            "env.rgbl": env["rgbl"], "env.select": env["select"],
            "env.alias": env["alias"],
            "emitters.select": em["select"], "emitters.alias": em["alias"],
            "emitters.tri": em["tri"], "emitters.rows": em["rows"],
            "tri_verts_sorted": verts[bvh.tri_order],
        }
        arrays.update({f"bvh.{k}": getattr(bvh, k) for k in (
            "aabb_min", "aabb_max", "left", "count", "escape", "tri_order",
            "parent")})
        statics = {
            "wide.max_depth": rows.n_levels, "wide.width": width,
            "wide.leaf_slots": leaf_cap,
            "mat_atlas.bsdf.width": planes["bsdf"][1],
            "mat_atlas.bsdf.chunks": planes["bsdf"][2],
            "mat_atlas.emissive.width": planes["emissive"][1],
            "mat_atlas.emissive.chunks": planes["emissive"][2],
            "mat_atlas.bsdf_constant": planes["bsdf_constant"],
            "mat_atlas.emissive_constant": planes["emissive_constant"],
            "mat_atlas.normals_flat": planes["normals_flat"],
            "env.integral": env["integral"],
            "emitters.count": em["count"],
            "emitters.weight_sum": em["weight_sum"],
            "has_delta": any(isinstance(m.variant, (Mirror, Glass))
                             for m in self.materials),
        }
        return arrays, statics

    def _build_env(self) -> dict:
        h = self._active_background
        equirect, size = (None, None) if h is None else self._backgrounds[h]
        if equirect is None:
            return constant_envmap((1.0, 1.0, 1.0))
        return build_envmap(equirect, size)


def _wide_layout(n_tris: int) -> tuple[int, int]:
    """(width, leaf_cap): two-row 24-wide/24-slot records above 100k
    triangles, 16-wide nodes with 12-slot leaves below (the reference's
    choice); MSN_WIDE=8|16|24|32 and MSN_LEAF_CAP=1..24 override them."""
    width, leaf_cap = (24, 24) if n_tris > 100_000 else (
        wide_bvh.WIDTH_WIDE, 12)
    env_w = os.environ.get("MSN_WIDE")
    if env_w in ("8", "16", "24", "32"):
        width = int(env_w)
    env_c = os.environ.get("MSN_LEAF_CAP")
    if env_c and env_c.isdigit() and 1 <= int(env_c) <= 24:
        leaf_cap = int(env_c)
    return width, leaf_cap


def _pack_tri_shade(flat: dict, mat_packed: np.ndarray) -> np.ndarray:
    verts = flat["verts"]
    T = len(verts)
    tri_shade = np.zeros((T, 48), np.float32)
    tri_shade[:, 0:9] = verts.reshape(T, 9)
    tri_shade[:, 9:18] = flat["normals"].reshape(T, 9)
    tri_shade[:, 18:24] = flat["uvs"].reshape(T, 6)
    tri_shade[:, 24] = flat["mat_ids"]
    tri_shade[:, 25] = flat["sampled"]
    tri_shade[:, 26] = flat["inst_ids"]
    tri_shade[:, 27] = flat["geo_ids"]
    tri_shade[:, 28] = flat["prim_ids"]
    tri_shade[:, 32:48] = mat_packed[
        np.clip(flat["mat_ids"], 0, len(mat_packed) - 1)]
    return tri_shade


def _build_materials(materials, builder: MaterialBlockBuilder):
    """(packed [M, 16] f32, atlas planes) for the material list."""
    n = max(len(materials), 1)
    type_ = np.zeros(n, np.int32)
    ior = np.full(n, 1.5, np.float32)
    default_normal = (0.5, 0.5)  # decodes to the (0, 0, 1) tangent normal
    white3 = (1.0, 1.0, 1.0)
    black3 = (0.0, 0.0, 0.0)
    if not materials:
        builder.add(white3, 0.0, 1.0, black3, default_normal)
    for i, m in enumerate(materials):
        normal = default_normal if m.normal is None else m.normal
        v = m.variant
        if isinstance(v, StandardPBR):
            type_[i] = TYPE_PBR
            builder.add(v.color, v.metalness, v.roughness, m.emissive, normal)
            ior[i] = v.ior
        elif isinstance(v, Lambert):
            type_[i] = TYPE_LAMBERT
            builder.add(v.color, 0.0, 1.0, m.emissive, normal)
        elif isinstance(v, Glass):
            type_[i] = TYPE_GLASS
            ior[i] = v.ior
            builder.add(white3, 0.0, 1.0, m.emissive, normal)
        elif isinstance(v, Mirror):
            type_[i] = TYPE_MIRROR
            builder.add(white3, 0.0, 1.0, m.emissive, normal)
        else:
            raise TypeError(f"unknown material variant {v!r}")

    planes, rects, constants = builder.build()
    packed = np.zeros((n, 16), np.float32)
    packed[:, 0] = type_
    packed[:, 5] = ior
    if planes["bsdf_constant"]:
        packed[:, 1:4] = constants[:, 0:3]
        packed[:, 4] = constants[:, 3]
        packed[:, 6] = constants[:, 4]
        packed[:, 10:12] = constants[:, 8:10]
    else:
        packed[:, 1:5] = rects[:, 0]
    if planes["emissive_constant"]:
        packed[:, 7:10] = constants[:, 5:8]
    else:
        packed[:, 12:16] = rects[:, 1]
    return packed, planes


def _flatten(meshes, instances) -> dict | None:
    """World-space flatten of every instance, visible or not. Object-space
    attributes are concatenated first and each instance's slice is then
    transformed as one array, as the reference does; hidden instances
    collapse to their translation point (zero-area triangles that are
    never hit). Returns None for a scene with no triangles."""
    cols = {k: [] for k in ("p", "n", "uvs", "mat_ids", "sampled",
                            "inst_ids", "geo_ids", "prim_ids")}
    slices = []
    t = 0
    for inst_id, inst in enumerate(instances):
        start = t
        for geo_id, geo in enumerate(inst.geometries):
            mesh = meshes[geo.mesh]
            idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
            F = len(idx)
            p = np.asarray(mesh.positions, np.float32)[idx]
            attr_idx = (idx if mesh.indexed_attributes
                        else np.arange(F * 3, dtype=np.int64).reshape(F, 3))
            if mesh.normals is not None:
                nrm = np.asarray(mesh.normals, np.float32)[attr_idx]
            else:
                gn = np.cross(p[:, 0] - p[:, 2], p[:, 1] - p[:, 2])
                gl = np.linalg.norm(gn, axis=-1, keepdims=True)
                nrm = np.repeat((gn / np.maximum(gl, 1e-20))[:, None, :], 3,
                                axis=1)
            if mesh.texcoords is not None:
                uv = np.asarray(mesh.texcoords, np.float32)[attr_idx]
            else:
                uv = np.broadcast_to(
                    np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                    (F, 3, 2)).copy()
            cols["p"].append(p)
            cols["n"].append(nrm)
            cols["uvs"].append(uv)
            cols["mat_ids"].append(np.full(F, geo.material, np.int32))
            cols["sampled"].append(np.full(F, geo.sampled, bool))
            cols["inst_ids"].append(np.full(F, inst_id, np.int32))
            cols["geo_ids"].append(np.full(F, geo_id, np.int32))
            cols["prim_ids"].append(np.arange(F, dtype=np.int32))
            t += F
        slices.append((start, t))
    if t == 0:
        return None
    flat = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
    obj_p = flat.pop("p").astype(np.float32)
    obj_n = flat.pop("n").astype(np.float32)
    uvs = flat["uvs"].astype(np.float32)
    verts = np.empty((t, 3, 3), np.float32)
    normals = np.empty((t, 3, 3), np.float32)
    for inst, (s, e) in zip(instances, slices):
        if s == e:
            continue
        M = np.asarray(inst.transform, np.float32)
        lin = M[:, :3]
        trans = M[:, 3]
        if not inst.visible:
            verts[s:e] = trans
            normals[s:e] = np.float32([0, 0, 1])
            continue
        det = float(np.linalg.det(lin))
        nrm_m = np.linalg.inv(lin).T if abs(det) > 1e-20 else lin
        pw = obj_p[s:e] @ lin.T + trans
        nw = obj_n[s:e] @ nrm_m.T
        nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True),
                             1e-20)
        if det < 0.0:
            pw = pw[:, [0, 2, 1]]
            nw = nw[:, [0, 2, 1]]
            uvs[s:e] = uvs[s:e][:, [0, 2, 1]]
        verts[s:e] = pw
        normals[s:e] = nw
    flat.update(verts=verts, normals=normals, uvs=uvs)
    return flat


def _build_emitters(verts, emitter_tris, uvs, mat_ids, mat_packed) -> dict:
    """Host arrays of the emitter alias table and light rows."""
    if len(emitter_tris) == 0:
        return dict(select=np.ones(1, np.float32), alias=np.zeros(1, np.int64),
                    tri=np.zeros(1, np.int64),
                    rows=np.zeros((1, 25), np.float32), count=0,
                    weight_sum=0.0)
    tv = verts[emitter_tris]
    areas = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1)
    table = alias_table.build(areas)
    E = len(emitter_tris)
    rows = np.zeros((E, 25), np.float32)
    rows[:, 0:9] = tv.reshape(E, 9)
    rows[:, 9:15] = uvs[emitter_tris].reshape(E, 6)
    mrow = mat_packed[np.clip(mat_ids[emitter_tris], 0, len(mat_packed) - 1)]
    rows[:, 15:18] = mrow[:, 7:10]
    rows[:, 18:22] = mrow[:, 12:16]
    rows[:, 22] = emitter_tris
    return dict(select=table.select, alias=table.alias.astype(np.int64),
                tri=emitter_tris.astype(np.int64), rows=rows,
                count=int(table.count) if table.weight_sum > 0.0 else 0,
                weight_sum=float(np.float32(table.weight_sum)))
