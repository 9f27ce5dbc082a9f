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
as in the reference. `MSN_PRESPLIT=<factor>` (factor > 1, SAH builds
only, off by default as in the reference) builds over spatial-split
references (`lbvh.presplit_refs`, at most factor x T of them): the wide
leaves' boxes come from the clipped reference boxes, leaf slots and the
binary tree's `tri_order` repeat triangle ids, and `tri_verts_sorted` has
one row per reference, so every dispatch mode (the packet, treelet and
per-lane walks) traverses the same tree. Two-level instancing is not
ported yet: a scene that would need it raises.

Edits (set_transform / set_visibility / update_material / use_background)
make `build()` staged, as in the reference: it returns the cached scene
when nothing changed; a transform or visibility edit re-transforms the
cached object-space flatten and refits both trees on the host
(lbvh.refit_host, wide.refit_wide), every shape kept (hidden
instances collapse to zero-area triangles at their translation, and the
emitter table keeps its rows, a hidden emitter weighing 0); a material
edit rebuilds only the material table and atlas (and refolds the
material columns of tri_shade and the emitter rows); a background edit
swaps in the env map, built once per background as the reference's;
adding meshes or instances, another builder or another device does the
full build.
`build_arrays()` is always the full host build.
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

# past this many flattened triangles (MSN_MAX_FLAT_TRIS overrides it, read
# at each build) the reference switches to two-level instancing, which the
# port does not have yet
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


def _emitters_on(a: dict, s: dict, device) -> EmitterTable:
    put = lambda x, dt=np.float32: torch.tensor(np.asarray(x, dt),
                                                 device=device)
    return EmitterTable(
        select=put(a["emitters.select"]),
        alias=put(a["emitters.alias"], np.int64),
        tri=put(a["emitters.tri"], np.int64),
        rows=put(a["emitters.rows"]),
        count=int(s["emitters.count"]),
        weight_sum=float(s["emitters.weight_sum"]),
    )


def _atlas_on(a: dict, s: dict, device) -> MaterialAtlas:
    planes = {
        k: plane_from_rows(a[f"mat_atlas.{k}.data"], s[f"mat_atlas.{k}.width"],
                           s[f"mat_atlas.{k}.chunks"], device)
        for k in ("bsdf", "emissive")
    }
    return MaterialAtlas(
        bsdf=planes["bsdf"], emissive=planes["emissive"],
        bsdf_constant=bool(s["mat_atlas.bsdf_constant"]),
        emissive_constant=bool(s["mat_atlas.emissive_constant"]),
        normals_flat=bool(s["mat_atlas.normals_flat"]),
    )


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
    env = envmap_from_arrays(
        {k: a[f"env.{k}"] for k in ("rgbl", "select", "alias")}
        | {"integral": s["env.integral"]}, device)
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
        mat_atlas=_atlas_on(a, s, device), env=env,
        emitters=_emitters_on(a, s, device),
        has_delta=bool(s["has_delta"]), bvh=bvh, tri_verts_sorted=tri_sorted,
    )


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class World:
    """Mutable host scene; `build(device)` freezes it into a DeviceScene,
    staged as the module docstring says."""

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[MaterialInfo] = []
        self.instances: list[Instance] = []
        self._backgrounds: list = []  # (equirect | None, size) per handle
        self._active_background: int | None = None
        # handle -> (env arrays, {device: EnvMap}), built at a
        # background's first use and kept, as the reference's _env_cache
        # (a switch back reuses the table)
        self._envs: dict = {}
        self._scene: DeviceScene | None = None
        self._state: dict | None = None  # what the staged build keeps
        self._builder: str | None = None
        self._dirty_topology = True
        self._dirty_transforms = False
        self._dirty_materials = False
        self._dirty_env = False

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self._dirty_topology = True
        return len(self.meshes) - 1

    def add_material(self, info: MaterialInfo) -> int:
        self.materials.append(info)
        self._dirty_materials = True
        return len(self.materials) - 1

    def add_instance(self, instance: Instance) -> int:
        self.instances.append(instance)
        self._dirty_topology = True
        return len(self.instances) - 1

    def add_background(self, equirect_rgb: np.ndarray | None,
                       size: int | None = None) -> int:
        """Register an environment map; None = 1x1 white."""
        self._backgrounds.append((equirect_rgb, size))
        return len(self._backgrounds) - 1

    def use_background(self, handle: int):
        if not 0 <= handle < len(self._backgrounds):
            raise IndexError(f"no background {handle}")
        if handle != self._active_background:
            self._active_background = handle
            self._dirty_env = True

    def set_background(self, equirect_rgb: np.ndarray | None,
                       size: int | None = None):
        """Register and select in one call."""
        self.use_background(self.add_background(equirect_rgb, size))

    # --- edits (reference world.py:245-257) ---

    def set_transform(self, instance: int, transform: np.ndarray):
        self.instances[instance].transform = np.asarray(transform, np.float32)
        self._dirty_transforms = True

    def set_visibility(self, instance: int, visible: bool):
        self.instances[instance].visible = visible
        self._dirty_transforms = True

    def update_material(self, handle: int, info: MaterialInfo):
        self.materials[handle] = info
        self._dirty_materials = True

    # --- freeze ---

    def build(self, device="cuda", builder: str = "auto") -> DeviceScene:
        """The DeviceScene on `device`, staged (module docstring): the
        cached scene when nothing changed, else only the dirty stages
        rebuilt. builder: "karras", "sah", or "auto" (SAH above
        SAH_MIN_TRIS triangles, Karras below; what it resolved to stays
        until an explicit other builder asks for a full build)."""
        if builder not in ("auto", "karras", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        dev = _device_key(device)
        if (self._builder is not None and builder != "auto"
                and builder != self._builder):
            self._dirty_topology = True
        if builder != "auto":
            self._builder = builder
        if self._scene is not None and self._scene.device != dev:
            self._dirty_topology = True
        if self._scene is not None and not (
                self._dirty_topology or self._dirty_transforms
                or self._dirty_materials or self._dirty_env):
            return self._scene
        if self._scene is None or self._dirty_topology:
            arrays, statics, state = self._full_arrays(
                self._builder or "auto")
            self._builder = state["builder"]
            scene = scene_from_arrays(arrays, statics, dev)
            scene = scene._replace(env=self._envs[
                self._active_background][1].setdefault(dev, scene.env))
            self._state = state
            self._dirty_transforms = self._dirty_materials = False
            self._dirty_env = False
        else:
            scene = self._scene
            if self._dirty_transforms:
                scene = self._refit(scene, dev)
                self._dirty_transforms = False
            if self._dirty_materials:
                scene = self._rebuild_materials(scene, dev)
                self._dirty_materials = False
            if self._dirty_env:
                scene = scene._replace(env=self._env_on(dev))
                self._dirty_env = False
        self._dirty_topology = False
        self._scene = scene
        return scene

    def build_arrays(self, builder: str = "auto") -> tuple[dict, dict]:
        """The full host build: (arrays, statics) for scene_from_arrays."""
        if builder not in ("auto", "karras", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        return self._full_arrays(builder)[:2]

    def _full_arrays(self, builder: str) -> tuple[dict, dict, dict]:
        """(arrays, statics, state): the full host build, and what a later
        refit or material edit starts from."""
        flat_tris = sum(len(self.meshes[g.mesh].indices)
                        for inst in self.instances for g in inst.geometries)
        cap = int(os.environ.get("MSN_MAX_FLAT_TRIS", str(MAX_FLAT_TRIS)))
        if flat_tris > cap:
            raise NotImplementedError(
                f"scene flattens to {flat_tris:,} triangles (cap {cap:,}, "
                f"MSN_MAX_FLAT_TRIS); two-level instancing is not ported")

        packed, planes = _build_materials(self.materials,
                                          MaterialBlockBuilder())
        cache = _flatten_object(self.meshes, self.instances)
        if cache is None:
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
        else:
            flat = _world_flat(cache, self.instances)
        verts = flat["verts"]
        T = len(verts)
        if builder == "auto":
            builder = "sah" if T > SAH_MIN_TRIS else "karras"
        clip_sorted = None
        presplit = float(os.environ.get("MSN_PRESPLIT", "0"))
        if builder == "sah" and presplit > 1.0:
            refs = lbvh.presplit_refs(verts, max_refs_factor=presplit)
            bvh, *clip_sorted = lbvh.build_sah(verts, refs=refs)
        elif builder == "sah":
            bvh = lbvh.build_sah(verts)
        else:
            bvh = lbvh.build(verts)
        width, leaf_cap = _wide_layout(T)
        rows = wide_bvh.build_wide_rows(verts, binary=bvh, leaf_cap=leaf_cap,
                                        width=width, clip_sorted=clip_sorted)

        emitter_tris = np.nonzero(flat["sampled"])[0]
        em = _build_emitters(verts, emitter_tris, flat["uvs"],
                             flat["mat_ids"], packed)
        env = self._build_env()

        arrays = {
            "wide.nodes": rows.nodes, "wide.leaves": rows.leaves,
            "wide.bounds": rows.bounds, "wide.t_roots": rows.t_roots,
            "wide.t_lo": rows.t_lo, "wide.t_hi": rows.t_hi,
            "tri_shade": _pack_tri_shade(flat, packed),
            "materials.packed": packed,
            "env.rgbl": env["rgbl"], "env.select": env["select"],
            "env.alias": env["alias"],
            "tri_verts_sorted": verts[bvh.tri_order],
        }
        arrays.update(_atlas_arrays(planes))
        arrays.update(_emitter_arrays(em))
        arrays.update({f"bvh.{k}": getattr(bvh, k) for k in (
            "aabb_min", "aabb_max", "left", "count", "escape", "tri_order",
            "parent")})
        statics = {
            "wide.max_depth": rows.n_levels, "wide.width": width,
            "wide.leaf_slots": leaf_cap,
            "env.integral": env["integral"],
            "has_delta": any(isinstance(m.variant, (Mirror, Glass))
                             for m in self.materials),
        }
        statics.update(_atlas_statics(planes))
        statics.update(_emitter_statics(em))
        state = dict(builder=builder, cache=cache, bvh=bvh, topo=rows.topo,
                     flat=flat, packed=packed, emitter_tris=emitter_tris,
                     statics=statics)
        return arrays, statics, state

    def _refit(self, scene: DeviceScene, dev) -> DeviceScene:
        """Transform/visibility edit: re-transform the cached object-space
        flatten and refit both trees on the host (reference world.py:
        485-522); every array keeps its shape."""
        st = self._state
        if st["cache"] is None:  # the empty scene has nothing to move
            return scene
        flat = _world_flat(st["cache"], self.instances)
        verts = flat["verts"]
        b = st["bvh"]
        b_min, b_max = lbvh.refit_host(b.left, b.count, b.escape,
                                       b.tri_order, verts)
        em = _build_emitters(verts, st["emitter_tris"], flat["uvs"],
                             flat["mat_ids"], st["packed"])
        st["flat"] = flat
        st["statics"].update(_emitter_statics(em))
        put = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
        return scene._replace(
            bvh=scene.bvh._replace(aabb_min=put(b_min), aabb_max=put(b_max)),
            wide=wide_bvh.refit_wide(st["topo"], b_min, b_max, verts,
                                     device=dev),
            tri_verts_sorted=put(verts[b.tri_order]),
            tri_shade=put(_pack_tri_shade(flat, st["packed"])),
            emitters=_emitters_on(_emitter_arrays(em), st["statics"], dev),
        )

    def _rebuild_materials(self, scene: DeviceScene, dev) -> DeviceScene:
        """Material edit: the material table and atlas anew, the material
        columns of tri_shade refolded and the emitter rows repacked; the
        trees, the geometry columns and the env stay."""
        st = self._state
        packed, planes = _build_materials(self.materials,
                                          MaterialBlockBuilder())
        st["packed"] = packed
        st["statics"].update(_atlas_statics(planes))
        packed_dev = torch.tensor(packed, device=dev)
        ids = scene.tri_shade[:, 24].to(torch.int64).clamp(0,
                                                            len(packed) - 1)
        tri_shade = scene.tri_shade.clone()
        tri_shade[:, 32:48] = packed_dev[ids]
        emitters = scene.emitters
        etris = st["emitter_tris"]
        if len(etris):
            f = st["flat"]
            rows = _emitter_rows(f["verts"][etris], f["uvs"][etris],
                                 f["mat_ids"][etris], packed, etris)
            emitters = emitters._replace(rows=torch.tensor(rows, device=dev))
        return scene._replace(
            materials=MaterialTable(packed=packed_dev),
            mat_atlas=_atlas_on(_atlas_arrays(planes), st["statics"], dev),
            emitters=emitters, tri_shade=tri_shade)

    def _env_on(self, dev) -> EnvMap:
        arrays = self._build_env()
        maps = self._envs[self._active_background][1]
        if dev not in maps:
            maps[dev] = envmap_from_arrays(arrays, dev)
        return maps[dev]

    def _build_env(self) -> dict:
        """The active background's env arrays, built at its first use."""
        h = self._active_background
        if h not in self._envs:
            equirect, size = ((None, None) if h is None
                              else self._backgrounds[h])
            self._envs[h] = (constant_envmap((1.0, 1.0, 1.0))
                             if equirect is None
                             else build_envmap(equirect, size), {})
        return self._envs[h][0]


def _atlas_arrays(planes: dict) -> dict:
    return {"mat_atlas.bsdf.data": planes["bsdf"][0],
            "mat_atlas.emissive.data": planes["emissive"][0]}


def _atlas_statics(planes: dict) -> dict:
    return {
        "mat_atlas.bsdf.width": planes["bsdf"][1],
        "mat_atlas.bsdf.chunks": planes["bsdf"][2],
        "mat_atlas.emissive.width": planes["emissive"][1],
        "mat_atlas.emissive.chunks": planes["emissive"][2],
        "mat_atlas.bsdf_constant": planes["bsdf_constant"],
        "mat_atlas.emissive_constant": planes["emissive_constant"],
        "mat_atlas.normals_flat": planes["normals_flat"],
    }


def _emitter_arrays(em: dict) -> dict:
    return {f"emitters.{k}": em[k] for k in ("select", "alias", "tri",
                                             "rows")}


def _emitter_statics(em: dict) -> dict:
    return {"emitters.count": em["count"],
            "emitters.weight_sum": em["weight_sum"]}


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


def _flatten_object(meshes, instances) -> dict | None:
    """Object-space flatten of every instance, visible or not (reference
    world.py:685): corners, normals (the geometric normal where a mesh has
    none), uvs ((0,0),(1,0),(1,1) where absent), ids, and each instance's
    triangle range ("slices"). None for a scene with no triangles."""
    cols = {k: [] for k in ("obj_p", "obj_n", "uvs", "mat_ids", "sampled",
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
            cols["obj_p"].append(p)
            cols["obj_n"].append(nrm)
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
    cache = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
    for k in ("obj_p", "obj_n", "uvs"):
        cache[k] = cache[k].astype(np.float32)
    cache["slices"] = slices
    return cache


def _world_flat(cache: dict, instances) -> dict:
    """The world-space flatten (reference world.py:754): each instance's
    slice transformed as one array, normals by the inverse transpose,
    corners 1/2 (and their normals and uvs) swapped under mirroring;
    hidden instances collapse to their translation point (zero-area
    triangles that are never hit), so shapes never change."""
    T = len(cache["obj_p"])
    verts = np.empty((T, 3, 3), np.float32)
    normals = np.empty((T, 3, 3), np.float32)
    uvs = cache["uvs"].copy()
    for inst, (s, e) in zip(instances, cache["slices"]):
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
        pw = cache["obj_p"][s:e] @ lin.T + trans
        nw = cache["obj_n"][s:e] @ nrm_m.T
        nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True),
                             1e-20)
        if det < 0.0:
            pw = pw[:, [0, 2, 1]]
            nw = nw[:, [0, 2, 1]]
            uvs[s:e] = uvs[s:e][:, [0, 2, 1]]
        verts[s:e] = pw
        normals[s:e] = nw
    flat = {k: cache[k] for k in ("mat_ids", "sampled", "inst_ids",
                                  "geo_ids", "prim_ids")}
    flat.update(verts=verts, normals=normals, uvs=uvs)
    return flat


def _emitter_rows(tv, tuv, tmids, mat_packed, emitter_tris) -> np.ndarray:
    """The EmitterTable.rows of the given emitter triangles."""
    E = len(emitter_tris)
    rows = np.zeros((E, 25), np.float32)
    rows[:, 0:9] = tv.reshape(E, 9)
    rows[:, 9:15] = tuv.reshape(E, 6)
    mrow = mat_packed[np.clip(tmids, 0, len(mat_packed) - 1)]
    rows[:, 15:18] = mrow[:, 7:10]
    rows[:, 18:22] = mrow[:, 12:16]
    rows[:, 22] = emitter_tris
    return rows


def _build_emitters(verts, emitter_tris, uvs, mat_ids, mat_packed) -> dict:
    """Host arrays of the emitter alias table and light rows, over the
    fixed set of sampled triangles: a hidden emitter has zero area and
    weight, and count drops to 0 when all are hidden."""
    if len(emitter_tris) == 0:
        return dict(select=np.ones(1, np.float32), alias=np.zeros(1, np.int64),
                    tri=np.zeros(1, np.int64),
                    rows=np.zeros((1, 25), np.float32), count=0,
                    weight_sum=0.0)
    tv = verts[emitter_tris]
    areas = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1)
    table = alias_table.build(areas)
    rows = _emitter_rows(tv, uvs[emitter_tris], mat_ids[emitter_tris],
                         mat_packed, emitter_tris)
    return dict(select=table.select, alias=table.alias.astype(np.int64),
                tri=emitter_tris.astype(np.int64), rows=rows,
                count=int(table.count) if table.weight_sum > 0.0 else 0,
                weight_sum=float(np.float32(table.weight_sum)))
