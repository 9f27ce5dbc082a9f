"""Frozen copy of chip_smoke.py `room_glb` at commit 747dbd6, taking the
benchmark's plain scene description (portbench/scenes) where the
original takes the program's World and Lens: a .glb of a scene with
constant materials, one geometry per instance, one glTF mesh per (mesh,
material) pair, node matrices stored with rows 1 and 2 of the Z-up
transform swapped (the loader's Y-up -> Z-up row permutation gives each
transform back exactly), the sampled geometry's material named
"Emitter", and a camera node from the lens."""

from __future__ import annotations

import numpy as np

from .glb_builder import build_glb


def scene_glb(desc: dict) -> bytes:
    sampled = {inst["material"] for inst in desc["instances"]
               if inst["sampled"]}
    materials = []
    for i, mat in enumerate(desc["materials"]):
        kind, em = mat["kind"], np.float32(mat["emissive"])
        m = {"name": "Emitter" if i in sampled else f"material_{i}"}
        if kind == "glass":
            m["extensions"] = {
                "KHR_materials_transmission": {"transmissionFactor": 1.0},
                "KHR_materials_ior": {"ior": float(mat["ior"])}}
        elif kind == "mirror":
            m["pbrMetallicRoughness"] = {"metallicFactor": 1.0,
                                         "roughnessFactor": 0.0}
        else:
            color = [float(c) for c in mat["color"]] + [1.0]
            pbr = kind == "pbr"
            if not (pbr or kind == "lambert"):
                raise ValueError(f"unknown material kind {kind!r}")
            m["pbrMetallicRoughness"] = {
                "baseColorFactor": color,
                "metallicFactor": float(mat["metalness"]) if pbr else 0.0,
                "roughnessFactor": float(mat["roughness"]) if pbr else 1.0}
            if pbr:
                m["extensions"] = {"KHR_materials_ior": {
                    "ior": float(mat["ior"])}}
        if em.any():
            s = float(em.max())
            m["emissiveFactor"] = [float(c) for c in em / s]
            m.setdefault("extensions", {})[
                "KHR_materials_emissive_strength"] = {"emissiveStrength": s}
        materials.append(m)
    meshes, mesh_of, nodes = [], {}, []
    for inst in desc["instances"]:
        key = (inst["mesh"], inst["material"])
        if key not in mesh_of:
            src = desc["meshes"][inst["mesh"]]
            if np.max(src["indices"]) >= 65536:
                raise ValueError("the glb writer stores 16-bit indices")
            mesh_of[key] = len(meshes)
            meshes.append(dict(positions=src["positions"],
                               indices=src["indices"],
                               normals=src["normals"],
                               texcoords=src["texcoords"],
                               material=inst["material"]))
        m4 = np.zeros((4, 4), np.float32)
        t = np.asarray(inst["transform"], np.float32)
        m4[[0, 2, 1], :] = t
        m4[3, 3] = 1.0
        nodes.append({"mesh": mesh_of[key],
                      "matrix": m4.T.reshape(-1).tolist()})
    lens = desc["lens"]
    fwd = np.float32(lens["forward"])
    up = np.float32(lens["up"])
    right = np.cross(fwd, up)
    cam = np.zeros((4, 4), np.float32)
    cam[[0, 2, 1], :3] = np.stack([right / np.linalg.norm(right), up, -fwd],
                                  axis=1)
    cam[[0, 2, 1], 3] = np.float32(lens["origin"])
    cam[3, 3] = 1.0
    nodes.append({"camera": 0, "matrix": cam.T.reshape(-1).tolist()})
    cameras = [{"type": "perspective",
                "perspective": {"yfov": float(lens["vfov"]), "znear": 0.01}}]
    return build_glb(meshes, materials, nodes, cameras)
