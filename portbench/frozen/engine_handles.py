"""Frozen copy of moonshine_tpu_torch/scripts/compare_loop.py
`engine_from_world` at commit 747dbd6, taking the benchmark's plain
scene description (portbench/scenes) where the original takes the
program's World: an Engine holding the scene entered through its
handles, a mesh per mesh, a StandardPBR material per material from
solid textures (Lambert as metalness 0, roughness 1; a mirror as
metalness 1, roughness 0; glass as a white dielectric with its ior: the
Engine, like hydra, exposes StandardPBR only), an instance per instance.
The original then sets a white background; here the description's sky
goes in through `set_background`, so that the viewer sees the same scene
as the offline CLI."""

from __future__ import annotations

import numpy as np


def as_standard_pbr(mat: dict) -> tuple:
    """(color, metalness, roughness, ior) of a material as the Engine
    takes it."""
    kind = mat["kind"]
    if kind == "lambert":
        return tuple(mat["color"]), 0.0, 1.0, 1.5
    if kind == "mirror":
        return (1.0, 1.0, 1.0), 1.0, 0.0, 1.5
    if kind == "glass":
        return (1.0, 1.0, 1.0), 0.0, 0.0, mat["ior"]
    if kind == "pbr":
        return (tuple(mat["color"]), mat["metalness"], mat["roughness"],
                mat["ior"])
    raise ValueError(f"unknown material kind {kind!r}")


def enter(engine, desc: dict) -> None:
    """The description's meshes, materials, instances and sky into
    `engine` through its handles."""
    tex = engine.create_solid_texture
    for m in desc["meshes"]:
        engine.create_mesh(m["positions"], m["indices"], m["normals"],
                           m["texcoords"], True)
    for mat in desc["materials"]:
        c, metal, rough, ior = as_standard_pbr(mat)
        engine.create_material(color=tex(c), metalness=tex(metal),
                               roughness=tex(rough),
                               emissive=tex(mat["emissive"]), ior=ior)
    for inst in desc["instances"]:
        engine.create_instance(inst["transform"],
                               [(inst["mesh"], inst["material"],
                                 inst["sampled"])], True)
    engine.set_background(np.asarray(desc["sky"], np.float32))
