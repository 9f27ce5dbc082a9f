"""Procedural scenes (port of moonshine_tpu/scene/procedural.py, plus the
flagship scene that `bench.py` renders, re-stated here because the JAX
package builds it from its test fixtures).

`room_scene` is an interior with textured walls, a grid of subdivided
spheres of every material type, and an emissive ceiling panel;
`flagship_scene` is the Cornell-style box with PBR, mirror and glass
spheres, an emissive light and a checkered floor under a gradient sky;
`furnace_scene` and `mirror_glass_scene` are two of the golden-image
configurations of tests/test_goldens.py. All reproduce the reference's
scenes triangle for triangle.
"""

from __future__ import annotations

import numpy as np

from .types import (
    Geometry,
    Glass,
    Instance,
    Lambert,
    Lens,
    MaterialInfo,
    Mesh,
    Mirror,
    StandardPBR,
    scale_uniform,
    translate,
)
from .world import World


def _icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: (positions [V,3] f32, faces [F,3] u32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        cache, verts_list = {}, list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(verts_list[a]) + np.asarray(verts_list[b])) / 2
                verts_list.append(m / np.linalg.norm(m))
                cache[key] = len(verts_list) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.uint32)


def icosphere_mesh(subdivisions: int, with_normals: bool = True) -> Mesh:
    """Unit icosphere mesh with outward vertex normals (the reference's
    test fixture `tests/fixtures.py::icosphere` at radius 1)."""
    v, f = _icosphere(subdivisions)
    return Mesh(positions=v, indices=f,
                normals=v.copy() if with_normals else None)


def room_scene(grid: int = 4, subdivisions: int = 3, seed: int = 0,
               textured: bool = True):
    """(grid x grid) spheres of mixed materials in a box room with an
    emissive ceiling panel. Returns (World, Lens). grid=6, sub=4 is the
    ~184k-triangle ladder rung."""
    rs = np.random.RandomState(seed)
    world = World()
    sphere = world.add_mesh(icosphere_mesh(subdivisions))
    quad = world.add_mesh(Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]]),
        texcoords=np.float32([[0, 0], [6, 0], [6, 6], [0, 6]]),
    ))

    if textured:
        checker = (np.indices((16, 16)).sum(0) % 2).astype(np.float32)
        wall_tex = (0.3 + 0.5 * checker)[..., None] * np.float32([1, 0.9, 0.8])
        rough_tex = 0.3 + 0.6 * checker[..., None]
    else:
        wall_tex = (0.7, 0.7, 0.7)
        rough_tex = 0.8

    wall = world.add_material(MaterialInfo(
        variant=StandardPBR(color=wall_tex, metalness=0.0,
                            roughness=rough_tex)))
    light = world.add_material(MaterialInfo(
        variant=Lambert(color=(0, 0, 0)), emissive=(6.0, 6.0, 6.0)))

    half = grid * 1.6 / 2 + 2.0
    placements = [  # floor, ceiling, back/left/right walls
        np.float32([[half, 0, 0, 0], [0, half, 0, 0], [0, 0, 1, 0]]),
        np.float32([[half, 0, 0, 0], [0, -half, 0, 0], [0, 0, -1, 2 * half]]),
        np.float32([[half, 0, 0, 0], [0, 0, -half, half], [0, 1, 0, half]]),
        np.float32([[0, 0, half, -half], [half, 0, 0, 0], [1, 0, 0, half]]),
        np.float32([[0, 0, -half, half], [-half, 0, 0, 0], [1, 0, 0, half]]),
    ]
    for transform in placements:
        world.add_instance(Instance(transform=transform,
                                    geometries=[Geometry(quad, wall)]))
    world.add_instance(Instance(  # emissive panel just below the ceiling
        transform=np.float32([[half * 0.4, 0, 0, 0],
                              [0, -half * 0.4, 0, 0],
                              [0, 0, -1, 2 * half - 0.01]]),
        geometries=[Geometry(quad, light, sampled=True)],
    ))

    variants = [
        lambda: Lambert(color=tuple(0.2 + 0.7 * rs.rand(3))),
        lambda: StandardPBR(color=tuple(0.3 + 0.6 * rs.rand(3)),
                            metalness=float(rs.rand()),
                            roughness=float(0.1 + 0.8 * rs.rand())),
        lambda: Mirror(),
        lambda: Glass(ior=1.45 + 0.2 * float(rs.rand())),
    ]
    spacing = 1.6
    offset = (grid - 1) * spacing / 2
    for i in range(grid):
        for j in range(grid):
            mat = world.add_material(
                MaterialInfo(variant=variants[(i * grid + j) % 4]()))
            radius = 0.55 + 0.2 * rs.rand()
            world.add_instance(Instance(
                transform=scale_uniform(
                    radius, (i * spacing - offset, j * spacing - offset,
                             radius)),
                geometries=[Geometry(sphere, mat)],
            ))

    sky = np.zeros((8, 16, 3), np.float32)
    sky[:4] = [0.3, 0.4, 0.6]
    world.set_background(sky)

    lens = Lens(
        origin=np.float32([0, -half + 0.5, half * 0.8]),
        forward=np.float32([0, 1.0, -0.35]) / np.linalg.norm([0, 1.0, -0.35]),
        up=np.float32([0, 0, 1]),
        vfov=np.pi / 3,
    )
    return world, lens


def flagship_scene():
    """The 964-triangle flagship that bench.py renders
    (__graft_entry__._flagship_scene): every material, both NEE paths, a
    textured floor. Returns (World, Lens)."""
    w = World()
    sphere = w.add_mesh(icosphere_mesh(2))
    quad = w.add_mesh(Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]]),
        texcoords=np.float32([[0, 0], [4, 0], [4, 4], [0, 4]])))
    checker = np.indices((8, 8)).sum(0) % 2
    floor_tex = (0.2 + 0.6 * checker)[..., None] * np.ones(3, np.float32)
    mats = {
        "floor": w.add_material(MaterialInfo(variant=Lambert(color=floor_tex))),
        "mirror": w.add_material(MaterialInfo(variant=Mirror())),
        "glass": w.add_material(MaterialInfo(variant=Glass(ior=1.5))),
        "pbr": w.add_material(MaterialInfo(
            variant=StandardPBR(color=(0.7, 0.5, 0.3), roughness=0.3,
                                metalness=0.8))),
        "light": w.add_material(MaterialInfo(
            variant=Lambert(color=(0, 0, 0)), emissive=(8.0, 8.0, 8.0))),
    }
    w.add_instance(Instance(transform=scale_uniform(6.0, (0, 0, -1)),
                            geometries=[Geometry(quad, mats["floor"])]))
    for x, m in [(-2.2, "pbr"), (0.0, "mirror"), (2.2, "glass")]:
        w.add_instance(Instance(transform=translate(x, 0, 0),
                                geometries=[Geometry(sphere, mats[m])]))
    w.add_instance(Instance(
        transform=scale_uniform(1.5, (0, 0, 4.0)),
        geometries=[Geometry(quad, mats["light"], sampled=True)]))
    sky = np.concatenate(
        [np.linspace(1.5, 0.2, 16)[:, None, None] * np.ones((1, 32, 1)),
         0.5 * np.ones((16, 32, 2))], axis=-1).astype(np.float32)
    w.set_background(sky, size=16)
    lens = Lens(origin=np.float32([0, -9, 1.5]),
                forward=np.float32([0, 1, -0.12]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)
    return w, lens


def _golden_lens() -> Lens:
    return Lens(origin=np.float32([0, -3, 0]), forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)


def furnace_scene():
    """Albedo-1 Lambert sphere under a uniform white sky: every pixel
    integrates to exactly 1 (the `furnace` config of
    tests/test_goldens.py). Returns (World, Lens)."""
    w = World()
    mesh = w.add_mesh(icosphere_mesh(2, with_normals=False))
    mat = w.add_material(MaterialInfo(variant=Lambert(color=(1, 1, 1))))
    w.add_instance(Instance(transform=np.eye(3, 4, dtype=np.float32),
                            geometries=[Geometry(mesh, mat)]))
    w.set_background(None)
    return w, _golden_lens()


def mirror_glass_scene():
    """Mirror and glass spheres over a grey floor under a sky with a
    bright patch (the `mirror_glass` config of tests/test_goldens.py).
    Returns (World, Lens)."""
    w = World()
    sphere = w.add_mesh(icosphere_mesh(3))
    floor = w.add_mesh(Mesh(
        positions=np.float32([[-20, -20, -1], [20, -20, -1],
                              [20, 20, -1], [-20, 20, -1]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
    mats = [w.add_material(MaterialInfo(variant=Mirror())),
            w.add_material(MaterialInfo(variant=Glass(ior=1.5))),
            w.add_material(MaterialInfo(
                variant=Lambert(color=(0.6, 0.6, 0.6))))]
    for x, m in [(-1.5, 0), (1.5, 1)]:
        w.add_instance(Instance(transform=translate(x, 0, 0),
                                geometries=[Geometry(sphere, mats[m])]))
    w.add_instance(Instance(transform=np.eye(3, 4, dtype=np.float32),
                            geometries=[Geometry(floor, mats[2])]))
    sky = np.zeros((16, 32, 3), np.float32)
    sky[:, :, :] = 0.2
    sky[2:4, 5:10] = 12.0
    w.set_background(sky, size=16)
    return w, _golden_lens()
