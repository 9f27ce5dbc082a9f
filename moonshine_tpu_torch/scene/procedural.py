"""Procedural scenes (port of moonshine_tpu/scene/procedural.py, plus the
flagship scene that `bench.py` renders, re-stated here because the JAX
package builds it from its test fixtures).

`room_scene` is an interior with textured walls, a grid of subdivided
spheres of every material type, and an emissive ceiling panel;
`flagship_scene` is the Cornell-style box with PBR, mirror and glass
spheres, an emissive light and a checkered floor under a gradient sky;
`furnace_scene` and `mirror_glass_scene` are two of the golden-image
configurations of tests/test_goldens.py. All reproduce the reference's
scenes triangle for triangle. `instanced_scene` (the port's own) is a
grid of instances of one icosphere under seeded rotations, non-uniform
scales and mirrors: at its defaults the reference's two-level case, 4096
instances of one ~100k-triangle mesh (moonshine_tpu/accel/tlas.py:1-4).
`tie_scene` (the port's own) holds hits that tie exactly in t, for the
two-level walk's tie rule.
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
    spacing = 3.0
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


def instanced_scene(grid=(64, 64), subdivisions: int = 6, seed: int = 0):
    """grid[0] x grid[1] instances of one icosphere_mesh(subdivisions) on
    a grid 3 apart, each under a seeded rotation (a random axis
    and angle), a non-uniform scale in [0.6, 1.3] and, for one in eight,
    a mirror (x negated), all of one material; a floor under them and a
    sampled emissive quad above, a white sky. At the defaults: 4096
    instances of 81,920 triangles, 335,544,320 flattened, past the
    flatten cap. Returns (World, Lens)."""
    rs = np.random.RandomState(seed)
    spacing = 3.0
    world = World()
    sphere = world.add_mesh(icosphere_mesh(subdivisions))
    nx, ny = grid
    half = np.float32([(nx - 1) * spacing / 2, (ny - 1) * spacing / 2])
    ext = float(max(half) + 2 * spacing)
    floor = world.add_mesh(Mesh(
        positions=np.float32([[-ext, -ext, -1.5], [ext, -ext, -1.5],
                              [ext, ext, -1.5], [-ext, ext, -1.5]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
    quad = world.add_mesh(Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                              [-1, 1, 0]]) * np.float32([ext / 4, ext / 4,
                                                         1]),
        indices=np.uint32([[0, 2, 1], [0, 3, 2]])))
    # one material, so every instance shares the one BLAS (the two-level
    # build keys a BLAS on mesh, material and sampled)
    red = world.add_material(MaterialInfo(variant=Lambert(
        color=(0.8, 0.25, 0.2))))
    grey = world.add_material(MaterialInfo(variant=Lambert(
        color=(0.6, 0.6, 0.6))))
    lamp = world.add_material(MaterialInfo(variant=Lambert(color=(0, 0, 0)),
                                           emissive=(5.0, 5.0, 5.0)))
    for iy in range(ny):
        for ix in range(nx):
            axis = rs.randn(3)
            axis /= np.linalg.norm(axis)
            angle = rs.uniform(0.0, 2.0 * np.pi)
            k = np.float64([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                            [-axis[1], axis[0], 0]])
            rot = (np.eye(3) + np.sin(angle) * k
                   + (1.0 - np.cos(angle)) * (k @ k))
            lin = rot * rs.uniform(0.6, 1.3, 3)[None, :]
            if rs.rand() < 0.125:
                lin[:, 0] = -lin[:, 0]
            m = np.zeros((3, 4), np.float32)
            m[:, :3] = lin
            m[:2, 3] = np.float32([ix, iy]) * spacing - half
            world.add_instance(Instance(transform=m,
                                        geometries=[Geometry(sphere, red)]))
    world.add_instance(Instance(transform=translate(0, 0, 0),
                                geometries=[Geometry(floor, grey)]))
    world.add_instance(Instance(transform=translate(0, 0, 20.0),
                                geometries=[Geometry(quad, lamp,
                                                     sampled=True)]))
    world.set_background(None)
    dist = 0.9 * ext
    lens = Lens(origin=np.float32([0, -dist, 0.45 * dist]),
                forward=np.float32([0, 1, -0.45]) / np.float32(
                    np.hypot(1, 0.45)),
                up=np.float32([0, 0, 1]), vfov=np.pi / 3)
    return world, lens


def tie_scene(n_rays: int = 4096, seed: int = 0):
    """Instances whose hits tie exactly in t: a rotated, scaled
    icosphere(2) twice under one transform, a plane of 8x8 quads whose
    index list repeats six of its triangles, twice under one tilted
    transform and once axis-aligned behind them, and a lone icosphere.
    Returns (World, ray_o, ray_d): n_rays seeded rays from the plane
    y = -10 towards the instances (float32 numpy)."""
    rs = np.random.RandomState(seed)
    world = World()
    sphere = world.add_mesh(icosphere_mesh(2))
    g = np.linspace(-2.0, 2.0, 9, dtype=np.float32)
    xs, zs = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([xs, np.zeros_like(xs), zs], -1).reshape(-1, 3)
    q = (np.arange(8)[:, None] * 9 + np.arange(8)[None, :]).reshape(-1)
    faces = np.concatenate([np.stack([q, q + 9, q + 10], -1),
                            np.stack([q, q + 10, q + 1], -1)])
    faces = np.concatenate([faces, faces[rs.choice(len(faces), 6,
                                                   replace=False)]])
    plane = world.add_mesh(Mesh(positions=pos,
                                indices=faces.astype(np.uint32)))
    mat = world.add_material(MaterialInfo(variant=Lambert(
        color=(0.7, 0.7, 0.7))))

    def transform(axis, angle, scale, at):
        axis = np.float64(axis) / np.linalg.norm(axis)
        k = np.float64([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                        [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + np.sin(angle) * k
               + (1.0 - np.cos(angle)) * (k @ k))
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = rot * np.float64(scale)[None, :]
        m[:, 3] = at
        return m

    twin_sphere = transform([1, 2, 3], 0.8, [1.2, 0.9, 1.1], [-3, 0, 1])
    tilted = transform([1, 0, 0.3], 0.5, [1, 1, 1], [2.5, 1, 0])
    for m, mesh in ((twin_sphere, sphere), (tilted, plane),
                    (translate(0, 6, 0), plane), (twin_sphere, sphere),
                    (transform([0, 0, 1], 0.3, [0.8] * 3, [0, -1, -2.5]),
                     sphere), (tilted, plane)):
        world.add_instance(Instance(transform=m,
                                    geometries=[Geometry(mesh, mat)]))
    world.set_background(None)
    o = rs.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    o[:, 1] = -10.0
    target = rs.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    target[:, 1] = 0.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return world, o, d.astype(np.float32)
