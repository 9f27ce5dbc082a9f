"""The room: a seeded scene maker.

Frozen copies, from commit 747dbd6, of moonshine_tpu_torch/scene/procedural.py
`room_scene` (with `_icosphere`, `icosphere_mesh` and scene/types.py
`scale_uniform`) and of moonshine_tpu_torch/scripts/__init__.py `skybox`,
restated as plain data so that a later change to the program cannot move
the benchmark's inputs. `make` returns a plain description that the
frontends hand to the program (as a .glb and an EXR, or through the
Engine's handles) and that the plain reference reads as it is:

    meshes     [{positions [V,3] f32, indices [F,3] u32, normals, texcoords}]
    materials  [{kind: lambert|pbr|mirror|glass, color, metalness,
                 roughness, ior, emissive}]
    instances  [{transform [3,4] f32, mesh, material, sampled}]
    lens       {origin, forward, up, vfov, aperture, focus_distance}
    sky        [H, W, 3] f32 equirectangular radiance

The room's geometry and materials come from `room_seed` and the sky's
clouds from `sky_seed`, both fixed by the traffic file: they set the
paths' lengths and the directions their light samples take, and so the
work. The benchmark's seed draws the sky's exposure, a power of two,
which scales every texel and the sky's luminance sum exactly and leaves
the sky's sampling table, and with it every path, the same bit for bit:
every seed does the same work on other inputs.
"""

from __future__ import annotations

import numpy as np


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


def _scale_uniform(s, translation) -> np.ndarray:
    t = np.eye(3, 4, dtype=np.float32) * s
    t[:, 3] = translation
    return t


def _material(kind, color=(1.0, 1.0, 1.0), metalness=0.0, roughness=1.0,
              ior=1.5, emissive=(0.0, 0.0, 0.0)) -> dict:
    return dict(kind=kind, color=tuple(color), metalness=metalness,
                roughness=roughness, ior=ior, emissive=tuple(emissive))


def room(grid: int, subdivisions: int, room_seed: int) -> dict:
    """room_scene(grid, subdivisions, room_seed, textured=False): (grid x
    grid) spheres of the four material kinds in a box room with an
    emissive ceiling panel; no sky yet."""
    rs = np.random.RandomState(room_seed)
    v, f = _icosphere(subdivisions)
    meshes = [
        dict(positions=v, indices=f, normals=v.copy(), texcoords=None),
        dict(positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                   [-1, 1, 0]]),
             indices=np.uint32([[0, 1, 2], [0, 2, 3]]), normals=None,
             texcoords=np.float32([[0, 0], [6, 0], [6, 6], [0, 6]])),
    ]
    sphere, quad = 0, 1
    materials = [
        _material("pbr", color=(0.7, 0.7, 0.7), metalness=0.0,
                  roughness=0.8),  # the walls
        _material("lambert", color=(0, 0, 0), emissive=(6.0, 6.0, 6.0)),
    ]
    wall, light = 0, 1
    instances = []
    half = grid * 1.6 / 2 + 2.0
    placements = [  # floor, ceiling, back/left/right walls
        np.float32([[half, 0, 0, 0], [0, half, 0, 0], [0, 0, 1, 0]]),
        np.float32([[half, 0, 0, 0], [0, -half, 0, 0], [0, 0, -1, 2 * half]]),
        np.float32([[half, 0, 0, 0], [0, 0, -half, half], [0, 1, 0, half]]),
        np.float32([[0, 0, half, -half], [half, 0, 0, 0], [1, 0, 0, half]]),
        np.float32([[0, 0, -half, half], [-half, 0, 0, 0], [1, 0, 0, half]]),
    ]
    for transform in placements:
        instances.append(dict(transform=transform, mesh=quad, material=wall,
                              sampled=False))
    instances.append(dict(  # emissive panel just below the ceiling
        transform=np.float32([[half * 0.4, 0, 0, 0],
                              [0, -half * 0.4, 0, 0],
                              [0, 0, -1, 2 * half - 0.01]]),
        mesh=quad, material=light, sampled=True))

    variants = [
        lambda: _material("lambert", color=tuple(0.2 + 0.7 * rs.rand(3))),
        lambda: _material("pbr", color=tuple(0.3 + 0.6 * rs.rand(3)),
                          metalness=float(rs.rand()),
                          roughness=float(0.1 + 0.8 * rs.rand())),
        lambda: _material("mirror"),
        lambda: _material("glass", ior=1.45 + 0.2 * float(rs.rand())),
    ]
    spacing = 1.6
    offset = (grid - 1) * spacing / 2
    for i in range(grid):
        for j in range(grid):
            materials.append(variants[(i * grid + j) % 4]())
            radius = 0.55 + 0.2 * rs.rand()
            instances.append(dict(
                transform=_scale_uniform(
                    radius, (i * spacing - offset, j * spacing - offset,
                             radius)),
                mesh=sphere, material=len(materials) - 1, sampled=False))

    lens = dict(
        origin=np.float32([0, -half + 0.5, half * 0.8]),
        forward=np.float32([0, 1.0, -0.35]) / np.linalg.norm([0, 1.0, -0.35]),
        up=np.float32([0, 0, 1]),
        vfov=np.pi / 3, aperture=0.0, focus_distance=1.0,
    )
    return dict(meshes=meshes, materials=materials, instances=instances,
                lens=lens)


def sky(seed: int, height: int, width: int) -> np.ndarray:
    """skybox() with its clouds drawn from `seed`: a vertical gradient,
    seeded low-frequency clouds and a small bright sun, float32
    [height, width, 3]."""
    h, w = height, width
    rs = np.random.RandomState(seed % 2**32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    elev = 1.0 - yy / h
    img = np.stack([0.25 + 0.35 * elev, 0.35 + 0.4 * elev,
                    0.5 + 0.45 * elev], -1)
    coarse = rs.rand(8, 16, 1).astype(np.float32)
    img *= 0.8 + 0.4 * np.repeat(np.repeat(coarse, h // 8, 0), w // 16, 1)
    img[h // 5:h // 5 + 12, w // 3:w // 3 + 12] = 400.0
    return img.astype(np.float32)


def exposure(seed: int) -> np.float32:
    """The sky's exposure for a run's seed: 2^k, k in -2..2."""
    k = np.random.default_rng([seed % 2**63, 0x736B79]).integers(-2, 3)
    return np.float32(2.0 ** k)


def make(seed: int, grid: int = 6, subdivisions: int = 4, room_seed: int = 0,
         sky_seed: int = 0, sky_height: int = 1024,
         sky_width: int = 2048) -> dict:
    """The room of `room_seed` under the sky of `sky_seed`, at the
    exposure of `seed`."""
    desc = room(grid, subdivisions, room_seed)
    desc["sky"] = sky(sky_seed, sky_height, sky_width) * exposure(seed)
    return desc
