"""A small scene for the bounce's light draw, built through either
package's World (no JAX import here: the `cuda` tests use it too)."""

import numpy as np

CHECKER = (1.0 + 5.0 * (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
           )[..., None] * np.float32([1, 0.8, 0.6])
# name -> (the panels' emission, sampled for NEE)
LIGHTS = {"constant": ((4.0, 3.0, 2.0), True),
          "textured": (CHECKER, True),
          "no_emitters": ((4.0, 3.0, 2.0), False)}


def light_world(types, world_cls, name):
    """A floor and two light panels facing down whose emission is a
    colour or a texture, sampled for NEE or not (no emitters), under a
    seeded sky; `types` and `world_cls` are a package's scene.types and
    World."""
    emission, sampled = LIGHTS[name]
    world = world_cls()
    quad = world.add_mesh(types.Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                              [-1, 1, 0]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]]),
        texcoords=np.float32([[0, 0], [3, 0], [3, 2], [0, 2]])))
    floor = world.add_material(types.MaterialInfo(
        variant=types.StandardPBR(color=(0.6, 0.5, 0.4), metalness=0.2,
                                  roughness=0.4)))
    panel = world.add_material(types.MaterialInfo(
        variant=types.Lambert(color=(0, 0, 0)), emissive=emission))
    world.add_instance(types.Instance(
        transform=np.float32([[4, 0, 0, 0], [0, 4, 0, 0], [0, 0, 1, 0]]),
        geometries=[types.Geometry(quad, floor)]))
    for z in (3.0, 2.5):
        world.add_instance(types.Instance(
            transform=np.float32([[1, 0, 0, 0.5 * z], [0, -1, 0, 0],
                                  [0, 0, -1, z]]),
            geometries=[types.Geometry(quad, panel, sampled=sampled)]))
    rs = np.random.RandomState(3)
    world.set_background((rs.rand(16, 32, 3) ** 4 * 5).astype(np.float32))
    return world
