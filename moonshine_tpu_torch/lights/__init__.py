from .envmap import (  # noqa: F401
    EnvMap,
    build_envmap,
    constant_envmap,
    sample_envmap,
    eval_envmap,
    envmap_incoming_radiance,
    miss_radiance_and_pdf,
)
from .mesh_lights import sample_mesh_lights, area_to_solid_angle  # noqa: F401
