from .sharding import (  # noqa: F401
    Mesh, make_mesh, mesh_from_spec, render_sharded, visible_devices,
)
