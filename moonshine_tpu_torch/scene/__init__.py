from .textures import (  # noqa: F401
    MaterialAtlas,
    MaterialBlockBuilder,
    sample_material_block,
)
from .types import (  # noqa: F401
    Mesh,
    Geometry,
    Instance,
    Lens,
    Glass,
    Lambert,
    Mirror,
    StandardPBR,
    MaterialInfo,
)
from .world import World, DeviceScene, scene_from_arrays  # noqa: F401
