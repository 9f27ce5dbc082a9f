from .lbvh import BVH, build  # noqa: F401
from .packet import (  # noqa: F401
    Hit,
    any_hit_packet,
    any_hit_plain,
    closest_hit_packet,
    closest_hit_plain,
)
from .wide import WideBVH, build_wide  # noqa: F401
