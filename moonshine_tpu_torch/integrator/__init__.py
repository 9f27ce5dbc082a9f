from .path import PathConfig, trace_paths  # noqa: F401
from .shade import power_heuristic  # noqa: F401
