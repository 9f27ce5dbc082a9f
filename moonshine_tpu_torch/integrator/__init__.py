from .path import PathConfig, trace_paths, power_heuristic  # noqa: F401
