from . import rng, mappings, frame, mathutil, alias_table  # noqa: F401
