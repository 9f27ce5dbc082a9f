from .exr import read_exr, write_exr  # noqa: F401
