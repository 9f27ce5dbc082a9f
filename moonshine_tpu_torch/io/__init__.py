from .exr import read_exr  # noqa: F401
