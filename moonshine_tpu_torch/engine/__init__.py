from .engine import Engine, PickResult  # noqa: F401
