"""Seeded scene makers, one module per scene, named by a traffic file's
`scene`: `make(seed, **scene_args)` returns the plain description that
room.py's docstring sets out."""
