"""Host-side scene description types (numpy only; copied from
moonshine_tpu/scene/types.py, the reference).

Capability parity with the reference's manager inputs:
  Mesh           <- MeshManager.Mesh (MeshManager.zig:17-32)
  MaterialInfo   <- MaterialManager.MaterialInfo tagged union
                    (MaterialManager.zig:22-127): variants StandardPBR,
                    Lambert, Glass, PerfectMirror + shared normal/emissive
  Geometry       <- Accel.Geometry {mesh, material, sampled} (Accel.zig:34-44)
  Instance       <- Accel.Instance {transform, visible, geometries}
  Lens           <- Camera.Lens (Camera.zig:18-52)

Texture-valued fields take either a constant (float / rgb tuple) or a numpy
image; the world builder uploads them to the atlas just like the
reference's TextureManager constant-vs-image sources.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

TextureSource = Union[float, Sequence[float], np.ndarray]


@dataclass
class Mesh:
    positions: np.ndarray  # [V, 3] f32
    indices: np.ndarray  # [F, 3] u32
    normals: Optional[np.ndarray] = None  # [V, 3] (indexed) or [F*3, 3]
    texcoords: Optional[np.ndarray] = None  # [V, 2] or [F*3, 2]
    # False mirrors the reference's non-indexed attribute mode where
    # attribute i of face f lives at f*3+i (hydra meshes; main.hlsl:39)
    indexed_attributes: bool = True


@dataclass
class StandardPBR:
    color: TextureSource = (1.0, 1.0, 1.0)
    metalness: TextureSource = 0.0
    roughness: TextureSource = 1.0
    ior: float = 1.5


@dataclass
class Lambert:
    color: TextureSource = (1.0, 1.0, 1.0)


@dataclass
class Glass:
    ior: float = 1.5


@dataclass
class Mirror:
    pass


Variant = Union[StandardPBR, Lambert, Glass, Mirror]


@dataclass
class MaterialInfo:
    variant: Variant
    # flat tangent-space normal by default (z-up), like the reference's
    # default 1x1 (0.5, 0.5) two-component normal texture
    normal: Optional[TextureSource] = None
    emissive: TextureSource = (0.0, 0.0, 0.0)


@dataclass
class Geometry:
    mesh: int  # mesh handle
    material: int  # material handle
    sampled: bool = False  # participates in NEE mesh-light sampling


@dataclass
class Instance:
    transform: np.ndarray  # [3, 4] f32 object->world
    geometries: list[Geometry] = field(default_factory=list)
    visible: bool = True


@dataclass
class Lens:
    origin: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    vfov: float  # radians
    aperture: float = 0.0
    focus_distance: float = 1.0

    @staticmethod
    def default():
        return Lens(
            origin=np.zeros(3, np.float32),
            forward=np.asarray([0, 1, 0], np.float32),
            up=np.asarray([0, 0, 1], np.float32),
            vfov=np.pi / 3,
        )


def identity_transform() -> np.ndarray:
    return np.eye(3, 4, dtype=np.float32)


def translate(x, y, z) -> np.ndarray:
    t = np.eye(3, 4, dtype=np.float32)
    t[:, 3] = (x, y, z)
    return t


def scale_uniform(s, translation=(0.0, 0.0, 0.0)) -> np.ndarray:
    t = np.eye(3, 4, dtype=np.float32) * s
    t[:, 3] = translation
    return t
