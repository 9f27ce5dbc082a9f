"""Render orchestration: pixels -> rays -> radiance -> sensor (port of
moonshine_tpu/render/renderer.py).

`render_sample` traces one sample for every pixel; `render_spp` loops over
samples and sums them on the device; `render` folds samples into a
Sensor. RNG streams are keyed by (sample, x, y), so any lane order or
chunking gives the same image.
"""

from __future__ import annotations

import torch

from ..core import rng as R
from ..integrator.path import PathConfig, trace_paths
from .camera import LensArrays, generate_rays, pixel_uv
from .sensor import Sensor, accumulate

# Lanes are ordered tile-major in 64x128-pixel tiles when the image is a
# multiple of the tile, scanline otherwise (the reference's order; it
# keeps each traversal batch's rays spatially compact).
TILE_H, TILE_W = 64, 128


def _pixel_coords(height: int, width: int, device):
    """(py, px, unpack): int64 pixel rows/cols per lane and
    `unpack(flat [N, C]) -> [height, width, C]`."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int64, device=device),
        torch.arange(width, dtype=torch.int64, device=device),
        indexing="ij")
    if height % TILE_H or width % TILE_W:
        return (ys.reshape(-1), xs.reshape(-1),
                lambda flat: flat.reshape(height, width, -1))
    ty, tx = height // TILE_H, width // TILE_W

    def tiled(a):
        return a.reshape(ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(-1)

    def unpack(flat):
        return (flat.reshape(ty, tx, TILE_H, TILE_W, -1)
                .permute(0, 2, 1, 3, 4).reshape(height, width, -1))

    return tiled(ys), tiled(xs), unpack


def _sample_rays(lens: LensArrays, height: int, width: int,
                 sample_index: int, flip_image: bool, device):
    """Camera rays and per-lane RNG for one sample (the raygen stage), in
    the lane order of _pixel_coords. Returns (o, d, rng, unpack)."""
    py, px, unpack = _pixel_coords(height, width, device)
    rng = R.seed(sample_index, px, py)
    rng, jitter = R.next_float2(rng)
    uv = pixel_uv(px, py, width, height, jitter, flip_image)
    rng, ap = R.next_float2(rng)
    o, d = generate_rays(lens, width, height, uv, ap)
    return o, d, rng, unpack


def _render_sample(scene, lens: LensArrays, height: int, width: int,
                   sample_index: int, cfg: PathConfig, flip_image: bool):
    o, d, rng, unpack = _sample_rays(lens, height, width, sample_index,
                                     flip_image, scene.device)
    radiance, _rng, rays, segments = trace_paths(scene, o, d, rng, cfg)
    return unpack(radiance), rays, segments


def render_sample(scene, lens: LensArrays, height: int, width: int,
                  sample_index: int, cfg: PathConfig,
                  flip_image: bool = True):
    """Trace one sample for every pixel. Returns (radiance [H, W, 3],
    rays_traced int64 scalar tensor)."""
    img, rays, _ = _render_sample(scene, lens, height, width, sample_index,
                                  cfg, flip_image)
    return img, rays


def render_spp(scene, lens: LensArrays, height: int, width: int,
               start_index: int, spp: int, cfg: PathConfig,
               flip_image: bool = True, stats: dict | None = None):
    """Trace spp samples, summing radiance on the device. Returns
    (radiance_sum [H, W, 3], rays int64 scalar tensor). When `stats` is
    given, stats["segments"] receives the bounce segments run in all."""
    acc = torch.zeros((height, width, 3), dtype=torch.float32,
                      device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    segments = 0
    for i in range(spp):
        img, r, seg = _render_sample(scene, lens, height, width,
                                     start_index + i, cfg, flip_image)
        acc += img
        rays += r
        segments += seg
    if stats is not None:
        stats["segments"] = segments
    return acc, rays


def render(scene, lens, height: int, width: int, spp: int, cfg: PathConfig,
           flip_image: bool = True, sensor: Sensor | None = None,
           progress=None):
    """Accumulate spp samples into a (possibly existing) sensor.
    Returns (sensor, total_rays)."""
    lens_arrays = (lens if isinstance(lens, LensArrays)
                   else LensArrays.from_lens(lens, scene.device))
    if sensor is None:
        sensor = Sensor.create(height, width, scene.device)
    total_rays = 0
    for s in range(spp):
        img, rays = render_sample(scene, lens_arrays, height, width,
                                  sensor.sample_count, cfg, flip_image)
        sensor = accumulate(sensor, img, 1)
        total_rays += int(rays)
        if progress is not None:
            progress(s + 1, spp)
    return sensor, total_rays
