"""Render orchestration: pixels -> rays -> radiance -> sensor (port of
moonshine_tpu/render/renderer.py).

`render_sample` traces one sample for every pixel (or a band of rows);
`render_spp` loops over samples and sums them on the device, switching
frames above MAX_LANES pixels to the staged per-bounce path
(`_render_spp_staged`); `render` folds samples into a Sensor. RNG streams
are keyed by (sample, x, y), so any lane order, banding or batching gives
the same image.
"""

from __future__ import annotations

import torch

from ..core import rng as R
from ..integrator.path import (
    PathConfig,
    _resolve_resort,
    trace_paths,
    trace_paths_staged,
)
from .camera import LensArrays, generate_rays, pixel_uv
from .sensor import Sensor, accumulate

# Lanes are ordered tile-major in 64x128-pixel tiles when the image is a
# multiple of the tile, scanline otherwise (the reference's order; it
# keeps each traversal batch's rays spatially compact).
TILE_H, TILE_W = 64, 128

# Frames above this many pixels run through the staged path (the
# reference's switch, renderer.py:77 there), samples batched onto the lane
# axis up to STAGE_TARGET_LANES per dispatch.
MAX_LANES = 512 * 1024
STAGE_TARGET_LANES = 2 * 1024 * 1024


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
                 sample_index: int, flip_image: bool, device, y0: int = 0,
                 band_h: int | None = None):
    """Camera rays and per-lane RNG for one sample (the raygen stage) of
    rows [y0, y0 + band_h), in the lane order of _pixel_coords. Returns
    (o, d, rng, unpack)."""
    bh = height if band_h is None else band_h
    py, px, unpack = _pixel_coords(bh, width, device)
    py = py + y0  # absolute pixel rows
    rng = R.seed(sample_index, px, py)
    rng, jitter = R.next_float2(rng)
    uv = pixel_uv(px, py, width, height, jitter, flip_image)
    rng, ap = R.next_float2(rng)
    o, d = generate_rays(lens, width, height, uv, ap)
    return o, d, rng, unpack


def _render_sample(scene, lens: LensArrays, height: int, width: int,
                   sample_index: int, cfg: PathConfig, flip_image: bool,
                   y0: int = 0, band_h: int | None = None):
    o, d, rng, unpack = _sample_rays(lens, height, width, sample_index,
                                     flip_image, scene.device, y0, band_h)
    radiance, _rng, rays, segments = trace_paths(scene, o, d, rng, cfg)
    return unpack(radiance), rays, segments


def render_sample(scene, lens: LensArrays, height: int, width: int,
                  sample_index: int, cfg: PathConfig,
                  flip_image: bool = True, y0: int = 0,
                  band_h: int | None = None):
    """Trace one sample for every pixel of rows [y0, y0 + band_h) (band_h
    defaults to the full height). Returns (radiance [band_h, W, 3],
    rays_traced int64 scalar tensor)."""
    img, rays, _ = _render_sample(scene, lens, height, width, sample_index,
                                  cfg, flip_image, y0, band_h)
    return img, rays


def _sample_rays_batched(lens: LensArrays, height: int, width: int,
                         start_index: int, nbatch: int, flip_image: bool,
                         device):
    """Rays and RNG of `nbatch` consecutive samples, concatenated on the
    lane axis (sample-major); the streams are the unbatched ones."""
    rays = [_sample_rays(lens, height, width, start_index + s, flip_image,
                         device)[:3] for s in range(nbatch)]
    return tuple(torch.cat(parts) for parts in zip(*rays))


def _staged_accum(acc, rays_acc, radiance_flat, rays, height: int,
                  width: int):
    """acc + the batch's radiance summed over its samples, in pixel order."""
    _, _, unpack = _pixel_coords(height, width, acc.device)
    n = height * width
    if radiance_flat.shape[0] != n:  # sample-batched
        radiance_flat = radiance_flat.reshape(-1, n, 3).sum(dim=0)
    return acc + unpack(radiance_flat), rays_acc + rays


def _render_spp_staged(scene, lens: LensArrays, height: int, width: int,
                       start_index: int, spp: int, cfg: PathConfig,
                       flip_image: bool = True, batch: int | None = None,
                       stats: dict | None = None):
    """The large-frame path: trace_paths_staged over batches of samples
    packed onto the lane axis, up to STAGE_TARGET_LANES lanes each."""
    lanes = height * width
    if batch is None:
        batch = max(1, min(spp, STAGE_TARGET_LANES // lanes))
    acc = torch.zeros((height, width, 3), dtype=torch.float32,
                      device=scene.device)
    rays_acc = torch.zeros((), dtype=torch.int64, device=scene.device)
    segments = 0
    s = 0
    while s < spp:
        b = min(batch, spp - s)
        o, d, rng = _sample_rays_batched(lens, height, width,
                                         start_index + s, b, flip_image,
                                         scene.device)
        radiance, _, rays, seg = trace_paths_staged(scene, o, d, rng, cfg)
        acc, rays_acc = _staged_accum(acc, rays_acc, radiance, rays, height,
                                      width)
        segments += seg
        s += b
    if stats is not None:
        stats.update(path="staged", resort=_resolve_resort(scene, cfg),
                     segments=segments)
    return acc, rays_acc


def render_spp(scene, lens: LensArrays, height: int, width: int,
               start_index: int, spp: int, cfg: PathConfig,
               flip_image: bool = True, stats: dict | None = None):
    """Trace spp samples, summing radiance on the device. Frames up to
    MAX_LANES pixels trace one sample per bounce loop; larger ones take
    the staged path. Returns (radiance_sum [H, W, 3], rays int64 scalar
    tensor). When `stats` is given it receives "path" ("fused" or
    "staged"), "resort" and "segments", the bounce segments run in all."""
    if height * width > MAX_LANES:
        return _render_spp_staged(scene, lens, height, width, start_index,
                                  spp, cfg, flip_image, stats=stats)
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
        stats.update(path="fused",
                     resort=_resolve_resort(scene, cfg, height * width),
                     segments=segments)
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
