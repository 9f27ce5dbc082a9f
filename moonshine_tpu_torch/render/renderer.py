"""Render orchestration: pixels -> rays -> radiance -> sensor (port of
moonshine_tpu/render/renderer.py).

`render_sample` traces one sample for every pixel (or a band of rows);
`render_spp` loops over samples and sums them on the device, switching
frames above MAX_LANES pixels to the staged per-bounce path
(`_render_spp_staged`); `render` folds samples into a Sensor. RNG streams
are keyed by (sample, x, y), so any lane order, banding or batching gives
the same image. Each runs through a cached `_Frame`: camera rays, the
bounce loop and the accumulation as graph steps (integrator/graphs.py),
the sample index a device scalar.
"""

from __future__ import annotations

import torch

from ..core import rng as R
from ..integrator import graphs, path
from ..integrator.path import PathConfig, _new_trace, _resolve_resort
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


class _Frame:
    """One frame shape's run: camera rays of `nbatch` samples of rows
    [y0, y0 + bh) (sample-major on the lane axis) through one bounce loop
    (path._Trace), summed over samples into `acc` in pixel order. The
    lens, the first sample index, `acc` and the ray count are static
    buffers, so the camera-ray step and the accumulation are graph steps
    too; `run` loads the lens and the index and replays, resumable at
    each read of the live count (path._Trace.run)."""

    def __init__(self, scene, lens: LensArrays, cfg: PathConfig,
                 height: int, width: int, y0: int, bh: int, nbatch: int,
                 flip_image: bool, staged: bool):
        dev = scene.device
        self.trace = _new_trace(scene, cfg, nbatch * bh * width, staged)
        self.height, self.width, self.y0, self.bh = height, width, y0, bh
        self.nbatch, self.flip_image = nbatch, flip_image
        self.lens = LensArrays(*(torch.empty_like(x, device=dev)
                                 for x in lens))
        self.sample = torch.zeros((), dtype=torch.int64, device=dev)
        self.acc = torch.zeros((bh, width, 3), dtype=torch.float32,
                               device=dev)
        self.rays = torch.zeros((), dtype=torch.int64, device=dev)
        self.unpack = _pixel_coords(bh, width, dev)[2]

    def raygen(self) -> None:
        """The step before a trace: this sample's camera rays and RNG in
        the trace's buffers, its state reset."""
        rays = [_sample_rays(self.lens, self.height, self.width,
                             self.sample + s, self.flip_image,
                             self.acc.device, self.y0, self.bh)[:3]
                for s in range(self.nbatch)]
        st = self.trace.st
        for k, parts in zip(("o", "d", "rng"), zip(*rays)):
            st[k].copy_(parts[0] if self.nbatch == 1 else torch.cat(parts))
        self.trace.reset()

    def accumulate(self) -> None:
        """The step after a trace: its radiance, summed over the batch's
        samples, into acc; the next sample index."""
        radiance = self.trace.radiance()
        if self.nbatch > 1:
            radiance = radiance.reshape(self.nbatch, -1, 3).sum(dim=0)
        self.acc += self.unpack(radiance)
        self.rays += self.trace.st["rays"]
        self.sample += self.nbatch

    def run(self, scene, lens: LensArrays, start: int, groups: int):
        """`groups` batches of samples from `start` on, as a generator
        that yields the trace at each read of its live count (driven by
        path.run_alone, or with other shards by parallel/sharding.py) and
        whose value is (sum of radiance [bh, W, 3], rays int64 scalar,
        segments). The lens may lie on another device."""
        steps = self.trace.steps
        with self.trace.lock:
            for dst, src in zip(self.lens, lens):
                dst.copy_(src)
            self.sample.fill_(start)
            self.acc.zero_()
            self.rays.zero_()
            segments = 0
            for _ in range(groups):
                steps.run("raygen", self.raygen)
                segments += yield from self.trace.run(scene)
                steps.run("accumulate", self.accumulate)
            return self.acc.clone(), self.rays.clone(), segments


def _frame(scene, lens: LensArrays, cfg: PathConfig, height: int,
           width: int, y0: int, bh: int, nbatch: int, flip_image: bool,
           staged: bool, slot=None) -> _Frame:
    """The cached frame shape. `slot` (a sharded render's shard) keeps
    apart shards that would share every other part of the key: two sample
    shards of the same rows on one device."""
    key = ("frame", path._run_key(scene), cfg, height, width, y0, bh,
           nbatch, flip_image, staged, slot)
    return graphs.run_shape(key, lambda: _Frame(
        scene, lens, cfg, height, width, y0, bh, nbatch, flip_image,
        staged), scene)


def _sample_sum(scene, lens: LensArrays, height: int, width: int,
                start: int, groups: int, cfg: PathConfig, flip_image: bool,
                y0: int = 0, band_h: int | None = None, nbatch: int = 1,
                staged: bool = False):
    """_Frame.run of the cached frame shape: (radiance summed over
    groups x nbatch samples from `start` on [band_h, W, 3], rays int64
    scalar, segments). staged: each batch through trace_paths_staged's
    form, else trace_paths'."""
    bh = height if band_h is None else band_h
    frame = _frame(scene, lens, cfg, height, width, y0, bh, nbatch,
                   flip_image, staged)
    return path.run_alone(frame.run(scene, lens, start, groups))


def render_sample(scene, lens: LensArrays, height: int, width: int,
                  sample_index: int, cfg: PathConfig,
                  flip_image: bool = True, y0: int = 0,
                  band_h: int | None = None):
    """Trace one sample for every pixel of rows [y0, y0 + band_h) (band_h
    defaults to the full height). Returns (radiance [band_h, W, 3],
    rays_traced int64 scalar tensor)."""
    img, rays, _ = _sample_sum(scene, lens, height, width, sample_index, 1,
                               cfg, flip_image, y0, band_h)
    return img, rays


def _render_spp_staged(scene, lens: LensArrays, height: int, width: int,
                       start_index: int, spp: int, cfg: PathConfig,
                       flip_image: bool = True, batch: int | None = None,
                       stats: dict | None = None):
    """The large-frame path: trace_paths_staged over batches of samples
    packed onto the lane axis, up to STAGE_TARGET_LANES lanes each."""
    lanes = height * width
    if batch is None:
        batch = max(1, min(spp, STAGE_TARGET_LANES // lanes))
    acc = rays_acc = None
    segments = 0
    s = 0
    while s < spp:  # the full batches, then the rest as one batch
        b = min(batch, spp - s)
        groups = (spp - s) // b
        part, rays, seg = _sample_sum(scene, lens, height, width,
                                      start_index + s, groups, cfg,
                                      flip_image, nbatch=b, staged=True)
        acc = part if acc is None else acc + part
        rays_acc = rays if rays_acc is None else rays_acc + rays
        segments += seg
        s += groups * b
    if acc is None:
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene.device)
        rays_acc = torch.zeros((), dtype=torch.int64, device=scene.device)
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
    acc, rays, segments = _sample_sum(scene, lens, height, width,
                                      start_index, spp, cfg, flip_image)
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
