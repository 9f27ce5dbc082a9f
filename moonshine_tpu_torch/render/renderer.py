"""Render orchestration: pixels -> rays -> radiance -> sensor (port of
moonshine_tpu/render/renderer.py).

`render_sample` traces one sample for every pixel (or a band of rows);
`render_spp` loops over samples and sums them on the device, switching
frames above MAX_LANES pixels to the staged per-bounce path
(`_render_spp_staged`); `render` folds samples into a Sensor. RNG streams
are keyed by (sample, x, y), so any lane order, banding or batching gives
the same image. Each runs through a cached `_Frame`: camera rays, the
bounce loop and the accumulation as graph steps (integrator/graphs.py),
the sample index a device scalar; the camera rays and the accumulation
are kernels of csrc/frame.cu on the card (render/frame_kernels.py).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..integrator import graphs, path
from ..integrator.path import PathConfig, _new_trace, _resolve_resort
from . import frame_kernels as FK
from .camera import LensArrays
from .sensor import Sensor, accumulate

# Frames above this many pixels run through the staged path (the
# reference's switch, renderer.py:77 there), samples batched onto the lane
# axis up to STAGE_TARGET_LANES per dispatch.
MAX_LANES = 512 * 1024
STAGE_TARGET_LANES = 2 * 1024 * 1024


def _sample_rays(lens: LensArrays, height: int, width: int,
                 sample_index, flip_image: bool, device, y0: int = 0,
                 band_h: int | None = None):
    """Camera rays and per-lane RNG for one sample (the raygen stage) of
    rows [y0, y0 + band_h), in the lane order of frame_kernels'
    _pixel_coords (the raygen kernel on a CUDA device). Returns (o, d,
    rng, unpack)."""
    return FK.sample_rays(lens, height, width, sample_index, flip_image,
                          device, y0, band_h)


class _Frame:
    """One frame shape's run: camera rays of `nbatch` samples of rows
    [y0, y0 + bh) (sample-major on the lane axis) through one bounce loop
    (path._Trace), summed over samples into `acc` in pixel order. The
    lens, the first sample index, `acc`, the ray and segment counts are
    static buffers, so the camera-ray step and the accumulation are graph
    steps too; `run` loads the lens and the index and replays. Where the
    trace reads nothing on the host (its unrolled form) a group's camera
    rays, trace and accumulation are one step, one replay; the looped
    form's run is resumable at each read of the live count
    (path._Trace.run)."""

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
        # 4 floats a pixel (the 4th unused), so that the accumulation
        # reads and writes a pixel as one 16-byte access
        self.acc = torch.zeros((bh, width, 4), dtype=torch.float32,
                               device=dev)
        self.rays = torch.zeros((), dtype=torch.int64, device=dev)
        self.segments = torch.zeros_like(self.rays)
        self.tally = FK.Tally(rays=self.rays,
                              trace_rays=self.trace.bufs[0]["rays"],
                              segments=self.segments,
                              bounce=self.trace.bounce, sample=self.sample)

    def raygen(self) -> None:
        """The step before a trace: this sample's camera rays and RNG in
        the trace's first set of buffers, its state reset (one kernel on
        the card)."""
        with record_function("camera"):
            FK.raygen(self.lens, self.sample, self.height, self.width,
                      self.y0, self.bh, self.nbatch, self.flip_image,
                      self.trace)

    def accumulate(self) -> None:
        """The step after a trace: its radiance (from the set of buffers
        that holds its state, `with_state`), summed over the batch's
        samples, into acc; its rays and segments; the next sample
        index (one kernel on the card)."""
        with record_function("accumulate"):
            self.trace.with_state(self._add)

    def _add(self, i: int) -> None:
        st = self.trace.bufs[i]
        FK.accumulate(self.acc, st["radiance"],
                      st["pix"] if self.trace.resort else None, self.nbatch,
                      self.tally)

    def _group(self, scene) -> None:
        """A group's camera rays, unrolled trace and accumulation (one
        step)."""
        self.raygen()
        self.trace.unrolled(scene)
        self.accumulate()

    def run(self, scene, lens: LensArrays, start: int, groups: int):
        """`groups` batches of samples from `start` on, as a generator
        that yields the trace at each read of its live count (driven by
        path.run_alone, or with other shards by parallel/sharding.py) and
        whose value is (sum of radiance [bh, W, 3], rays int64 scalar,
        segments int64 scalar). The lens may lie on another device."""
        steps = self.trace.steps
        with self.trace.lock:
            with record_function("camera"):
                for dst, src in zip(self.lens, lens):
                    dst.copy_(src)
                self.sample.fill_(start)
            with record_function("accumulate"):
                self.acc.zero_()
                self.rays.zero_()
                self.segments.zero_()
            for _ in range(groups):
                if self.trace.unroll:
                    steps.run("group", lambda: self._group(scene))
                    continue
                steps.run("raygen", self.raygen)
                yield from self.trace.run(scene)
                steps.run("accumulate", self.accumulate)
            return (self.acc[..., :3].clone(
                memory_format=torch.contiguous_format), self.rays.clone(),
                self.segments.clone())


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
    groups x nbatch samples from `start` on [band_h, W, 3], rays and
    segments int64 scalars). staged: each batch through
    trace_paths_staged's form, else trace_paths'."""
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
    acc = rays_acc = segments = None
    s = 0
    while s < spp:  # the full batches, then the rest as one batch
        b = min(batch, spp - s)
        groups = (spp - s) // b
        part, rays, seg = _sample_sum(scene, lens, height, width,
                                      start_index + s, groups, cfg,
                                      flip_image, nbatch=b, staged=True)
        acc = part if acc is None else acc + part
        rays_acc = rays if rays_acc is None else rays_acc + rays
        segments = seg if segments is None else segments + seg
        s += groups * b
    if acc is None:
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene.device)
        rays_acc = torch.zeros((), dtype=torch.int64, device=scene.device)
    if stats is not None:
        stats.update(path="staged", resort=_resolve_resort(scene, cfg),
                     segments=_segments(segments))
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
        stats.update(path="fused", resort=_resolve_resort(scene, cfg),
                     segments=_segments(segments))
    return acc, rays


def _segments(segments) -> int:
    """The segments run, read from the device for a caller's stats."""
    if segments is None:
        return 0
    graphs.count("reads")
    return int(segments)


def render(scene, lens, height: int, width: int, spp: int, cfg: PathConfig,
           flip_image: bool = True, sensor: Sensor | None = None,
           progress=None):
    """Accumulate spp samples into a (possibly existing) sensor.
    Returns (sensor, total_rays)."""
    lens_arrays = (lens if isinstance(lens, LensArrays)
                   else LensArrays.from_lens(lens, scene.device))
    if sensor is None:
        sensor = Sensor.create(height, width, scene.device)
    total_rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(spp):
        img, rays = render_sample(scene, lens_arrays, height, width,
                                  sensor.sample_count, cfg, flip_image)
        sensor = accumulate(sensor, img, 1)
        total_rays += rays
        if progress is not None:
            progress(s + 1, spp)
    return sensor, int(total_rays)  # the rays read once, at the end
