"""A sample's stages around the bounce loop: the camera rays with the fresh
lane state, and the sample's accumulation, each a kernel of csrc/frame.cu
(the reference's jnp: moonshine_tpu/render/renderer.py:126-155
`_sample_rays` / `_sample_rays_batched` with integrator/path.py:655
`_init_state`, and renderer.py:158-166 `_staged_accum` with path.py:731
`_staged_finish`'s scatter by pix).

`raygen`, `sample_rays` and `accumulate` launch their kernel for CUDA
tensors, on the tensors' card and its current stream (so a CUDA graph
captures them), reading the lens and the sample index from device memory;
for CPU tensors they run their plain version (`*_plain`): the port's
torch code behind one function each. There is no fallback: a failed
build or launch raises. The kernels equal the plain versions bit for bit
on the card. Each wrapper adds one to LAUNCHES[its kernel] where it
launches (into a capture's tally while a graph is captured:
accel/launch.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import native
from ..accel.launch import Counts, call_on, count_launch
from ..core import rng as R
from .camera import LensArrays, generate_rays, pixel_uv

# Lanes are ordered tile-major in 64x128-pixel tiles when the image is a
# multiple of the tile, scanline otherwise (the reference's order; it
# keeps each traversal batch's rays spatially compact).
TILE_H, TILE_W = 64, 128

LAUNCHES = Counts({"raygen": 0, "accumulate": 0})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tiled(height: int, width: int) -> bool:
    return height % TILE_H == 0 and width % TILE_W == 0


def _unpack(height: int, width: int):
    """`unpack(flat [N, C]) -> [height, width, C]` of the lane order."""
    if not _tiled(height, width):
        return lambda flat: flat.reshape(height, width, -1)
    ty, tx = height // TILE_H, width // TILE_W
    return lambda flat: (flat.reshape(ty, tx, TILE_H, TILE_W, -1)
                         .permute(0, 2, 1, 3, 4).reshape(height, width, -1))


def _pixel_coords(height: int, width: int, device):
    """(py, px, unpack): int64 pixel rows/cols per lane and
    `unpack(flat [N, C]) -> [height, width, C]`."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int64, device=device),
        torch.arange(width, dtype=torch.int64, device=device),
        indexing="ij")
    if not _tiled(height, width):
        return ys.reshape(-1), xs.reshape(-1), _unpack(height, width)
    ty, tx = height // TILE_H, width // TILE_W

    def tiled(a):
        return a.reshape(ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(-1)

    return tiled(ys), tiled(xs), _unpack(height, width)


# ---- the plain versions

def sample_rays_plain(lens: LensArrays, height: int, width: int,
                      sample_index, flip_image: bool, device, y0: int = 0,
                      band_h: int | None = None):
    """Camera rays and per-lane RNG for one sample (the raygen stage) of
    rows [y0, y0 + band_h), in the lane order of _pixel_coords;
    `sample_index` an int or an int64 device scalar. Returns (o, d, rng,
    unpack)."""
    bh = height if band_h is None else band_h
    py, px, unpack = _pixel_coords(bh, width, device)
    py = py + y0  # absolute pixel rows
    rng = R.seed(sample_index, px, py)
    rng, jitter = R.next_float2(rng)
    uv = pixel_uv(px, py, width, height, jitter, flip_image)
    rng, ap = R.next_float2(rng)
    o, d = generate_rays(lens, width, height, uv, ap)
    return o, d, rng, unpack


def raygen_plain(lens: LensArrays, sample, height: int, width: int,
                 y0: int, bh: int, nbatch: int, flip_image: bool,
                 trace) -> None:
    """The camera rays of `nbatch` samples from `sample` (an int64 device
    scalar) of rows [y0, y0 + bh), sample-major on the lane axis, into
    the first set of the trace's buffers (path._Trace `bufs[0]`: o, d,
    rng), then the trace's fresh state (`reset`)."""
    rays = [sample_rays_plain(lens, height, width, sample + s, flip_image,
                              sample.device, y0, bh)[:3]
            for s in range(nbatch)]
    st = trace.bufs[0]
    for k, parts in zip(("o", "d", "rng"), zip(*rays)):
        st[k].copy_(parts[0] if nbatch == 1 else torch.cat(parts))
    trace.reset()


class Tally(NamedTuple):
    """A frame's int64 device scalars that the accumulation adds to:
    rays += trace_rays, segments += bounce, sample += nbatch."""
    rays: torch.Tensor
    trace_rays: torch.Tensor
    segments: torch.Tensor
    bounce: torch.Tensor
    sample: torch.Tensor


def accumulate_plain(acc, radiance, pix, nbatch: int,
                     tally: Tally | None = None) -> None:
    """acc [bh, W, 4] (the 4th float unused) += a trace's radiance
    [nbatch * bh * W, 3] summed over its nbatch samples (sample-major),
    left to right; `pix` (the resort's, or None for lanes in their own
    order) the pixel lane of each lane. With a `tally`, its counts too."""
    if pix is not None:
        radiance = torch.empty_like(radiance).index_copy_(0, pix, radiance)
    parts = radiance.reshape(nbatch, -1, 3)
    total = parts[0]
    for b in range(1, nbatch):
        total = total + parts[b]
    acc[..., :3] += _unpack(acc.shape[0], acc.shape[1])(total)
    if tally is not None:
        tally.rays.add_(tally.trace_rays)
        tally.segments.add_(tally.bounce)
        tally.sample.add_(nbatch)


# ---- the wrappers

def _launch(key: str, fn, device, *args) -> None:
    rc = call_on(fn, device, *args)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    count_launch(LAUNCHES, key)


def _ptr(x, dtype):
    """x's device pointer for a kernel that reads or writes it: x must be
    contiguous, of `dtype`."""
    if x.dtype != dtype or not x.is_contiguous():
        raise TypeError(f"frame kernel argument of {x.dtype} (contiguous: "
                        f"{x.is_contiguous()}), wants a contiguous {dtype}")
    return x.data_ptr()


def _lens_ptrs(lens: LensArrays, device) -> list:
    for x in lens:
        if x.device != device:
            raise ValueError(f"the lens lies on {x.device}, the rays on "
                             f"{device}")
    return [_ptr(x, torch.float32) for x in lens]


def _aspect(width: int, height: int) -> float:
    return float(np.float32(width) / np.float32(height))


def _raygen_launch(lens, sample, height, width, y0, bh, nbatch, flip_image,
                   outs) -> None:
    dev = sample.device
    if sample.dtype != torch.int64 or sample.dim() != 0:
        raise TypeError("the sample index is an int64 device scalar")
    _launch("raygen", native.frame_lib().raygen, dev,
            *_lens_ptrs(lens, dev), sample.data_ptr(), height, width, y0,
            bh, nbatch, int(flip_image), _aspect(width, height), *outs)


def raygen(lens: LensArrays, sample, height: int, width: int, y0: int,
           bh: int, nbatch: int, flip_image: bool, trace) -> None:
    """raygen_plain's result: the csrc/frame.cu raygen kernel for CUDA
    tensors (one launch writes o, d and rng into the trace's first set of
    buffers and all that `reset` writes), the plain version for CPU
    tensors. The kernel reads the lens and `sample` on the device, so a
    replay of its graph sees new ones."""
    if sample.device.type == "cpu":
        return raygen_plain(lens, sample, height, width, y0, bh, nbatch,
                            flip_image, trace)
    st, f32 = trace.bufs[0], torch.float32
    if st["o"].shape[0] != nbatch * bh * width:
        raise ValueError("the trace's lanes are not nbatch * bh * width")
    _raygen_launch(lens, sample, height, width, y0, bh, nbatch, flip_image, (
        _ptr(st["o"], f32), _ptr(st["d"], f32), _ptr(st["rng"], torch.int64),
        _ptr(st["active"], torch.bool), _ptr(st["throughput"], f32),
        _ptr(st["radiance"], f32), _ptr(st["last_pdf"], f32),
        _ptr(st["last_delta"], torch.bool), _ptr(st["pix"], torch.int64),
        _ptr(st["rays"], torch.int64), _ptr(trace.bounce, torch.int64),
        _ptr(trace.widx, torch.int64), _ptr(trace.live, torch.int64)))


def sample_rays(lens: LensArrays, height: int, width: int, sample_index,
                flip_image: bool, device, y0: int = 0,
                band_h: int | None = None):
    """sample_rays_plain's result: on a CUDA device the raygen kernel into
    fresh tensors, else the plain version."""
    if torch.device(device).type == "cpu":
        return sample_rays_plain(lens, height, width, sample_index,
                                 flip_image, device, y0, band_h)
    bh = height if band_h is None else band_h
    n = bh * width
    sample = (sample_index if torch.is_tensor(sample_index)
              else torch.full((), int(sample_index), dtype=torch.int64,
                              device=device))
    o = torch.empty((n, 3), dtype=torch.float32, device=device)
    d = torch.empty_like(o)
    rng = torch.empty(n, dtype=torch.int64, device=device)
    _raygen_launch(lens, sample, height, width, y0, bh, 1, flip_image,
                   (o.data_ptr(), d.data_ptr(), rng.data_ptr())
                   + (None,) * 10)
    return o, d, rng, _unpack(bh, width)


def _accumulate_launch(acc, radiance, pix, nbatch: int, scratch,
                       tally: Tally | None) -> None:
    bh, width = acc.shape[0], acc.shape[1]
    if acc.shape != (bh, width, 4) or acc.data_ptr() % 16:
        raise ValueError(f"acc {tuple(acc.shape)} is not a 16-byte aligned "
                         f"[bh, W, 4]")
    if radiance.shape != (nbatch * bh * width, 3):
        raise ValueError(f"radiance {tuple(radiance.shape)} is not "
                         f"[nbatch * bh * width, 3]")
    i64 = torch.int64
    if tally is not None and any(x.device != acc.device for x in tally):
        raise ValueError("the tally lies on another device than acc")
    _launch("accumulate", native.frame_lib().accumulate, acc.device,
            _ptr(radiance, torch.float32),
            None if pix is None else _ptr(pix, i64), nbatch, bh, width,
            None if scratch is None else scratch.data_ptr(),
            _ptr(acc, torch.float32),
            *([None] * 5 if tally is None else [_ptr(x, i64) for x in tally]))


def accumulate(acc, radiance, pix, nbatch: int,
               tally: Tally | None = None) -> None:
    """accumulate_plain's result: the csrc/frame.cu accumulation for CUDA
    tensors (one launch, the tally's adds in it; with pix and nbatch > 1
    a scatter into pixel order first), the plain version for CPU
    tensors."""
    if acc.device.type == "cpu":
        return accumulate_plain(acc, radiance, pix, nbatch, tally)
    scratch = None
    if pix is not None and nbatch > 1:
        scratch = torch.empty((radiance.shape[0], 4), dtype=torch.float32,
                              device=acc.device)
    _accumulate_launch(acc, radiance, pix, nbatch, scratch, tally)
