"""Rendering over a 2D device mesh (port of
moonshine_tpu/parallel/sharding.py).

One process drives every device, as the reference's single-controller
JAX does. The mesh is (sp, dp):

  * "dp" — pixel-row bands: each shard traces its own block of rows;
  * "sp" — sample ranges: shards trace disjoint sample indices of the
    same rows, and the partial sums are added in sp order, then divided
    by spp (the reference's psum).

RNG streams are keyed by (global sample index, x, y), so any (sp, dp)
factorization gives the single-device image up to f32 summation order.
A shard runs on its own device with its own copy of the scene, with that
device made current (the kernels launch on the current device). The
shards run one after another in the calling thread: the bounce loop is
bound by the host's dispatch of small kernels, and a thread a shard
made four cards 6x slower than the same shards in turn (the threads
contend for the GIL at every torch call; PERF.md, section 6). On a card
a shard's samples are graph replays (integrator/graphs.py), captured
per shard under its device; a scene copied to another card at each
call has new addresses, so that card's graphs are captured anew.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace

import numpy as np
import torch

from ..integrator.path import PathConfig
from ..render.camera import LensArrays
from ..render.renderer import MAX_LANES, _sample_sum

# "auto" and "SP,DP" specs on the CPU draw from this many entries of the
# one CPU device: the size of the reference's CPU test mesh (8 virtual
# host devices)
CPU_DEVICES = 8


class Mesh:
    """An (sp, dp) array of torch devices; a device may repeat."""

    axis_names = ("sp", "dp")

    def __init__(self, devices):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = arr
        self.shape = {"sp": arr.shape[0], "dp": arr.shape[1]}

    def __repr__(self):
        return f"Mesh(sp={self.shape['sp']}, dp={self.shape['dp']})"


def visible_devices(device="cuda") -> list:
    """The devices a spec draws from: every visible CUDA device for
    "cuda", CPU_DEVICES entries of the CPU for "cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)] * CPU_DEVICES


def make_mesh(devices=None, sp: int | None = None) -> Mesh:
    """Factor the devices (default: the visible CUDA devices) into a
    (sp, dp) mesh; sp defaults to 2 when the count is even, else 1."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("no devices for a mesh")
    if sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // sp
    flat = devices[:sp * dp]
    return Mesh([flat[i * dp:(i + 1) * dp] for i in range(sp)])


def mesh_from_spec(spec: str, device="cuda") -> Mesh:
    """Mesh from a CLI-style spec: "auto" (every device `visible_devices`
    gives, sp=2 when even) or "SP,DP" (e.g. "2,4"), which raises past the
    device count."""
    devices = visible_devices(device)
    if spec == "auto":
        return make_mesh(devices)
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be 'auto' or 'SP,DP', got {spec!r}")
    sp, dp = int(parts[0]), int(parts[1])
    if sp * dp > len(devices):
        raise ValueError(
            f"mesh {sp}x{dp} needs {sp * dp} devices, have {len(devices)}")
    return make_mesh(devices[:sp * dp], sp=sp)


def _moved(x, device):
    """x with every tensor in it (NamedTuples, nested) on `device`; the
    tensors already there are x's own."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, device) for v in x))
    return x


def _current(device):
    """`device` made the thread's current CUDA device for the block (a
    CPU device needs nothing)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard(scene, lens, height, width, rows, row0, start, count, cfg,
           staged, flip_image):
    """Radiance summed over `count` samples from `start` on for rows
    [row0, row0 + rows), and the rays traced, on the device where `scene`
    and `lens` are: one sample at a time through trace_paths' form, or
    trace_paths_staged's (renderer._sample_sum, graph replays on a card)."""
    acc, rays, _ = _sample_sum(scene, lens, height, width, start, count, cfg,
                               flip_image, y0=row0, band_h=rows,
                               staged=staged)
    return acc, rays


def render_sharded(scene, lens: LensArrays, height: int, width: int,
                   spp: int, cfg: PathConfig, mesh: Mesh,
                   flip_image: bool = True, base_sample: int = 0,
                   staged: bool | None = None):
    """Render spp samples over the mesh; returns ([H, W, 3] mean image,
    rays traced as an int64 scalar), both on the scene's device.
    height % dp == 0 and spp % sp == 0 are required.

    staged: each shard traces with trace_paths_staged instead of
    trace_paths; by default when a shard's band exceeds
    renderer.MAX_LANES pixels, the single-device renderer's switch. Deep
    bounce budgets (max_bounces + 2 > 10) keep the looped trace_paths,
    which stops when no lane is live, as the reference does."""
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    if height % dp or spp % sp:
        raise ValueError(
            f"height ({height}) must divide by dp ({dp}) and "
            f"spp ({spp}) by sp ({sp})")
    rows = height // dp
    local_spp = spp // sp
    if staged is None:
        staged = rows * width > MAX_LANES
    if staged and cfg.max_bounces + 2 > 10:
        staged = False
        cfg = replace(cfg, unroll=False)
    jobs = [(si, di) for si in range(sp) for di in range(dp)]
    # the scene and lens on each device of the mesh, copied once a call
    copies = {dev: (_moved(scene, dev), _moved(lens, dev))
              for dev in {mesh.devices[j] for j in jobs}}

    def run(job):
        si, di = job
        start = base_sample + si * local_spp
        dev = mesh.devices[si, di]
        with _current(dev):
            return _shard(*copies[dev], height, width, rows, di * rows,
                          start, local_spp, cfg, staged, flip_image)

    parts = {j: run(j) for j in jobs}
    out = scene.device
    bands = []
    for di in range(dp):
        acc = parts[(0, di)][0].to(out)
        for si in range(1, sp):
            acc = acc + parts[(si, di)][0].to(out)
        bands.append(acc / spp)
    rays = sum(p[1].to(out) for p in parts.values())
    return torch.cat(bands, dim=0), rays
