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

One thread steps every shard together, as the reference's one program
runs every device at once. A shard is a resumable frame
(render/renderer.py `_Frame.run`) on its own device, run under that
device and on a CUDA stream that no other shard of its card uses
(`_stream`). In rounds, each live shard enqueues its next segment (graph
replays on a card) and the copy of its live count to the host; then the
thread waits on each copy and feeds the count back. So no card waits for another's host read, and the
shards on one card overlap. A shard whose loop ends leaves the rounds.
There is no thread a shard: that made four cards 6x slower, the threads
contending for the GIL at every torch call of the eager loop (PERF.md,
section 6). A step, capture or replay that fails raises from render_sharded.

Another device's copy of the scene is cached by the scene's fingerprint
(integrator/graphs.py), and each shard's run shape by its slot, so the
next call on the same scene and mesh copies nothing and only replays;
an edit that replaces a scene tensor drops the copy and its graphs.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from dataclasses import replace

import numpy as np
import torch

from ..integrator import graphs
from ..integrator.path import PathConfig
from ..render.camera import LensArrays
from ..render.renderer import MAX_LANES, _frame

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
            arr[idx] = _indexed(devices[idx[0]][idx[1]])
        self.devices = arr
        self.shape = {"sp": arr.shape[0], "dp": arr.shape[1]}

    def __repr__(self):
        return f"Mesh(sp={self.shape['sp']}, dp={self.shape['dp']})"


def _indexed(device) -> torch.device:
    """The device, a CUDA one without an index given the current one's
    (so "cuda" is the same device as the scene's "cuda:0")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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


def scene_on(scene, device):
    """The scene on `device`: the scene itself there, else its copy, made
    at the first call and cached by (the scene's fingerprint, device)
    until a tensor of the scene is freed (an edit replaced it) or newer
    run shapes push it out (graphs.run_shape)."""
    if device == scene.device:
        return scene

    def copy():
        graphs.count("copies")
        return _moved(scene, device)

    key = ("copy", graphs.fingerprint(scene), str(device))
    return graphs.run_shape(key, copy, scene)


# each card's streams for the shards on it, the k-th shard of a call on
# the k-th stream: drawn once and kept, so a mesh's shards run on the
# same streams at every call
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()
# torch hands out streams round-robin from a pool of this many a device
# and priority, so as many draws meet every stream in it
_POOL_DRAWS = 32


def _stream(device, k: int):
    """The k-th of `device`'s streams for shards, each distinct from the
    others: two shards on one stream would run one after the other."""
    with _STREAMS_LOCK:
        have = _STREAMS.setdefault(device, [])
        for _ in range(_POOL_DRAWS):
            if len(have) > k:
                break
            stream = torch.cuda.Stream(device)
            if all(stream.cuda_stream != s.cuda_stream for s in have):
                have.append(stream)
        if len(have) > k:
            return have[k]
    raise RuntimeError(f"{k + 1} shards on {device}: more than the "
                       f"{len(have)} distinct streams torch gives a device")


@contextlib.contextmanager
def _current(device, stream=None):
    """`device` made the thread's current CUDA device for the block, and
    `stream` (one of that device's, if given) its current stream; a CPU
    device needs nothing."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _step_together(shards) -> list:
    """Run the shards ((device, stream, a frame's resumable run), each)
    to their ends in rounds: each live shard's next step enqueued under
    its device and stream, then each one's live count read and sent
    back. Returns each shard's value in order. A shard that raises
    raises here, and the others are closed, which releases their
    frames' locks."""
    out = [None] * len(shards)
    counts = dict.fromkeys(range(len(shards)))  # live shard -> its count
    try:
        while counts:
            waiting = {}
            for j, count in counts.items():
                device, stream, steps = shards[j]
                with _current(device, stream):
                    try:
                        waiting[j] = steps.send(count)
                    except StopIteration as done:
                        out[j] = done.value
            counts = {j: trace.live_count() for j, trace in waiting.items()}
    finally:
        for _, _, steps in shards:
            steps.close()
    return out


def _plan(height: int, width: int, spp: int, cfg: PathConfig, mesh: Mesh,
          staged: bool | None):
    """(rows a band, samples a shard, staged, cfg) of a sharded render;
    raises unless dp divides the height and sp the samples."""
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    if height % dp or spp % sp:
        raise ValueError(
            f"height ({height}) must divide by dp ({dp}) and "
            f"spp ({spp}) by sp ({sp})")
    rows = height // dp
    if staged is None:
        staged = rows * width > MAX_LANES
    if staged and cfg.max_bounces + 2 > 10:
        staged = False
        cfg = replace(cfg, unroll=False)
    return rows, spp // sp, staged, cfg


def _compose(parts: dict, mesh: Mesh, spp: int, out):
    """The mean image and the rays on `out` from each shard's (radiance
    sum, rays), keyed (si, di): the sp partials of a band added in sp
    order (the reference's psum), divided by spp, the bands stacked."""
    bands = []
    for di in range(mesh.shape["dp"]):
        acc = parts[(0, di)][0].to(out)
        for si in range(1, mesh.shape["sp"]):
            acc = acc + parts[(si, di)][0].to(out)
        bands.append(acc / spp)
    rays = sum(p[1].to(out) for p in parts.values())
    return torch.cat(bands, dim=0), rays


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
    rows, local_spp, staged, cfg = _plan(height, width, spp, cfg, mesh,
                                         staged)
    out = scene.device
    jobs = [(si, di) for si in range(mesh.shape["sp"])
            for di in range(mesh.shape["dp"])]
    devices = [mesh.devices[j] for j in jobs]
    # room in the run-shape cache for a frame a shard and a scene copy a
    # card besides the scene's
    graphs.keep_room(len(jobs) + len(set(devices) - {out}))
    shards, on_card = [], collections.Counter()
    for (si, di), dev in zip(jobs, devices):  # the frames' locks' order
        stream = None
        if dev.type == "cuda":
            stream = _stream(dev, on_card[dev])
            on_card[dev] += 1
        with _current(dev):
            copy = scene_on(scene, dev)
            frame = _frame(copy, lens, cfg, height, width, di * rows, rows,
                           1, flip_image, staged, slot=(si, di))
            for src in {dev, out}:  # after the copy, the scene, the lens
                if stream is not None and src.type == "cuda":
                    stream.wait_stream(torch.cuda.current_stream(src))
        shards.append((dev, stream, frame.run(
            copy, lens, base_sample + si * local_spp, local_spp)))
    parts = dict(zip(jobs, _step_together(shards)))
    for (dev, stream, _), (acc, rays, _) in zip(shards, parts.values()):
        if stream is not None:  # read next on the device's current stream
            here = torch.cuda.current_stream(dev)
            here.wait_stream(stream)
            acc.record_stream(here)
            rays.record_stream(here)
    return _compose(parts, mesh, spp, out)
