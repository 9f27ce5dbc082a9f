"""CUDA graphs over the bounce loop: the port's counterpart of the
reference's one compiled program a sample (moonshine_tpu/render/
renderer.py:80-103, `render_sample` under one `jax.jit`) and of its staged
path's one donated dispatch a bounce (integrator/path.py:715-727).

A run shape (a scene, a lane count, a PathConfig, a frame's rows) owns
static buffers and a `Steps`. A step (camera rays, one bounce segment,
the accumulation of a sample) is a function that reads and writes those
buffers in place and reads nothing on the host. On a CUDA device a step
runs eagerly at its first use (the warm-up: it builds the kernels and
does the step's work), is then captured as a `torch.cuda.CUDAGraph`, and
is replayed from then on. All the graphs of one run shape share one
memory pool: a step leaves its results in the static buffers and nothing
else live, so its temporaries die inside its graph and replays in any
order cannot hand one graph's live output to another.

Captures use the thread-local error mode, so work that another thread
issues on its own stream meanwhile (the Engine's pick) is neither
captured nor an error. A failed capture or replay raises; there is no
eager fallback. On the CPU, and inside `eager()` (as under
`jax.disable_jit`), steps run eagerly.

Run shapes are cached by key (`run_shape`), the scene's part of it its
`fingerprint`: every tensor's address and layout and every other value,
so a scene whose tensors were replaced (a World edit) gets new graphs,
and a graph replays only on tensors at the addresses it captured. A
shape goes when one of its scene's tensors is freed, or when
MAX_RUN_SHAPES newer ones (and as many as the last sharded render's mesh
needs, `keep_room`) push it out.

Launch counts: a wrapper called during a capture launches nothing, so
its count goes to the capture's tally (`packet.launch_tally`), which
each replay adds.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref

import torch

from ..accel import packet

# run shapes kept (the least recently used goes first); each holds its
# static buffers and its graphs' memory pool
MAX_RUN_SHAPES = 8
# more shapes kept beside those: as many as the last sharded render's
# mesh has shards and scene copies (parallel/sharding.py, `keep_room`),
# so that mesh replays at its next call; 0 for a process without a mesh
_mesh_room = 0

# host-side tallies, for tools and tests to read: graph captures and
# replays (Steps), live-count reads (path._Trace.live_count) and scene
# copies to another device (parallel/sharding.py `scene_on`)
COUNTS = {"captures": 0, "replays": 0, "reads": 0, "copies": 0}
_COUNTS_LOCK = threading.Lock()

_MODE = threading.local()
# key -> (run shape, finalizers that drop it with its scene's tensors)
_SHAPES: collections.OrderedDict = collections.OrderedDict()
# reentrant: a finalizer may run (and drop a shape) while the lock is held
_SHAPES_LOCK = threading.RLock()


def count(key: str) -> None:
    with _COUNTS_LOCK:
        COUNTS[key] += 1


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for k in COUNTS:
            COUNTS[k] = 0


@contextlib.contextmanager
def eager():
    """Run every step inside the block eagerly, capturing and replaying
    nothing (this thread only): the loop the graphs are held against."""
    before = getattr(_MODE, "eager", False)
    _MODE.eager = True
    try:
        yield
    finally:
        _MODE.eager = before


class Steps:
    """The steps of one run shape on `device`: captured at first use and
    replayed when `capture` (a CUDA device whose traversal is a kernel),
    else run eagerly."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._graphs: dict = {}  # step key -> (CUDAGraph, launch tally)
        self._pool = None
        self._stream = None

    def run(self, key, fn) -> None:
        """fn(), the step `key`: its graph replayed, or captured now."""
        if not self.capture or getattr(_MODE, "eager", False):
            fn()
            return
        with torch.cuda.device(self.device):
            hit = self._graphs.get(key)
            if hit is None:
                self._graphs[key] = self._capture(fn)
                return
            graph, tally = hit
            graph.replay()
            packet.count_replay(tally)
            count("replays")

    def _capture(self, fn):
        fn()  # the warm-up: builds the kernels, and does this step's work
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with packet.launch_tally() as tally:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                fn()
        count("captures")
        return graph, tuple(tally)


def fingerprint(x):
    """A hashable key of what a captured step may read from x (a scene:
    NamedTuples of tensors and Python values): each tensor's address,
    layout, type and device, and every other value."""
    if torch.is_tensor(x):
        return ("tensor", str(x.device), str(x.dtype), tuple(x.shape),
                x.stride(), x.data_ptr())
    if x is None or isinstance(x, (bool, int, float)):
        return (type(x).__name__, x)
    if isinstance(x, tuple):
        return (type(x).__name__, *(fingerprint(v) for v in x))
    raise TypeError(f"no fingerprint for {type(x).__name__}")


def _tensors(x):
    """The tensors in x (NamedTuples and tuples walked)."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


def run_shape(key, make, scene=None):
    """The cached run shape for `key`, made by make() on a miss. With
    `scene`, the shape is dropped as soon as one of the scene's tensors
    is freed (an edit replaced it): its graphs could not replay on that
    scene again, so their pool and buffers go then, not at eviction."""
    with _SHAPES_LOCK:
        hit = _SHAPES.get(key)
        if hit is not None:
            _SHAPES.move_to_end(key)
            return hit[0]
    shape = make()
    watch = ([] if scene is None else
             [weakref.finalize(t, _drop, key) for t in _tensors(scene)])
    with _SHAPES_LOCK:
        hit = _SHAPES.get(key)
        if hit is not None:  # another thread made it meanwhile
            _detach(watch)
            return hit[0]
        _SHAPES[key] = (shape, watch)
        while len(_SHAPES) > MAX_RUN_SHAPES + _mesh_room:
            _detach(_SHAPES.popitem(last=False)[1][1])
    return shape


def keep_room(n: int) -> None:
    """Keep n run shapes beyond MAX_RUN_SHAPES: a sharded render's shards
    and scene copies, set at each call to its mesh's, so that a mesh's
    shapes outlast the single-device ones made between its calls."""
    global _mesh_room
    with _SHAPES_LOCK:
        _mesh_room = n


def _detach(watch) -> None:
    for f in watch:
        f.detach()


def _drop(key) -> None:
    with _SHAPES_LOCK:
        hit = _SHAPES.pop(key, None)
    if hit is not None:
        _detach(hit[1])


def clear() -> None:
    """Drop every cached run shape, its buffers and its graphs, and the
    room kept for a mesh's."""
    global _mesh_room
    with _SHAPES_LOCK:
        for _, watch in _SHAPES.values():
            _detach(watch)
        _SHAPES.clear()
        _mesh_room = 0
