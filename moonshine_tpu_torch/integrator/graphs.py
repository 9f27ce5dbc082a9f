"""CUDA graphs over the bounce loop: the port's counterpart of the
reference's one compiled program a sample (moonshine_tpu/render/
renderer.py:80-103, `render_sample` under one `jax.jit`) and of its staged
path's one donated dispatch a bounce (integrator/path.py:715-727).

A run shape (a scene, a lane count, a PathConfig, a frame's rows) owns
static buffers and a `Steps`. A step (a whole sample of the unrolled
form; or the camera rays, a block of the looped form's segments, the
accumulation) is a function that reads and writes those buffers in
place and reads nothing on the host. On a CUDA device a step
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
its count goes to the capture's tally (`launch.launch_tally`), which
each replay adds.

Device-side control (`cond`, `choose`, `loop`): the reference's
`lax.cond` and `while_loop` inside its compiled loop. Captured, a
branch is a CUDA graph conditional node (csrc/graph_cond.cu) on a device
predicate of one or two terms, each a 0-d tensor compared with a
constant: `cond` an IF node, `choose` one SWITCH node for all its
branches, each with one set kernel that evaluates the predicate; a
`loop` step's guard is an IF node set by the step before it (its tail
kernel counts the step and sets the next guard), so only a loop's first
guard has a set kernel. Bodies are recorded on a child stream; the host
reads nothing at a replay. A body may hold only kernels, memsets,
device-to-device copies and nested branches (CUDA's rule), and writes
only static buffers: a branch that did not run leaves them as they
were. Before a step with branches is captured, a throwaway capture in
the relaxed error mode runs every branch inline (nothing runs on the
device), so each is captured warm: its kernels built, its wrappers'
per-device caches filled. Bodies allocate from a pool of the run shape's
own (`torch.cuda.MemPool`), reused across its graphs as the graphs' pool
is. The set kernel (or the tail) adds one to the body's entry of a
device log when the body runs, and the body's launch tally is counted
from that log when the counts are read (launch.settle). Eagerly (the
CPU, `eager()`, a step's first run) a branch reads its predicate on the
host: COUNTS["conds"]. A card whose toolkit, runtime or driver has no
SWITCH nodes (CUDA < 12.8) raises: csrc/graph_cond.cu does not build,
or the first capture of a branch raises; the loop never falls back to
host reads.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref

import ctypes

import torch

from ..accel import launch, native

# run shapes kept (the least recently used goes first); each holds its
# static buffers and its graphs' memory pool
MAX_RUN_SHAPES = 8
# more shapes kept beside those: as many as the last sharded render's
# mesh has shards and scene copies (parallel/sharding.py, `keep_room`),
# so that mesh replays at its next call; 0 for a process without a mesh
_mesh_room = 0

# host-side tallies, for tools and tests to read: graph captures and
# replays (Steps), device reads of the bounce loop (path._Trace.live_count
# and the reads of its segment count), predicates of `cond` and `choose`
# read eagerly, and scene copies to another device (parallel/sharding.py
# `scene_on`)
COUNTS = {"captures": 0, "replays": 0, "reads": 0, "conds": 0,
          "copies": 0}
_COUNTS_LOCK = threading.Lock()
# the launches of csrc/graph_cond.cu's kernels each time the graph or body
# that holds them runs: the set kernel, one a conditional node that is not
# a loop's folded guard, and the loop's tail, one a step
LAUNCHES = launch.Counts({"graph_if": 0, "graph_tail": 0})

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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        self._graphs: dict = {}  # step key -> _Graph
        self._pool = None
        self._body_pool = None  # the conditional bodies' allocations
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
            hit.replay()

    def _capture(self, fn):
        before = _conds_read()
        fn()  # the warm-up: builds the kernels, and does this step's work
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        log = None
        if _conds_read() != before:  # the step branches on the device
            warm = _Capture(self, warm=True)
            with _capturing(warm), launch.launch_tally():
                with torch.cuda.graph(torch.cuda.CUDAGraph(), pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="relaxed"):
                    fn()
            log = torch.zeros(warm.bodies, dtype=torch.int64,
                              device=self.device)
            if self._body_pool is None:
                self._body_pool = torch.cuda.MemPool()
        graph, cap = torch.cuda.CUDAGraph(), _Capture(self, log=log)
        with _capturing(cap), launch.launch_tally() as tally:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                fn()
        count("captures")
        bodies = None if log is None else launch.Bodies(log,
                                                        cap.tallies)
        return _Graph(graph, tuple(tally), bodies)


class _Graph:
    """A captured step: its graph, its launch tally and its conditional
    bodies' (launch.Bodies, or None)."""

    def __init__(self, graph, tally, bodies):
        self.graph, self.tally, self.bodies = graph, tally, bodies

    def replay(self) -> None:
        self.graph.replay()
        launch.count_replay(self.tally)
        if self.bodies is not None:
            launch.count_bodies(self.bodies)
        count("replays")


def _conds_read() -> int:
    return getattr(_MODE, "conds", 0)


@contextlib.contextmanager
def _capturing(cap):
    _MODE.capture = cap
    try:
        yield
    finally:
        _MODE.capture = None


# a term's comparison: its code in csrc/graph_cond.cu, and eagerly
_OPS = {"==": (0, lambda x, v: x == v), ">": (1, lambda x, v: x > v),
        "<": (2, lambda x, v: x < v)}


def _read_choice(index):
    """The value of a branch's 0-d index, or of each of a tuple of them,
    read on the host (an eager branch's one read, counted in conds)."""
    _MODE.conds = _conds_read() + 1
    count("conds")
    if torch.is_tensor(index):
        return int(index.item())
    return tuple(int(t.item()) for t in index)


def _terms(pred):
    """A predicate as its terms: a 0-d bool tensor, or a tuple of one or
    two (t, op, value)."""
    return ((pred, "==", 1),) if torch.is_tensor(pred) else tuple(pred)


def _holds(terms) -> bool:
    """Whether every term holds, read on the host (an eager branch's one
    read)."""
    values = _read_choice(tuple(t for t, _, _ in terms))
    return all(_OPS[op][1](x, v) for x, (_, op, v) in zip(values, terms))


def cond(pred, fn) -> None:
    """fn() where `pred` holds, else nothing: the reference's lax.cond
    with an empty false branch. pred is a 0-d bool tensor or a tuple of
    one or two terms (t, op, value), t a 0-d int64 or bool tensor on the
    step's device, op "==", ">" or "<", all of which must hold (the
    module's docstring says how it is captured)."""
    terms = _terms(pred)
    cap = getattr(_MODE, "capture", None)
    if cap is not None:
        cap.branch(0, tuple((t, op) for t, op, _ in terms),
                   [tuple(v for _, _, v in terms)], [fn])
        return
    if _holds(terms):
        fn()


def choose(index, branches: dict) -> None:
    """branches[key]() for key the value of `index` (a 0-d int64 or bool
    tensor on the step's device, or a tuple of one or two, keyed by
    tuples), nothing where no key matches: a nested lax.cond's
    branches. Captured, one SWITCH node whose bodies are the branches in
    the dict's order; eagerly one read of the index."""
    cap = getattr(_MODE, "capture", None)
    if cap is not None:
        sels = (index,) if torch.is_tensor(index) else tuple(index)
        keys = [(key,) if torch.is_tensor(index) else tuple(key)
                for key in branches]
        cap.branch(1, tuple((t, "==") for t in sels),
                   [tuple(int(k) for k in key) for key in keys],
                   list(branches.values()))
        return
    fn = branches.get(_read_choice(index))
    if fn is not None:
        fn()


def loop(pred, fns, counter, advance, guard_first: bool = True) -> None:
    """The reference's while_loop over the steps `fns`: fns[i]() and then
    advance(), which adds one to `counter` (a 0-d int64 tensor), for each
    i in turn while `pred` (as cond's) holds; once it fails no later step
    runs. With guard_first False the first step runs unguarded. Eagerly
    each guard is read on the host. Captured, each guarded step is an IF
    node; a step ends with the tail kernel, which adds one to `counter`
    and sets the next step's guard from `pred`, so that only the first
    guard has a set kernel and a step that did not run leaves every later
    guard unset (0), and advance() is not called."""
    terms = _terms(pred)
    cap = getattr(_MODE, "capture", None)
    if cap is not None:
        cap.loop(terms, fns, counter, advance, guard_first)
        return
    for i, fn in enumerate(fns):
        # a step that did not run leaves the counter and the terms as they
        # were, so no later guard holds (the captured form's unset guards)
        if (i or guard_first) and not _holds(terms):
            continue
        fn()
        advance()


def _args(terms):
    """The ctypes arguments of up to two terms, each (t, op) or (t, op,
    value); an absent second term has a null tensor."""
    if not 1 <= len(terms) <= 2 or any(
            t.dtype not in (torch.bool, torch.int64) or t.dim()
            for t, *_ in terms):
        raise TypeError("a branch holds on one or two terms, each a 0-d "
                        "bool or int64 tensor")
    out = []
    for t, op, *value in terms + ((None, "==", 0),) * (2 - len(terms)):
        out.append(([None if t is None else t.data_ptr(),
                     1 if t is None else t.element_size(), _OPS[op][0]],
                    [int(v) for v in value]))
    return out


class _Capture:
    """What a capture records besides its graph: with `warm` (the
    throwaway relaxed capture) every branch runs inline and is counted in
    `bodies`; else each branch is a conditional node's body, b, which
    adds one to log[b] each time it runs (the node's set kernel, or the
    loop's tail before it, does) and has its own launch tally,
    tallies[b]."""

    def __init__(self, steps: Steps, warm: bool = False, log=None):
        self.steps, self.warm, self.log = steps, warm, log
        self.bodies, self.tallies, self.depth = 0, [], 0
        self._next = None  # the guard that the last loop tail set

    def _reserve(self, n: int = 1) -> int:
        """n consecutive body numbers: the first."""
        b = self.bodies
        self.bodies += n
        self.tallies += [()] * n
        return b

    def _log_at(self, b: int) -> int:
        return self.log.data_ptr() + b * self.log.element_size()

    def branch(self, kind: int, terms, cases, fns) -> None:
        """A conditional node (kind 0 IF, 1 SWITCH) on `terms`, each (t,
        op), whose body i runs fns[i]() where the terms hold against
        cases[i], the first such i."""
        b = self._reserve(len(fns))
        if self.warm:
            for fn in fns:
                fn()
            return
        lib = _cond_lib()
        (a, _), (bt, _) = _args(terms)
        values = [(ctypes.c_longlong * len(cases))(
            *(c[j] if j < len(terms) else 0 for c in cases))
            for j in range(2)]
        outer = torch.cuda.current_stream(self.steps.device)
        graphs = (ctypes.c_void_p * len(fns))()
        _check(lib, lib.cond_begin(outer.cuda_stream, kind, *a, *bt,
                                   *values, len(fns), self._log_at(b),
                                   graphs))
        launch.count_launch(LAUNCHES, "graph_if")  # the enclosing tally
        for i, fn in enumerate(fns):
            self._body(graphs[i], b + i, fn)

    def loop(self, terms, fns, counter, advance, guard_first) -> None:
        """graphs.loop's steps, captured: each guarded step an IF node,
        the first on a set kernel, each later one on the handle that the
        tail of the step before it sets."""
        if self.warm:
            for i, fn in enumerate(fns):
                if i or guard_first:
                    self._reserve()
                fn()
                advance()
            return
        if counter.dtype != torch.int64 or counter.dim():
            raise TypeError("a loop counts in a 0-d int64 tensor")
        lib = _cond_lib()
        dev = self.steps.device
        outer = torch.cuda.current_stream(dev)
        args = _args(terms)
        guard = None  # (handle, body number) that the last tail sets
        for i, fn in enumerate(fns):
            if not (i or guard_first):
                self._step(lib, outer, fn, counter, args, len(fns) > 1)
                guard = self._next
                continue
            step = (lambda fn=fn, then=i + 1 < len(fns): self._step(
                lib, outer, fn, counter, args, then))
            if guard is None:  # the loop's first guard: a set kernel
                self.branch(0, tuple((t, op) for t, op, _ in terms),
                            [tuple(v for _, _, v in terms)], [step])
            else:
                handle, b = guard
                body = ctypes.c_void_p()
                _check(lib, lib.if_on(outer.cuda_stream, handle,
                                      ctypes.byref(body)))
                self._body(body, b, step)
            guard = self._next

    def _step(self, lib, outer, fn, counter, args, then) -> None:
        """A loop step, fn() and its tail on the current stream; with
        `then` the tail also sets the next step's guard, a handle made
        now in the graph `outer` captures into, whose body number is
        reserved now (`_next`)."""
        fn()
        handle, b = ctypes.c_ulonglong(0), None
        if then:
            _check(lib, lib.guard(outer.cuda_stream, ctypes.byref(handle)))
            b = self._reserve()
        (a, av), (bt, bv) = args
        _check(lib, lib.tail(
            torch.cuda.current_stream(self.steps.device).cuda_stream,
            counter.data_ptr(), handle.value, int(then), *a, *av, *bt, *bv,
            None if b is None else self._log_at(b)))
        launch.count_launch(LAUNCHES, "graph_tail")
        self._next = (handle.value, b)

    def _body(self, graph, b: int, fn) -> None:
        """Body b, fn() captured into `graph` on this depth's child
        stream, with its own launch tally."""
        lib = _cond_lib()
        dev = self.steps.device
        child = _child_stream(dev, self.depth)
        pool = (torch.cuda.use_mem_pool(self.steps._body_pool, dev)
                if self.depth == 0 else contextlib.nullcontext())
        _check(lib, lib.body_begin(child.cuda_stream, graph))
        self.depth += 1
        try:
            with torch.cuda.stream(child), pool, \
                    launch.launch_tally() as tally:
                fn()
        finally:
            self.depth -= 1
            err = lib.body_end(child.cuda_stream)
        _check(lib, err)
        self.tallies[b] = tuple(tally)


_CHILDREN: dict = {}  # (device index, depth) -> the bodies' stream
_CHILDREN_LOCK = threading.Lock()


def _cond_lib():
    """csrc/graph_cond.cu's library; raises where the runtime or driver
    has no SWITCH nodes."""
    lib = native.graph_cond_lib()
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.versions(ctypes.byref(runtime), ctypes.byref(driver)))
    if min(runtime.value, driver.value) < 12080:
        raise RuntimeError(
            f"CUDA graph SWITCH nodes need CUDA 12.8: runtime "
            f"{runtime.value}, driver {driver.value}")
    return lib


def _child_stream(device, depth: int):
    """The stream that captures bodies at this nesting depth on device:
    made once, never the capture's own."""
    key = (device.index, depth)
    with _CHILDREN_LOCK:
        stream = _CHILDREN.get(key)
        if stream is None:
            lib, ptr = native.graph_cond_lib(), ctypes.c_void_p()
            with torch.cuda.device(device):
                _check(lib, lib.stream(ctypes.byref(ptr)))
            stream = torch.cuda.ExternalStream(ptr.value, device=device)
            _CHILDREN[key] = stream
    return stream


def _check(lib, err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA graph conditional node: {lib.error(err)}")


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
