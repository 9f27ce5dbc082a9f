"""How every wrapper of the port's kernels launches and counts: the C
entry points of native.py's libraries called on the tensors' card and its
current stream (`call_on`), and the per-kernel launch counts that show a
run went through the kernels (`count_launch`).

A wrapper adds one to its counts exactly where it launches; callers reset
them to 0. A wrapper called while its thread captures a CUDA graph
launches nothing: its count goes to the capture's tally (`launch_tally`),
which each replay of the graph adds (`count_replay`,
integrator/graphs.py). A conditional body of a graph (graphs.choose) has
a tally of its own and adds one to its entry of a device log each time
it runs; a replay marks the log (`count_bodies`), and the counts read it
only when a tool or test reads them (`Counts`, `settle`): the render
path never does.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# the Engine's pick launches from another thread while a frame does
# (engine/engine.py), so the counts add under a lock
_COUNT_LOCK = threading.Lock()
_CAPTURE = threading.local()


def call_on(fn, device, *args) -> int:
    """fn(*args, stream): a C entry point called with `device` made the
    thread's current CUDA device and given that device's current stream.
    The entry points launch on the calling thread's current device (and
    a null stream means that device's), so a caller on another card's
    tensors launches on the right one."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


# conditional bodies replayed since their logs were last read
_PENDING: dict = {}


def _add(counts: dict, key: str, n: int) -> None:
    # dict's own methods: a Counts would settle on every access
    dict.__setitem__(counts, key, dict.__getitem__(counts, key) + n)


def count_launch(counts: dict, key: str) -> None:
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:  # captured, not launched: counted at each replay
        tally.append((counts, key))
        return
    with _COUNT_LOCK:
        _add(counts, key, 1)


@contextlib.contextmanager
def launch_tally():
    """The launches that this thread's wrappers make inside the block, as
    a list of (counts, key), instead of counting them: for a CUDA graph
    capture, whose kernels launch only when it is replayed. Blocks nest:
    a conditional body's launches go to its own tally."""
    tally, outer = [], getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = outer


def count_replay(tally) -> None:
    """Add a captured graph's launches (its `launch_tally`) to the counts:
    one replay launches each of them once."""
    with _COUNT_LOCK:
        for counts, key in tally:
            _add(counts, key, 1)


class Bodies:
    """A graph's conditional bodies: each one's launch tally, and `log`,
    a device int64 tensor whose entry b the graph adds one to each time
    body b runs; `seen` is the log as last read."""

    def __init__(self, log, tallies):
        self.log, self.tallies = log, tallies
        self.seen = [0] * len(tallies)


def count_bodies(bodies: Bodies) -> None:
    """At a replay of a graph with conditional bodies: their launches are
    counted at the next read of the counts (`settle`), not now, since
    which ran is on the device."""
    with _COUNT_LOCK:
        _PENDING[id(bodies)] = bodies


def settle() -> None:
    """Add the launches of the conditional bodies that ran since the last
    settle: each replayed graph's log read (after its device finishes)
    against what was seen."""
    if not _PENDING:
        return
    with _COUNT_LOCK:
        pending = list(_PENDING.values())
        _PENDING.clear()
    for bodies in pending:
        torch.cuda.synchronize(bodies.log.device)
        ran = bodies.log.tolist()
        with _COUNT_LOCK:
            for tally, now, seen in zip(bodies.tallies, ran, bodies.seen):
                for counts, key in tally:
                    _add(counts, key, now - seen)
            bodies.seen = ran


class Counts(dict):
    """A module's launch counts by kernel: a dict that settles the
    conditional bodies' launches before it is read or reset, so every
    read sees the launches of every replay before it."""

    __hash__ = None

    def __getitem__(self, key):
        settle()
        return dict.__getitem__(self, key)

    def __setitem__(self, key, value):
        settle()
        dict.__setitem__(self, key, value)

    def __iter__(self):
        settle()
        return dict.__iter__(self)

    def __eq__(self, other):
        settle()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        settle()
        return dict.__ne__(self, other)

    def __repr__(self):
        settle()
        return dict.__repr__(self)

    def get(self, key, default=None):
        settle()
        return dict.get(self, key, default)

    def keys(self):
        settle()
        return dict.keys(self)

    def values(self):
        settle()
        return dict.values(self)

    def items(self):
        settle()
        return dict.items(self)

    def copy(self):
        settle()
        return dict(dict.items(self))
