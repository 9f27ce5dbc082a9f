"""How every wrapper of the port's kernels launches and counts: the C
entry points of native.py's libraries called on the tensors' card and its
current stream (`call_on`), and the per-kernel launch counts that show a
run went through the kernels (`count_launch`).

A wrapper adds one to its counts exactly where it launches; callers reset
them to 0. A wrapper called while its thread captures a CUDA graph
launches nothing: its count goes to the capture's tally (`launch_tally`),
which each replay of the graph adds (`count_replay`,
integrator/graphs.py).
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


def count_launch(counts: dict, key: str) -> None:
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:  # captured, not launched: counted at each replay
        tally.append((counts, key))
        return
    with _COUNT_LOCK:
        counts[key] += 1


@contextlib.contextmanager
def launch_tally():
    """The launches that this thread's wrappers make inside the block, as
    a list of (counts, key), instead of counting them: for a CUDA graph
    capture, whose kernels launch only when it is replayed."""
    tally = []
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def count_replay(tally) -> None:
    """Add a captured graph's launches (its `launch_tally`) to the counts:
    one replay launches each of them once."""
    with _COUNT_LOCK:
        for counts, key in tally:
            counts[key] += 1
