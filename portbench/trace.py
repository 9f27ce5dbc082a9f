"""The trace arithmetic: what a torch.profiler trace of the window says.

Copied in its method from moonshine_tpu_torch/render/profile_frame.py at
commit 747dbd6 (`_trace_events`, `_merged`, `_union_us`, `_host_ops`):
the device's busy time is the union of the intervals of its operations
(kernels, copies and fills, those inside CUDA graph replays too), kernel
time is summed by name, and the host's reads are the device-to-host
copies. Added here: sums by kernel-name pattern, the kernels no pattern
claims, the device operations that took longest, and the idle time
between device operations by what the host was doing then.

Every function takes the trace as the list of its Chrome-trace events
(`events_of`), so that the tests can hand it a recorded synthetic one.
Times in the events are microseconds.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# an idle gap shorter than this is the launch latency between two
# device operations, not host work holding the device back
SHORT_GAP_US = 10.0
SHORT_GAP = "between device ops (< 10 us)"


def events_of(prof) -> list[dict]:
    """The Chrome-trace events of a finished torch.profiler profile,
    exported into a temporary directory under TMPDIR and read back."""
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_ops(events) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def kernels(events) -> list[dict]:
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def merged(spans) -> list:
    """The union of (start, stop) spans as disjoint sorted spans."""
    out = []
    for start, stop in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def busy_us(events) -> float:
    """The time in which some device operation ran: the union of their
    intervals."""
    return sum(b - a for a, b in merged(
        (e["ts"], e["ts"] + e["dur"]) for e in device_ops(events)))


def by_name_us(ops) -> dict:
    out: dict = {}
    for e in ops:
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return out


def matches(name: str, patterns) -> bool:
    return any(re.search(p, name) for p in patterns)


def kernel_us(events, patterns) -> float:
    """The summed time of the kernels whose name matches a pattern."""
    return sum(e["dur"] for e in kernels(events)
               if matches(e["name"], patterns))


def unclaimed_us(events, patterns) -> dict:
    """Kernel time by name of the kernels that no pattern matches."""
    return by_name_us(e for e in kernels(events)
                      if not matches(e["name"], patterns))


def host_reads(events) -> int:
    """The device-to-host copies in the trace."""
    return sum(1 for e in device_ops(events)
               if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""))


def top_ops(events, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time,
    summed by name."""
    totals = by_name_us(device_ops(events))
    return [[k, v / 1e6] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _host_events(events) -> list[dict]:
    return [e for e in events if "dur" in e and e.get("cat") in (
        "cpu_op", "user_annotation", "cuda_runtime", "python_function")]


def idle_gaps(events, start_us: float, stop_us: float,
              n: int = 10) -> list:
    """[[label, seconds]]: the device's idle time in [start_us,
    stop_us] (the gaps between the merged intervals of its operations,
    and before the first and after the last), summed by what the host
    was doing at each gap's middle: the innermost host range covering it
    and the CUDA runtime call under way, if any. Gaps shorter than
    SHORT_GAP_US count under one label of their own. The n labels with
    most idle time, most first."""
    busy = merged((e["ts"], e["ts"] + e["dur"]) for e in device_ops(events))
    gaps, last = [], start_us
    for a, b in busy:
        if a > last:
            gaps.append((last, min(a, stop_us)))
        last = max(last, b)
        if last >= stop_us:
            break
    if last < stop_us:
        gaps.append((last, stop_us))
    gaps = [(a, b) for a, b in gaps if b > a]
    host = sorted(_host_events(events), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    totals: dict = {}
    # sweep the gaps by their middle, keeping the host events that cover it
    active: list = []  # heap of (end, start, index)
    nxt = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        if b - a < SHORT_GAP_US:
            totals[SHORT_GAP] = totals.get(SHORT_GAP, 0.0) + (b - a)
            continue
        mid = (a + b) / 2
        hi = bisect.bisect_right(starts, mid)
        while nxt < hi:
            e = host[nxt]
            heapq.heappush(active, (e["ts"] + e["dur"], e["ts"], nxt))
            nxt += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        runtime = [host[i] for _, _, i in active
                   if host[i].get("cat") == "cuda_runtime"]
        ranges = [host[i] for _, _, i in active
                  if host[i].get("cat") != "cuda_runtime"]
        parts = []
        if ranges:
            parts.append(max(ranges, key=lambda e: e["ts"])["name"])
        if runtime:
            parts.append(max(runtime, key=lambda e: e["ts"])["name"])
        label = " / ".join(parts) or "host (no traced range)"
        totals[label] = totals.get(label, 0.0) + (b - a)
    return [[k, v / 1e6] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
