"""The trace arithmetic (portbench/trace.py) on a recorded synthetic
trace, and the readers that take their metrics from it."""

from __future__ import annotations

import pytest

from portbench import run as R
from portbench import trace as T
from portbench.readers import host_reads, idle, kernel_time


def _ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


# a traced window from 0 to 100 us: two traversal kernels that overlap,
# a shading kernel, a sort kernel, one kernel no pattern claims, a
# device-to-host copy and a fill; the host inside a unit range, a graph
# launch under way during the first long gap and a synchronise during
# the last
EVENTS = [
    _ev("kernel", "void msn::traverse_kernel<Rows, false>", 10, 20),
    _ev("kernel", "void msn::traverse_kernel<Rows, true>", 25, 10),
    _ev("kernel", "surface_kernel<0, false>", 50, 5),
    _ev("kernel", "lane_move_kernel(Table)", 56, 4),
    _ev("kernel", "raygen_kernel<false, true>", 61, 2),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 70, 1),
    _ev("gpu_memset", "memset32", 72, 3),
    _ev("user_annotation", "portbench.unit", 0, 100),
    _ev("cuda_runtime", "cudaGraphLaunch", 36, 13),
    _ev("cuda_runtime", "cudaStreamSynchronize", 76, 24),
    _ev("cpu_op", "aten::copy_", 65, 4),
]


def test_busy_time_is_the_union_of_device_operations():
    # [10, 35] + [50, 55] + [56, 60] + [61, 63] + [70, 71] + [72, 75]
    assert T.busy_us(EVENTS) == 25 + 5 + 4 + 2 + 1 + 3


def test_kernel_time_by_pattern_and_unclaimed():
    assert T.kernel_us(EVENTS, ["traverse_kernel"]) == 30
    assert T.kernel_us(EVENTS, ["surface_kernel", "scatter_kernel"]) == 5
    patterns = ["traverse_kernel", "surface_kernel", "lane_move_kernel"]
    assert T.unclaimed_us(EVENTS, patterns) == {
        "raygen_kernel<false, true>": 2}


def test_host_reads_and_top_ops():
    assert T.host_reads(EVENTS) == 1
    top = T.top_ops(EVENTS, n=2)
    assert top[0] == ["void msn::traverse_kernel<Rows, false>", 20e-6]
    assert top[1] == ["void msn::traverse_kernel<Rows, true>", 10e-6]


def test_idle_gaps_by_what_the_host_did():
    gaps = dict(T.idle_gaps(EVENTS, 0.0, 100.0))
    # [0, 10) inside the unit range only; [35, 50) under the graph launch;
    # [75, 100) under the synchronise; the 1 us gaps are launch latency
    assert gaps["portbench.unit"] == pytest.approx(10e-6)
    assert gaps["portbench.unit / cudaGraphLaunch"] == pytest.approx(15e-6)
    assert gaps["portbench.unit / cudaStreamSynchronize"] == \
        pytest.approx(25e-6)
    # 55-56, 60-61, 63-70 and 71-72: shorter than SHORT_GAP_US
    assert gaps[T.SHORT_GAP] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6 - T.busy_us(EVENTS)
                                               * 1e-6)


def test_readers_on_the_trace():
    run = R.Run()
    run.trace = R.Trace(EVENTS, units=2, samples=4, window_s=100e-6,
                        start_us=0.0, stop_us=100.0)
    spec = {"kernels": ["traverse_kernel"], "per": "sample"}
    assert kernel_time.read(spec, run) == pytest.approx(30e-3 / 4)
    assert kernel_time.read(dict(spec, per="unit"), run) == \
        pytest.approx(30e-3 / 2)
    # a metric whose kernels did not run reads nothing
    assert kernel_time.read({"kernels": ["tlas_kernel"], "per": "unit"},
                            run) is None
    assert idle.read({}, run) == pytest.approx(100 * (1 - 40 / 100))
    assert host_reads.read({"per": "sample"}, run) == 0.25
    run.trace = None
    assert kernel_time.read(spec, run) is None and idle.read({}, run) is None
