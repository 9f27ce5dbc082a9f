"""portbench: the benchmark of moonshine_tpu_torch, one cell run once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>
    python -m portbench.run ...   (the same)

Reads BENCHMARK.json at the root of the checkout and the files its cell
names, all found by name: the configuration (portbench/configs/), the
traffic mix (portbench/traffic/) with its scene maker
(portbench/scenes/<scene>.py), the frontend driver
(portbench/frontends/<frontend>.py) and each metric's file
(portbench/metrics/<metric>.json) with its reader
(portbench/readers/<reader>.py). Then:

1. set-up: the scene from the seed, entered and built through the
   frontend, and one unit of work (an image or a frame) run to warm up
   every graph and kernel the window uses (`first_frame_s`);
2. the window: units back to back, closed-loop, for at least `--seconds`
   and until the end of the unit that passes it, each timed on the host
   clock to the end of its work on the device; with `--trace 1` the
   first `trace_units` of them under torch.profiler;
3. the device's peak memory, then the program's state freed and the
   window's images judged against the plain reference
   (portbench/reference) at a sample of pixels drawn from the seed;
4. the check's numbers, each with its limit, as the last lines on
   standard error, and as the last line on standard output one JSON
   object: correct, attempted, failed, metrics (the cell's end-to-end
   metrics, or with --trace 1 its per-layer ones), device, with --trace 1
   a breakdown, and last the check's numbers.

It exits with another code than 0 and prints no result where the card
is missing or the cell asks for more cards than there are, and where
JAX or the JAX package is loaded once the window has closed. Inputs are
written under TMPDIR; the program's kernels build into build/ in the
checkout, and the CUDA and Triton caches are set to fixed directories
under build/portbench/.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import pathlib
import sys
import tempfile
import time
from typing import NamedTuple

_T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__" and str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # run as a script: find the packages

FORBIDDEN = ("jax", "jaxlib", "flax", "moonshine_tpu")


class Trace(NamedTuple):
    """The traced part of the window: its Chrome-trace events, the units
    and samples it holds, its host-clock length and its span in the
    trace's clock (us)."""

    events: list
    units: int
    samples: int
    window_s: float
    start_us: float
    stop_us: float


class Run:
    """What a run recorded, for the metric readers (portbench/readers)."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.units = 0
        self.samples = 0
        self.unit_s: list = []
        self.spans: dict = {}
        self.calls: dict = {}
        self.traced_units = 0
        self.trace: Trace | None = None


def process_age() -> float:
    """Seconds since this process started (its start time from /proc;
    the time this module was imported where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def set_cache_dirs(root: pathlib.Path) -> None:
    """Fixed cache directories inside the checkout for every kernel cache
    a library may keep (the program's own nvcc builds go to build/)."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: pathlib.Path, bench: dict, workload: str):
    """(cell, config, traffic) of a workload, found by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, per_layer: bool) -> list:
    """The cell's end-to-end metrics, or its per-layer ones: those whose
    `workloads` names it, or without that key every cell that reports
    the end-to-end metric a per-layer one moves."""
    ends = [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]
    if not per_layer:
        return ends
    names = {m["name"] for m in ends}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_spec(root: pathlib.Path, name: str) -> dict:
    return load_json(root / "portbench" / "metrics" / f"{name}.json")


def read_metric(spec: dict, run: Run):
    reader = importlib.import_module(f"portbench.readers.{spec['reader']}")
    return reader.read(spec, run)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(driver, seconds: float, trace_units: int, device, run: Run):
    """Units back to back until `seconds` have passed (and, tracing,
    until `trace_units` of them ran under the profiler); fills run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule

    from portbench import trace as T

    cuda = torch.device(device).type == "cuda"
    prof, traced = None, []
    if trace_units:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=lambda p: traced.append(T.events_of(p)))
        prof.__enter__()
        # a step with a device operation before the recorded one: a
        # profiler started cold can lose the first launches' records
        torch.ones(1, device=device).add_(1)
        _synchronize(device)
        prof.step()
    window = None
    gc.collect()
    gc.disable()  # no collection pauses inside the window
    t_w0 = time.perf_counter()
    run.setup_s = process_age()
    t_trace = t_w0
    n = 0
    while True:
        if prof is not None and n == 0:
            window = record_function("portbench.window")
            window.__enter__()
            t_trace = time.perf_counter()
        t0 = time.perf_counter()
        if prof is not None and n < trace_units:
            with record_function("portbench.unit"):
                driver.unit()
        else:
            driver.unit()
        t1 = time.perf_counter()
        run.unit_s.append(t1 - t0)
        n += 1
        if prof is not None and n == trace_units:
            window.__exit__(None, None, None)
            traced_s = t1 - t_trace
            prof.step()
            prof.__exit__(None, None, None)
            prof = None
        if t1 - t_w0 >= seconds and n >= trace_units:
            break
    gc.enable()
    run.window_s = t1 - t_w0
    run.units = n
    run.samples = n * driver.samples_per_unit
    run.calls = dict(driver.calls)
    if trace_units:
        events = traced[0]
        span = [e for e in events if e.get("name") == "portbench.window"
                and "dur" in e]
        start, stop = ((span[0]["ts"], span[0]["ts"] + span[0]["dur"])
                       if span else (0.0, traced_s * 1e6))
        run.traced_units = trace_units
        run.trace = Trace(events, trace_units,
                          trace_units * driver.samples_per_unit, traced_s,
                          start, stop)


def run_cell(root: pathlib.Path, bench: dict, workload: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             log=print) -> tuple[dict, list]:
    """One run of a cell on `device`: (the result object, the check's
    lines). `log` takes the lines printed on standard error before them."""
    import torch

    from portbench import trace as T
    from portbench.reference import check as C

    cell, config, traffic = cell_files(root, bench, workload)
    frontend = importlib.import_module(
        f"portbench.frontends.{config['frontend']}")
    scene = importlib.import_module(f"portbench.scenes.{traffic['scene']}")
    run = Run()
    run.spans["start_s"] = process_age()
    t = time.perf_counter()
    desc = scene.make(seed, **traffic["scene_args"])
    run.spans["scene_s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        driver = frontend.setup(desc, config, work, device, run.spans)
    t = time.perf_counter()
    driver.unit()  # the warm-up unit: every graph captured, every kernel
    run.spans["first_frame_s"] = time.perf_counter() - t
    driver.forget()
    _window(driver, seconds, config["trace_units"] if trace else 0, device,
            run)

    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    outputs = driver.outputs()
    spu = driver.samples_per_unit
    driver.close()
    del driver
    C.free_device()

    # the check: the window's images against the reference
    images, held = outputs["images"], outputs["held"]
    per_unit = len(images) == run.units
    expected = spu if per_unit else run.units * spu
    flat_ids = C.sample_pixels(seed, config["height"], config["width"],
                               config["check"]["pixels"])
    t = time.perf_counter()
    ref = C.reference_values(desc, config, flat_ids, expected, device,
                             phases=run.spans)
    ref_s = time.perf_counter() - t
    numbers, failed = C.judge(images, expected,
                              max(held, key=lambda h: abs(h - expected),
                                  default=0),
                              ref, flat_ids, config["check"]["limits"])
    ok = C.correct(numbers)
    if not per_unit and not ok:
        failed = run.units

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = read_metric(metric_spec(root, m["name"]), run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": run.units, "failed": failed,
              "metrics": metrics, "device": dev}
    log(f"portbench: {workload} seed {seed}: set-up {run.setup_s:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in run.spans.items())}), "
        f"window {run.window_s:.3f} s, {run.units} units (s: min "
        f"{min(run.unit_s):.4f}, median {sorted(run.unit_s)[run.units // 2]:.4f}, "
        f"max {max(run.unit_s):.4f}), reference "
        f"{ref_s:.3f} s over {len(flat_ids)} pixels x {expected} samples")
    if run.trace is not None:
        tr = run.trace
        dev["busy_s"] = T.busy_us(tr.events) / 1e6
        dev["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": T.top_ops(tr.events),
            "idle_gaps": T.idle_gaps(tr.events, tr.start_us, tr.stop_us)}
        patterns = [p for m in cell_metrics(bench, workload, True)
                    for p in metric_spec(root, m["name"]).get("kernels", [])]
        unclaimed = T.unclaimed_us(tr.events, patterns)
        log("portbench: kernels no metric claims (ms over "
            f"{tr.units} traced units): " + ", ".join(
                f"{k} {v / 1e3:.4f}" for k, v in
                sorted(unclaimed.items(), key=lambda kv: -kv[1])))
    lines = [f"check {k} {v!r} limit {lim!r}"
             for k, (v, lim) in numbers.items()]
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return result, lines


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs(ROOT)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_files(ROOT, bench, args.workload)
    age = process_age()
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    log = lambda line: print(line, file=sys.stderr, flush=True)
    log(f"portbench: process age {age:.3f} s before torch, "
        f"{process_age():.3f} s with torch and the card found")
    result, lines = run_cell(ROOT, bench, args.workload, args.seed,
                             args.seconds, bool(args.trace), "cuda", log)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
