"""Where one sample's time goes on the card, for one scene configuration.

    python -m moonshine_tpu_torch.render.profile_frame
        [--config default|treelet|instanced|direct] [--size 1920x1080]
        [--grid 6] [--subdivisions 4] [--mesh auto|SP,DP [--one-card]]

Builds the room scene (grid=6, subdivisions=4 is room_184k) as the
default build, or as the treelet configuration (MSN_WIDE=8 MSN_LEAF_CAP=8
at build, MSN_TREELETS=1 at dispatch), or instanced_1080p's scene
(`procedural.instanced_scene()`, two-level by the flatten cap; --grid
and --subdivisions do not apply), renders one warm-up sample, times
one sample unprofiled (host clock around a synchronised render_spp),
then traces one more under torch.profiler. Prints one JSON line: the
card, the unprofiled wall, the kernel count, the graph replays, the
host's dispatches and reads, the summed kernel time, the device busy
time (union of kernel intervals) over the profiled wall, the traversal
kernels' time (packet, treelet or two-level), the treelet phase-1
kernel's time, the shading kernels' time (csrc/shade.cu), the lane
sort's (csrc/sort.cu: the permutation passes, whose first kernel makes
the sites' coherence keys, and the move apart), the five kernels that
took longest, and the same
sample on the eager loop (graphs.eager(): its wall, kernels and idle
share, and its time split by the sample's stages, integrator/path.py
STAGES: each stage's calls, host time and the time of the kernels it
launched, which a graph replay runs without calling Python; the stages'
sum and its share of the kernel time). --config direct profiles
trace_direct on room_184k's camera rays instead (eager: it runs no
graphs), split by the same stages. With --mesh it profiles one
`render_sharded` call of SP samples (one a sample shard; --one-card
puts every shard on cuda:0) instead, and gives each card's busy share
and the overlap of the shards on one card. Needs a CUDA device.

The bounce loop runs as CUDA graph replays (integrator/graphs.py): a
replay is one host dispatch for many kernels. `profile(fn)` counts the
host's dispatches (graph replays, and the kernels, copies and fills
launched outside a graph: device operations by correlation id) and its
reads (device-to-host copies); the smoke's `graphs` phase calls it on
other cells.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time


def _trace_events(prof) -> list[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _annotated(events, name) -> tuple[int, float, float, dict]:
    """(calls, host us, kernel us, {kernel name: launches}) of the ranges
    `name` marks: the kernels whose launches fall inside them, by
    correlation id."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == name and e.get("cat") == "user_annotation"
             and "dur" in e]
    corr = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") == "cuda_runtime"
            and any(a <= e["ts"] <= b for a, b in spans)}
    corr.discard(None)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in corr]
    names: dict[str, int] = {}
    for e in kernels:
        names[e["name"]] = names.get(e["name"], 0) + 1
    return (len(spans), sum(b - a for a, b in spans),
            sum(e["dur"] for e in kernels), names)


def _merged(spans) -> list:
    """The union of (start, stop) spans as disjoint sorted spans."""
    out = []
    for start, stop in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def _union_us(spans) -> float:
    return sum(stop - start for start, stop in _merged(spans))


def _by_device(kernels, wall_us) -> dict:
    """For each device in the kernel events: its streams, its busy time
    (union of its kernel intervals) and share of the profiled wall, and
    the overlap: the time in which kernels of two or more of its streams
    ran at once (shards stepped together on one card), as a share of its
    busy time."""
    streams: dict = {}
    for e in kernels:
        args = e.get("args", {})
        streams.setdefault(args.get("device"), {}).setdefault(
            args.get("stream"), []).append((e["ts"], e["ts"] + e["dur"]))
    out = {}
    for device, spans in sorted(streams.items(), key=lambda kv: str(kv[0])):
        edges = sorted((t, step) for s in spans.values()
                       for a, b in _merged(s) for t, step in ((a, 1),
                                                              (b, -1)))
        overlap, live, last = 0.0, 0, 0.0
        for t, step in edges:
            if live >= 2:
                overlap += t - last
            live, last = live + step, t
        busy = _union_us(x for s in spans.values() for x in s)
        out[str(device)] = {
            "streams": len(spans), "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us, "overlap_ms": overlap / 1e3,
            "overlap_share": overlap / busy if busy else 0.0}
    return out


def _host_ops(events) -> tuple[int, int, int]:
    """(graph replays, host dispatches, device-to-host copies) in a
    trace: the device operations (kernels, copies, fills) a
    cudaGraphLaunch runs share its correlation id, so a replay counts
    once."""
    replays = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaGraphLaunch"}
    ops = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launched = {e.get("args", {}).get("correlation") for e in ops} - replays
    reads = sum(1 for e in ops if e.get("cat") == "gpu_memcpy"
                and "DtoH" in e.get("name", ""))
    return len(replays), len(replays) + len(launched), reads


def profile(fn, marks=()) -> dict:
    """One call of fn (a sample, already warmed up) timed on the host
    clock, then one more under torch.profiler: the unprofiled and
    profiled wall, kernels, graph replays, host dispatches and reads,
    kernel time, device busy time and idle share (over every device),
    each device's busy share and the overlap of its streams
    (`_by_device`), kernel time by name (us), and for each name in
    `marks` (a range that fn's callees open with record_function) its
    calls, host ms, kernel ms and kernels launched by name. CPU activity
    is traced only when there are marks."""
    import torch

    def synchronize():  # every card: fn may run a mesh
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    synchronize()
    t0 = time.perf_counter()
    fn()
    synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if marks:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = _trace_events(prof)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    replays, dispatches, reads = _host_ops(events)
    out = {
        "wall_ms_unprofiled": wall_ms, "wall_ms_profiled": prof_wall_ms,
        "kernels": len(kernels), "replays": replays,
        "host_dispatches": dispatches, "host_reads": reads,
        "kernel_ms": sum(by_name.values()) / 1e3, "busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / prof_wall_ms,
        "devices": _by_device(kernels, prof_wall_ms * 1e3),
        "by_name_us": by_name,
    }
    for name in marks:
        calls, host_us, kernel_us, names = _annotated(events, name)
        out[name] = {"calls": calls, "host_ms": host_us / 1e3,
                     "kernel_ms": kernel_us / 1e3, "kernels": names}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("default", "treelet", "instanced",
                                         "direct"), default="default")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--grid", type=int, default=6)
    ap.add_argument("--subdivisions", type=int, default=4)
    ap.add_argument("--mesh", default=None, metavar="auto|SP,DP",
                    help="profile one render_sharded call of SP samples on "
                    "this mesh of the visible cards instead")
    ap.add_argument("--one-card", action="store_true",
                    help="with --mesh SP,DP: every shard on cuda:0")
    args = ap.parse_args(argv)

    import torch

    from .camera import LensArrays
    from .renderer import render_spp
    from ..integrator import graphs, path
    from ..integrator.path import PathConfig, _hbm_mode
    from ..scene import procedural

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    width, height = (int(x) for x in args.size.split("x"))
    if args.config == "treelet":
        os.environ.update(MSN_WIDE="8", MSN_LEAF_CAP="8", MSN_TREELETS="1")
    dev = torch.device("cuda", 0)
    if args.config == "instanced":
        world, lens = procedural.instanced_scene()
    else:
        world, lens = procedural.room_scene(grid=args.grid,
                                            subdivisions=args.subdivisions)
    scene = world.build(dev)
    lens = LensArrays.from_lens(lens, dev)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.mesh:
        return _profile_mesh(args, scene, lens, cfg, smi)
    if args.config == "direct":
        return _profile_direct(args, scene, lens, smi)
    sample = lambda: render_spp(scene, lens, height, width, 2, 1, cfg)

    render_spp(scene, lens, height, width, 0, 1, cfg)  # warm-up, captures
    prof = profile(sample)
    by_name = prof.pop("by_name_us")
    with graphs.eager():
        eager = profile(sample, marks=path.STAGES)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {
        "card": smi, "config": args.config, "size": args.size,
        "mode": "tlas" if scene.tlas is not None else _hbm_mode(scene.wide),
        "triangles": scene.num_tris, **prof, **_kinds(by_name),
        "top": [[k[:80], v / 1e3] for k, v in top],
        "eager": {k: eager[k] for k in (
            "wall_ms_unprofiled", "kernels", "host_dispatches", "kernel_ms",
            "idle_share")},
        "stages": {k: eager[k] for k in path.STAGES},
        **_stage_sum(eager),
    }
    print(json.dumps(out), flush=True)
    return out


def _stage_sum(prof) -> dict:
    """The kernel ms inside the stage ranges (integrator/path.py STAGES)
    of a profile made with them as marks, and its share of the sample's
    kernel ms: what no range holds is the rest."""
    from ..integrator import path

    staged = sum(prof[k]["kernel_ms"] for k in path.STAGES)
    return {"stages_kernel_ms": staged,
            "stages_share": staged / prof["kernel_ms"]
            if prof["kernel_ms"] else 0.0}


def _kinds(by_name) -> dict:
    """Kernel time (ms) of the traversal kernels (packet, treelet or
    two-level), treelet phase 1, the shading kernels and the lane sort's
    permutation passes (every `radix_` kernel, the upsweep that makes the
    sites' keys among them) and move."""
    ms = lambda *keys: sum(v for k, v in by_name.items()
                           if any(key in k for key in keys)) / 1e3
    return {"traversal_ms": ms("traverse_kernel", "treelet_kernel",
                               "tlas_kernel"),
            "treelet_phase1_ms": ms("pending_kernel"),
            "shade_ms": ms("surface_kernel", "scatter_kernel",
                           "env_miss_kernel", "env_draw_kernel"),
            "sort_perm_ms": ms("radix_"),
            "sort_move_ms": ms("lane_move_kernel")}


def _profile_direct(args, scene, lens, smi) -> dict:
    """trace_direct on the frame's camera rays (one env and one
    mesh-light sample), after a warm-up call: profile()'s numbers, split
    by the bounce's stages."""
    from ..integrator import path
    from ..integrator.direct import DirectConfig, trace_direct
    from .renderer import _sample_rays

    width, height = (int(x) for x in args.size.split("x"))
    o, d, rng, _ = _sample_rays(lens, height, width, 0, True, scene.device)
    call = lambda: trace_direct(scene, o, d, rng, DirectConfig())
    call()  # warm-up: the kernels' builds
    prof = profile(call, marks=path.STAGES)
    by_name = prof.pop("by_name_us")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"card": smi, "config": args.config, "size": args.size,
           "triangles": scene.num_tris,
           **{k: v for k, v in prof.items() if k not in path.STAGES},
           **_kinds(by_name), "top": [[k[:80], v / 1e3] for k, v in top],
           "stages": {k: prof[k] for k in path.STAGES}, **_stage_sum(prof)}
    print(json.dumps(out), flush=True)
    return out


def _profile_mesh(args, scene, lens, cfg, smi) -> dict:
    """One render_sharded call on the mesh (`--mesh`, `--one-card`), after
    a warm-up call (the captures): profile()'s numbers, with each card's
    busy share and the overlap of the shards on one card (`devices`)."""
    import torch

    from ..parallel import make_mesh, mesh_from_spec, render_sharded

    width, height = (int(x) for x in args.size.split("x"))
    if args.one_card:
        sp, dp = (int(x) for x in args.mesh.split(","))
        mesh = make_mesh([torch.device("cuda", 0)] * (sp * dp), sp=sp)
    else:
        mesh = mesh_from_spec(args.mesh)
    spp = mesh.shape["sp"]
    call = lambda: render_sharded(scene, lens, height, width, spp, cfg, mesh)
    call()  # warm-up: the copies and captures
    prof = profile(call)
    by_name = prof.pop("by_name_us")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"card": smi, "config": args.config, "size": args.size,
           "spp": spp, "mesh": mesh.shape,
           "mesh_devices": [str(d) for d in mesh.devices.flat], **prof,
           "traversal_ms": sum(v for k, v in by_name.items()
                               if "traverse_kernel" in k) / 1e3,
           "top": [[k[:80], v / 1e3] for k, v in top]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
