"""Where one sample's time goes on the card, for one scene configuration.

    python -m moonshine_tpu_torch.render.profile_frame [--config default|treelet]
        [--size 1920x1080] [--grid 6] [--subdivisions 4]

Builds the room scene (grid=6, subdivisions=4 is room_184k) as the
default build, or as the treelet configuration (MSN_WIDE=8 MSN_LEAF_CAP=8
at build, MSN_TREELETS=1 at dispatch), renders one warm-up sample, times
one sample unprofiled (host clock around a synchronised render_spp),
then traces one more under torch.profiler. Prints one JSON line: the
card, the unprofiled wall, the kernel count, the summed kernel time, the
device busy time (union of kernel intervals) over the profiled wall, the
traversal kernels' time, the treelet phase-1 kernel's time and the five
kernels that took longest. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time


def _kernel_events(prof) -> list[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("default", "treelet"),
                    default="default")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--grid", type=int, default=6)
    ap.add_argument("--subdivisions", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from .camera import LensArrays
    from .renderer import render_spp
    from ..integrator.path import PathConfig, _hbm_mode
    from ..scene import procedural

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    width, height = (int(x) for x in args.size.split("x"))
    if args.config == "treelet":
        os.environ.update(MSN_WIDE="8", MSN_LEAF_CAP="8", MSN_TREELETS="1")
    dev = torch.device("cuda", 0)
    world, lens = procedural.room_scene(grid=args.grid,
                                        subdivisions=args.subdivisions)
    scene = world.build(dev)
    lens = LensArrays.from_lens(lens, dev)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)

    render_spp(scene, lens, height, width, 0, 1, cfg)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_spp(scene, lens, height, width, 1, 1, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_spp(scene, lens, height, width, 2, 1, cfg)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_events(prof)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total_us = sum(by_name.values())
    traversal_us = sum(v for k, v in by_name.items()
                       if "traverse_kernel" in k or "treelet_kernel" in k)
    phase1_us = sum(v for k, v in by_name.items() if "pending_kernel" in k)
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {
        "card": smi, "config": args.config, "size": args.size,
        "mode": _hbm_mode(scene.wide), "triangles": scene.num_tris,
        "wall_ms_unprofiled": wall_ms, "wall_ms_profiled": prof_wall_ms,
        "kernels": len(kernels), "kernel_ms": total_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / prof_wall_ms,
        "traversal_ms": traversal_us / 1e3,
        "treelet_phase1_ms": phase1_us / 1e3,
        "top": [[k[:80], v / 1e3] for k, v in top],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
