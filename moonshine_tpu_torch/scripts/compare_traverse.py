"""The traversal kernels over rows (csrc/traverse.cu) and over format-V
tiles (csrc/vpacket.cu) against what they replace, on the same rays, on
the card:

    python -m moonshine_tpu_torch.scripts.compare_traverse [--rounds N]
        [--against DIR ...] [--offline-samples N]

On room_184k built 24-wide / 24-slot (its default), 32/24, 16/12 (the
default width below 100k triangles) and 8/8, at the 1080p frame's
launches (2,073,600 camera rays; their 4,147,200-lane shadow batch), it
times the row kernels at the layout the wrapper gives them, with R = 0
(no top rows in shared memory) and with all of the tree's top rows, and
the format-V kernels of the same tree at their layout and with the same
top records as tiles. Each `--against DIR` is another checkout of the
repo (an earlier commit unpacked with `git archive`, or a variant of this
one copied into a gitignored directory): its csrc/traverse.cu and
csrc/vpacket.cu are built beside this checkout's, each unless it and the
headers beside it equal this checkout's, and run on the same rays, so
designs meet on one card in one process. On the 24/24 tree it then times
the offline CLI's late segments, 921,600 lanes (1280x720) of which few
are live, and their 2N shadow batch: kernel time and the wrapper's host
time a call. Last, one offline sample (the same scene untextured under
scripts.skybox, 1280x720, max_bounces 1024, as the offline_720p cell
renders it) with each traverse.cu alternated, timed on the host clock,
and one more of each under torch.profiler: kernels, kernel time, device
idle share, traversal kernel time, segments. Every kernel output must
equal the plain versions bit for bit, and the offline images each other.
Kernel times come from alternated rounds (scripts.cuda_ms). Prints one
line per measurement, then one JSON line; exits 1 if an output differs
or a launch is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from moonshine_tpu_torch.accel import native

# room_184k built four ways: (label, MSN_WIDE, MSN_LEAF_CAP)
TREES = [("24/24", 24, 24), ("32/24", 32, 24), ("16/12", 16, 12),
         ("8/8", 8, 8)]
# live lanes of the offline frame's 921,600 in the launches timed as its
# late segments (the first segment has them all live)
LATE_LIVE = (92, 922, 9216, 921_600)
OFFLINE_SIZE = (720, 1280)


def _room(width: int | None = None, cap: int | None = None,
          textured: bool = True):
    """room_184k and its lens, built at MSN_WIDE / MSN_LEAF_CAP if given."""
    import torch

    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    dev = torch.device("cuda", 0)
    world, lens = procedural.room_scene(grid=6, subdivisions=4,
                                        textured=textured)
    saved = {k: os.environ.pop(k, None) for k in ("MSN_WIDE", "MSN_LEAF_CAP")}
    if width is not None:
        os.environ.update(MSN_WIDE=str(width), MSN_LEAF_CAP=str(cap))
    try:
        if not textured:
            from moonshine_tpu_torch.scripts import skybox
            world.set_background(skybox())
        scene = world.build(dev)
    finally:
        for k, x in saved.items():
            os.environ.pop(k, None)
            if x is not None:
                os.environ[k] = x
    return scene, LensArrays.from_lens(lens, dev)


def _same(got, want) -> bool:
    import torch

    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _check(label, runs, wants, bad):
    """Call every run once and hold its outputs against the plain
    versions'; drops the runs that were refused."""
    import torch

    for name, fns in list(runs.items()):
        try:
            outs = [f() for f in fns]
        except RuntimeError as e:  # a launch the card refused
            print(f"{label} {name}: {e}", flush=True)
            bad.append(f"{label} {name}")
            del runs[name]
            continue
        torch.cuda.synchronize()
        if not all(_same(g, w) for g, w in zip(outs, wants)):
            bad.append(f"{label} {name}")
    print(f"{label}: every run equals the plain versions bit for bit: "
          f"{not [b for b in bad if b.startswith(label)]}", flush=True)


def _alternate(label, runs, rounds, reps, kinds=("closest", "any")):
    """Alternated rounds of cuda_ms over every run: {run: {kind: [ms]}}."""
    from moonshine_tpu_torch.scripts import cuda_ms

    ms = {name: {k: [] for k in kinds} for name in runs}
    for _ in range(rounds):
        for name, fns in runs.items():
            for k, f in zip(kinds, fns):
                ms[name][k].append(cuda_ms(f, reps))
    for name, by in ms.items():
        print(f"{label} {name}: " + "; ".join(
            f"{k} " + " / ".join(f"{x:.4f}" for x in v) + " ms"
            for k, v in by.items()), flush=True)
    return ms


def _host_us(fn, reps: int) -> float:
    """Host microseconds a call while the stream is held (so that the
    calls only queue): the wrapper's own cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * 2.0e9))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _launcher(lib, tree, rays, any_hit, layout_of=None):
    """One launch of `lib` on `rays` (its wrapper's checks skipped), at
    the layout `layout_of(tree)`: by default the layout the shipped
    wrapper gives rows or tiles."""
    from moonshine_tpu_torch.accel import packet, vpacket

    if layout_of is None:
        layout_of = (vpacket.kernel_layout
                     if isinstance(tree, vpacket.VWide)
                     else packet.kernel_layout)
    return lambda: packet._launch(lib, {"k": 0}, "k", tree, *rays, any_hit,
                                  layout_of=layout_of)


def _top_tiles(r: int):
    """vpacket.kernel_layout with tiles 0..r-1 in shared memory."""
    from moonshine_tpu_torch.accel import packet

    def layout_of(v):
        stacks = packet.GROUPS_PER_BLOCK * v.max_stack * 4
        return packet.KernelLayout(r, v.max_stack,
                                   r * v.nodes[0].numel() * 4 + stacks)

    return layout_of


def trees_phase(rows, tiles, rounds, bad):
    """Every row and tile kernel on the four trees' 1080p launches."""
    import torch

    from moonshine_tpu_torch.accel import packet, vpacket
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scripts import shadow_batch

    out = {}
    for label, width, cap in TREES:
        scene, lens = _room(width, cap)
        wb = scene.wide
        dev = wb.nodes.device
        o, d, _, _ = _sample_rays(lens, 1080, 1920, 0, True, dev)
        n = o.shape[0]
        closest = (o, d, torch.full((n,), 1.0e12, device=dev),
                   torch.ones(n, dtype=torch.bool, device=dev))
        wants = [packet.closest_hit_plain(wb, *closest)]
        shadow = shadow_batch(o, d, wants[0])
        wants.append(packet.any_hit_plain(wb, *shadow))
        layout = packet.kernel_layout(wb)
        v = vpacket.v_from_wide(wb)
        v_layout = vpacket.kernel_layout(v)
        print(f"{label}: {n} camera rays, {shadow[0].shape[0]} shadow lanes; "
              f"rows {layout}, G = {rows['shipped'].group_lanes(width)}; "
              f"tiles {v_layout}, G = {tiles['shipped'].group_lanes(width)}; "
              f"the tree's top records {wb.top_rows}", flush=True)
        runs = {}
        for r in sorted({layout.top_rows, 0, wb.top_rows}, reverse=True):
            name = f"rows R = {r}" + (" (shipped)" if r == layout.top_rows
                                      else "")
            tree = wb._replace(top_rows=r)
            runs[name] = (_launcher(rows["shipped"], tree, closest, False),
                          _launcher(rows["shipped"], tree, shadow, True))
        for name, lib in rows.items():
            if name != "shipped":
                runs[f"rows {name}"] = (_launcher(lib, wb, closest, False),
                                        _launcher(lib, wb, shadow, True))
        for r in sorted({v_layout.top_rows, 0, wb.top_rows}):
            at = _top_tiles(r)
            if at(v).shared_bytes > packet.SHARED_BYTES_MAX:
                continue
            name = f"V R = {r}" + (" (shipped)" if r == v_layout.top_rows
                                   else "")
            runs[name] = (
                _launcher(tiles["shipped"], v, closest, False, layout_of=at),
                _launcher(tiles["shipped"], v, shadow, True, layout_of=at))
        for name, lib in tiles.items():
            if name != "shipped":
                runs[f"V {name}"] = (_launcher(lib, v, closest, False),
                                     _launcher(lib, v, shadow, True))
        _check(label, runs, wants, bad)
        out[label] = _alternate(label, runs, rounds, 5)
        del scene, wb, v, runs, wants, shadow, closest
        torch.cuda.empty_cache()
    return out


def late_phase(rows, tiles, rounds, bad):
    """The offline frame's late segments on the 24/24 tree, over rows and
    over its tiles."""
    import numpy as np
    import torch

    from moonshine_tpu_torch.accel import packet, vpacket
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scripts import shadow_batch

    scene, lens = _room()
    wb = scene.wide
    v = vpacket.v_from_wide(wb)
    dev = wb.nodes.device
    h, w = OFFLINE_SIZE
    o, d, _, _ = _sample_rays(lens, h, w, 0, True, dev)
    n = o.shape[0]
    out = {}
    for live in LATE_LIVE:
        act = np.zeros(n, bool)
        act[np.random.RandomState(live).choice(n, live, replace=False)] = True
        closest = (o, d, torch.full((n,), 1.0e12, device=dev),
                   torch.from_numpy(act).to(dev))
        wants = [packet.closest_hit_plain(wb, *closest)]
        shadow = shadow_batch(o, d, wants[0])
        wants.append(packet.any_hit_plain(wb, *shadow))
        label = f"late 24/24 {live} of {n} live"
        runs = {}
        for prefix, libs, tree in (("rows", rows, wb), ("V", tiles, v)):
            for name, lib in libs.items():
                runs[f"{prefix} {name}"] = (
                    _launcher(lib, tree, closest, False),
                    _launcher(lib, tree, shadow, True))
        _check(label, runs, wants, bad)
        ms = _alternate(label, runs, rounds, 20)
        host = {name: {"closest": [], "any": []} for name in runs}
        for _ in range(rounds):
            for name, (fc, fa) in runs.items():
                host[name]["closest"].append(_host_us(fc, 50))
                host[name]["any"].append(_host_us(fa, 50))
        for name, by in host.items():
            print(f"{label} {name} host us a call: " + "; ".join(
                f"{k} " + " / ".join(f"{x:.1f}" for x in v)
                for k, v in by.items()), flush=True)
        out[label] = {"kernel_ms": ms, "host_us": host}
    del scene, wb, v
    torch.cuda.empty_cache()
    return out


def offline_phase(rows, samples, bad):
    """One offline sample per row kernel, alternated, then one profiled."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.profile_frame import (_kernel_events,
                                                           _union_us)
    from moonshine_tpu_torch.render.renderer import render_sample

    scene, lens = _room(textured=False)
    h, w = OFFLINE_SIZE
    cfg = PathConfig(max_bounces=1024, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    names = list(rows)
    shipped = native._LOADED["traverse"]

    def sample(name):
        native._LOADED["traverse"] = rows[name]
        try:
            packet.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, _ = render_sample(scene, lens, h, w, 0, cfg)
            torch.cuda.synchronize()
            return img, (time.perf_counter() - t0) * 1e3, dict(packet.LAUNCHES)
        finally:
            native._LOADED["traverse"] = shipped

    images = {name: sample(name)[0] for name in names}  # warm-up
    differ = [name for name in names
              if not torch.equal(images[name], images["shipped"])]
    bad += [f"offline image: {name} != shipped" for name in differ]
    print(f"offline {w}x{h}: the images of {names} are equal: "
          f"{not differ}", flush=True)
    wall = {name: [] for name in names}
    counts = {}
    for i in range(samples):
        for name in (names if i % 2 else names[::-1]):
            _, ms, counts[name] = sample(name)
            wall[name].append(ms)
    for name, v in wall.items():
        print(f"offline {name}: " + " / ".join(f"{x:.2f}" for x in v)
              + f" ms a sample; launches {counts[name]}", flush=True)

    profiled = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name in names:
        with torch.profiler.profile(activities=acts) as prof:
            _, ms, _ = sample(name)
        kernels = _kernel_events(prof)
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        profiled[name] = {
            "wall_ms_profiled": ms, "kernels": len(kernels),
            "kernel_ms": sum(by_name.values()) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / ms,
            "traversal_ms": sum(v for k, v in by_name.items()
                                if "traverse_kernel" in k) / 1e3,
            "top": [[k[:60], v / 1e3] for k, v in top]}
        print(f"offline {name} profiled: {json.dumps(profiled[name])}",
              flush=True)
    return {"wall_ms": wall, "launches": counts, "profiled": profiled}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout whose traverse.cu and vpacket.cu "
                    "run beside")
    ap.add_argument("--offline-samples", type=int, default=2,
                    help="timed offline samples per kernel (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_traverse needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)

    against = native.build_against(args.against, ("traverse", "vpacket"))()
    this = native.build_all(("traverse", "vpacket"))
    rows = {"shipped": this["traverse"], **against["traverse"]}
    tiles = {"shipped": this["vpacket"], **against["vpacket"]}
    for kind, libs in (("traverse", rows), ("vpacket", tiles)):
        for name, lib in libs.items():
            print(f"{kind} {name}: {lib.path.name}, built in "
                  f"{lib.build_seconds:.1f} s; ptxas: "
                  f"{native.ptxas_summary(lib.log)}", flush=True)

    bad: list[str] = []
    result = {"card": smi, "trees": trees_phase(rows, tiles, args.rounds, bad),
              "late": late_phase(rows, tiles, args.rounds, bad)}
    if args.offline_samples:
        result["offline"] = offline_phase(rows, args.offline_samples, bad)
    result["mismatch"] = bad
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
