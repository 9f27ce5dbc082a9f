"""The bounce loop's host reads against the card's time: the graphs
phase's cells as graph replays in this checkout and in others, and the
looped form's block size (integrator/path.py LOOP_BLOCK) swept:

    python -m moonshine_tpu_torch.scripts.compare_loop [--against DIR ...]
        [--rounds N] [--samples N] [--blocks 4,8,16,32]

The cells are chip_smoke.py `graphs` phase's: room_184k (512x512) and
room_1080p through render_spp (one env and one mesh-light sample a
bounce, max_bounces 4; the fused and the staged path), offline_720p
(compare_sort.offline_cell: the offline CLI's defaults on room_184k with
constant materials and the seeded sky of scripts.skybox, 1280x720,
max_bounces 1024: the looped form), engine_720p (room_184k through the Engine's handles at 1280x720,
its defaults: max_bounces 1024, NEE off; a sensor reset before each
frame), instanced_1080p (procedural.instanced_scene(), two-level) and
treelet_1080p (room_1080p's frame on room_184k built 8-wide / 8-slot,
MSN_WIDE=8 MSN_LEAF_CAP=8, dispatched with MSN_TREELETS=1: the treelet
kernels).
For each cell, from a clear graph cache: the peak device memory
(allocated and reserved) over a warm-up sample (the captures) and
`--samples` timed ones, each timed on the host clock between
synchronisations (ms a sample); graphs.COUNTS over one sample (reads,
conds, replays) and the launches of csrc/graph_cond.cu's kernels in it
(graphs.LAUNCHES: set kernels, loop tails); one more sample under torch.profiler
(render/profile_frame.py `profile`: kernels, graph replays, host
dispatches and reads, kernel time, the device's idle share), another
for its device operations (`device_ops`: kernels, copies and fills,
their time and busy time) and one on the eager loop for its kernel ms
and kernels by stage range (integrator/path.py STAGES); and a digest of
the image of sample 0 and its
ray count (the Engine's frame: its image), which must agree across
checkouts.

Each checkout, this one and each `--against DIR` (an earlier commit
unpacked by `git archive` into a gitignored directory), runs in a
process of its own (the packages share a name), in rounds that alternate
the order: DIR, this, this, DIR. With `--blocks`, this checkout's looped
cells are then timed at each block size in turn (rounds alternate the
order), their images bit for bit the same at every size. Prints a line
per cell and run, then one JSON line; exits 1 if an image differs.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
CHECKOUT = HERE.parents[2]
CELLS = ("room_184k", "room_1080p", "offline_720p", "engine_720p",
         "instanced_1080p", "treelet_1080p")
LOOPED = ("offline_720p", "engine_720p")


def engine_from_world(world, dev):
    """An Engine holding `world` entered through its handles: a mesh per
    mesh, a StandardPBR material per material from solid or raw
    textures (Lambert as metalness 0, roughness 1; a mirror as
    metalness 1, roughness 0; glass as a white dielectric with its ior:
    the Engine, like hydra, exposes StandardPBR only), an instance per
    instance, a white background."""
    import numpy as np

    from moonshine_tpu_torch.engine import Engine
    from moonshine_tpu_torch.scene.types import Glass, Lambert, Mirror

    e = Engine(device=dev)
    tex = lambda v: (e.create_raw_texture(v)
                     if isinstance(v, np.ndarray) and v.ndim == 3
                     else e.create_solid_texture(v))
    for m in world.meshes:
        e.create_mesh(m.positions, m.indices, m.normals, m.texcoords,
                      m.indexed_attributes)
    for info in world.materials:
        v = info.variant
        if isinstance(v, Lambert):
            c, metal, rough, ior = v.color, 0.0, 1.0, 1.5
        elif isinstance(v, Mirror):
            c, metal, rough, ior = (1.0, 1.0, 1.0), 1.0, 0.0, 1.5
        elif isinstance(v, Glass):
            c, metal, rough, ior = (1.0, 1.0, 1.0), 0.0, 0.0, v.ior
        else:
            c, metal, rough, ior = v.color, v.metalness, v.roughness, v.ior
        e.create_material(color=tex(c), metalness=tex(metal),
                          roughness=tex(rough), emissive=tex(info.emissive),
                          ior=ior)
    for inst in world.instances:
        e.create_instance(inst.transform,
                          [(g.mesh, g.material, g.sampled)
                           for g in inst.geometries], inst.visible)
    e.set_background(None)
    return e


def cell(name: str, dev):
    """sample(i) of the named cell: renders sample i, returns (its image,
    its ray count or None)."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts.compare_sort import offline_cell

    if name == "offline_720p":
        return offline_cell(dev)
    if name == "engine_720p":
        world, lens = procedural.room_scene(grid=6, subdivisions=4)
        e = engine_from_world(world, dev)
        sensor, handle = e.create_sensor(1280, 720), e.create_lens(lens)

        def frame(_):
            e.reset_sensor(sensor)
            return e.render(sensor, handle), None
        return frame
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    if name == "treelet_1080p":
        from moonshine_tpu_torch.scripts.compare_traverse import _room

        scene, lens = _room(8, 8)

        def treelets(i):  # the switch is read at each dispatch
            os.environ["MSN_TREELETS"] = "1"
            try:
                return render_spp(scene, lens, 1080, 1920, i, 1, cfg)
            finally:
                os.environ.pop("MSN_TREELETS", None)
        return treelets
    world, lens = (procedural.instanced_scene() if name == "instanced_1080p"
                   else procedural.room_scene(grid=6, subdivisions=4))
    scene, lens = world.build(dev), LensArrays.from_lens(lens, dev)
    h, w = (512, 512) if name == "room_184k" else (1080, 1920)
    return lambda i: render_spp(scene, lens, h, w, i, 1, cfg)


def device_ops(fn) -> dict:
    """One call of fn under torch.profiler: the device operations it ran
    (kernels, copies and fills: inside a conditional body a copy or fill
    runs as a kernel, so kernels alone do not compare across the
    change), their summed time and their busy time (the union of their
    intervals), in ms."""
    import torch

    from moonshine_tpu_torch.render.profile_frame import (
        _trace_events, _union_us,
    )

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in _trace_events(prof) if "dur" in e and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    return {"ops": len(ops), "ops_ms": sum(e["dur"] for e in ops) / 1e3,
            "ops_busy_ms": _union_us((e["ts"], e["ts"] + e["dur"])
                                     for e in ops) / 1e3}


def measure(sample, samples: int) -> dict:
    """One cell's numbers from a clear graph cache (module docstring)."""
    import numpy as np
    import torch

    from moonshine_tpu_torch.integrator import graphs, path
    from moonshine_tpu_torch.render.profile_frame import profile

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sample(1)  # the warm-up: the captures
    graphs.reset_counts()
    graphs.reset_launch_counts()
    img, rays = sample(0)
    torch.cuda.synchronize()
    counts = dict(graphs.COUNTS)
    cond_launches = dict(graphs.LAUNCHES)
    img = np.ascontiguousarray(np.asarray(torch.as_tensor(img).cpu()))
    rays = None if rays is None else int(rays)
    ms = []
    for i in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(2 + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() / 2**20,
            torch.cuda.max_memory_reserved() / 2**20)
    prof = profile(lambda: sample(2))
    prof.pop("by_name_us")
    ops = device_ops(lambda: sample(2))
    with graphs.eager():  # the eager loop's kernel ms by stage range
        eager = profile(lambda: sample(2), marks=path.STAGES)
    graphs.clear()
    return {"ms": ms, "reads": counts["reads"],
            "conds": counts.get("conds", 0), "replays": counts["replays"],
            "captures": counts["captures"], "peak_mib": peak,
            "cond_launches": cond_launches,
            "kernels": prof["kernels"], "profile_replays": prof["replays"],
            "dispatches": prof["host_dispatches"],
            "host_reads": prof["host_reads"], "kernel_ms": prof["kernel_ms"],
            "idle_share": prof["idle_share"], **ops,
            "eager_kernels": eager["kernels"],
            "eager_kernel_ms": eager["kernel_ms"],
            "stages": {k: eager[k]["kernel_ms"] for k in path.STAGES},
            "stage_kernels": {k: sum(eager[k]["kernels"].values())
                              for k in path.STAGES}, "rays": rays,
            "image": hashlib.sha256(img.tobytes() + str(rays).encode()
                                    ).hexdigest()[:16]}


def run_cells(names, samples: int) -> list:
    """This process's checkout: one JSON line a cell (`measure`)."""
    import torch

    dev = torch.device("cuda", 0)
    out = []
    for name in names:
        row = {"cell": name, **measure(cell(name, dev), samples)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def sweep(blocks, rounds: int, samples: int) -> dict:
    """The looped cells at each block size, in rounds of alternated order:
    {cell: {block: [ms a sample, ...]}}, with reads a sample; raises if
    an image differs between sizes."""
    import torch

    from moonshine_tpu_torch.integrator import path

    dev = torch.device("cuda", 0)
    out = {}
    for name in LOOPED:
        sample = cell(name, dev)
        rows, images = {}, set()
        for r in range(rounds):
            for k in (blocks if r % 2 == 0 else blocks[::-1]):
                path.LOOP_BLOCK = k
                row = measure(sample, samples)
                images.add(row["image"])
                rows.setdefault(k, []).append(row)
                print(json.dumps({"cell": name, "block": k, "round": r,
                                  **row}), flush=True)
        if len(images) != 1:
            raise AssertionError(f"{name}: images differ across block "
                                 f"sizes {images}")
        out[name] = {k: {"ms": [m for row in v for m in row["ms"]],
                         "reads": [row["reads"] for row in v]}
                     for k, v in rows.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", nargs="*", default=[], metavar="DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--blocks", default="")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--here", action="store_true",
                    help="run the cells in this process only")
    args = ap.parse_args(argv)
    names = args.cells.split(",")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_loop needs a CUDA device")
    if args.here:
        run_cells(names, args.samples)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60
                         ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    checkouts = [pathlib.Path(d).resolve() for d in args.against]
    order = []
    for r in range(args.rounds):
        pair = [(c, CHECKOUT) for c in checkouts] or [(CHECKOUT,)]
        for group in pair:
            order += list(group if r % 2 == 0 else group[::-1])
    runs = []
    for checkout in order:
        env = dict(os.environ, PYTHONPATH=str(checkout))
        proc = subprocess.run(
            [sys.executable, str(HERE), "--here", "--samples",
             str(args.samples), "--cells", args.cells],
            cwd=checkout, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{checkout}: {proc.stderr[-3000:]}")
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        label = "this" if checkout == CHECKOUT else checkout.name
        for row in rows:
            print(f"{label} {row['cell']}: {json.dumps(row)}", flush=True)
        runs.append((label, rows))
    summary = {"card": smi, "order": [label for label, _ in runs]}
    bad = []
    for name in names:
        by = {}
        for label, rows in runs:
            row = next(r for r in rows if r["cell"] == name)
            by.setdefault(label, []).append(row)
        digests = {row["image"] for rows in by.values() for row in rows}
        if len(digests) != 1:
            bad.append(name)
        summary[name] = {
            label: {"ms": [m for row in rows for m in row["ms"]],
                    **{k: [row[k] for row in rows] for k in (
                        "reads", "conds", "replays", "dispatches",
                        "host_reads", "kernels", "kernel_ms", "ops",
                        "ops_ms", "ops_busy_ms", "idle_share",
                        "peak_mib", "eager_kernels", "eager_kernel_ms",
                        "stages", "stage_kernels", "cond_launches")}}
            for label, rows in by.items()}
        summary[name]["same_image"] = len(digests) == 1
    if args.blocks:
        blocks = [int(k) for k in args.blocks.split(",")]
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, json; from moonshine_tpu_torch.scripts import "
             "compare_loop as c; print(json.dumps({'sweep': c.sweep("
             f"{blocks!r}, {args.rounds}, {args.samples})}}))"],
            cwd=CHECKOUT, env=dict(os.environ, PYTHONPATH=str(CHECKOUT)),
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"sweep: {proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if ln.startswith('{"cell"'):
                print(f"sweep {ln}", flush=True)
        summary["sweep"] = json.loads(proc.stdout.splitlines()[-1])["sweep"]
    print(json.dumps(summary), flush=True)
    if bad:
        print(f"images differ between checkouts: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
