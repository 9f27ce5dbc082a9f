"""render_sharded on one card and across every visible card, timed:

    python -m moonshine_tpu_torch.scripts.time_sharded [--size 512]
        [--height H] [--spp 4] [--reps 2]

On room_184k (procedural.room_scene(grid=6, subdivisions=4), SAH
24/24), PathConfig(max_bounces=4, one env and one mesh-light sample a
bounce), SIZE wide and H (default SIZE) high at SPP samples: `render_spp`
on cuda:0 (the one-card time and image), then on two meshes, cuda:0
repeated four times (sp=2, dp=2) and `make_mesh()` (every visible card,
sp=2 when even), each two ways: `render_sharded`, every shard stepped
together, and `in_turn`, the same shards one after another, each through
renderer._sample_sum. Each is run once to warm up (its graphs'
captures), then REPS times in turns (stepped, in turn, in turn,
stepped, ...), timed to the end of every card's work. Each mesh's
stepped image and rays equal its in-turn ones bit for bit, with the
same packet-kernel launches, and the one-card image within 2e-6 x
max(1, |pixel|), with the same rays; a second stepped call makes no
scene copy and captures no graph. Prints the card's name and power
limit, then one JSON line (seconds of each run, graph captures, replays,
live-count reads and scene copies a call); exits 1 if a check fails.
Needs at least one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..accel import packet
from ..integrator import graphs, shade
from ..integrator.path import PathConfig
from ..parallel import make_mesh, render_sharded, sharding
from ..render.camera import LensArrays
from ..render.renderer import _sample_sum, render_spp
from ..scene import procedural


def in_turn(scene, lens, height, width, spp, cfg, mesh, flip_image=True,
            base_sample=0):
    """What render_sharded computes, its shards run one after another,
    each alone through renderer._sample_sum on its device's copy of the
    scene, and composed as render_sharded composes them: the reference
    the stepped render is held to bit for bit, and timed beside."""
    rows, local, staged, cfg = sharding._plan(height, width, spp, cfg, mesh,
                                              None)
    parts = {}
    for si in range(mesh.shape["sp"]):
        for di in range(mesh.shape["dp"]):
            dev = mesh.devices[si, di]
            with sharding._current(dev):
                parts[(si, di)] = _sample_sum(
                    sharding.scene_on(scene, dev), lens, height, width,
                    base_sample + si * local, local, cfg, flip_image,
                    y0=di * rows, band_h=rows, staged=staged)[:2]
    return sharding._compose(parts, mesh, spp, scene.device)


def synchronize_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed_run(fn):
    """(fn's result, seconds, counts, launches) of one call, every card
    synchronised before and after; counts are graphs.COUNTS (graph
    captures and replays, live-count reads, scene copies) of the call,
    launches the packet and shading kernels'."""
    synchronize_all()
    packet.reset_launch_counts()
    shade.reset_launch_counts()
    graphs.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    synchronize_all()
    secs = time.perf_counter() - t0
    return out, secs, dict(graphs.COUNTS), {**packet.LAUNCHES,
                                            **shade.LAUNCHES}


def rel_err(img, ref) -> float:
    """max |img - ref| / max(1, |ref|)."""
    return float(((img - ref).abs() / ref.abs().clamp_min(1.0)).max())


# compare()'s checks, each of which must hold
CHECKS = ("stepped_equals_in_turn", "within_2e-6_of_one_card",
          "second_call_copies_and_captures_nothing")


def compare(scene, lens, height, width, spp, cfg, mesh, ref, rays_one,
            reps):
    """render_sharded on the mesh ("stepped") against `in_turn`, each
    called once to warm up (its captures), then `reps` times in turns
    (stepped, in turn, in turn, stepped, ...). `ref` and `rays_one` are
    the one-device mean image and rays. Returns the last stepped call's
    (image, rays), its packet launches, and a record: seconds of each
    call, graphs.COUNTS of the warm-up and the last calls, the error
    against ref, and the CHECKS: stepped equals
    in turn bit for bit (image, rays, launches); within 2e-6 x max(1,
    |pixel|) of ref with the same rays; the last stepped call copied no
    scene, captured no graph and replayed."""
    ways = {
        "stepped": lambda: render_sharded(scene, lens, height, width, spp,
                                          cfg, mesh),
        "in_turn": lambda: in_turn(scene, lens, height, width, spp, cfg,
                                   mesh)}
    first = {k: timed_run(fn) for k, fn in ways.items()}
    runs = {k: [] for k in ways}
    for r in range(reps):
        for k in (ways if r % 2 == 0 else reversed(list(ways))):
            runs[k].append(timed_run(ways[k]))
    (img, rays), _, counts, launches = runs["stepped"][-1]
    (img_t, rays_t), _, counts_t, launches_t = runs["in_turn"][-1]
    err = rel_err(img, ref)
    checks = {
        "stepped_equals_in_turn": bool(torch.equal(img, img_t))
        and int(rays) == int(rays_t) and launches == launches_t,
        "within_2e-6_of_one_card": err <= 2e-6 and int(rays) == rays_one,
        "second_call_copies_and_captures_nothing":
        counts["captures"] == 0 and counts["copies"] == 0
        and counts["replays"] > 0}
    record = {
        "shape": mesh.shape,
        "devices": sorted({str(d) for d in mesh.devices.flat}),
        "stepped_s": [r[1] for r in runs["stepped"]],
        "in_turn_s": [r[1] for r in runs["in_turn"]],
        "first_call_s": {k: v[1] for k, v in first.items()},
        "first_call": {k: v[2] for k, v in first.items()},
        "per_call": counts, "in_turn_per_call": counts_t,
        "max_rel_err": err, "rays": int(rays), "rays_one_card": rays_one,
        "launches": launches, **checks}
    return (img, rays), launches, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    cards = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    world, lens = procedural.room_scene(grid=6, subdivisions=4)
    scene = world.build(dev)
    la = LensArrays.from_lens(lens, dev)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    w, spp = args.size, args.spp
    h = args.height or w
    one = lambda: render_spp(scene, la, h, w, 0, spp, cfg)
    one()  # warm-up: the captures
    one_s = []
    for _ in range(args.reps):
        (acc, rays_one), secs, _, _ = timed_run(one)
        one_s.append(secs)
    ref, rays_one = acc / spp, int(rays_one)
    out = {"cards": cards, "width": w, "height": h, "spp": spp,
           "triangles": scene.num_tris, "one_card_s": one_s, "meshes": []}
    ok = True
    for name, mesh in (("cuda:0 x4", make_mesh([dev] * 4, sp=2)),
                       ("every card", make_mesh())):
        _, _, rec = compare(scene, la, h, w, spp, cfg, mesh, ref, rays_one,
                            args.reps)
        ok &= all(rec[k] for k in CHECKS)
        best = {k: min(rec[f"{k}_s"]) / min(one_s)
                for k in ("stepped", "in_turn")}
        out["meshes"].append({
            "mesh": name, **rec,
            "stepped_vs_one_card": best["stepped"],
            "in_turn_vs_one_card": best["in_turn"]})
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
