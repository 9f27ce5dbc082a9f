"""render_sharded across every visible card against one card:

    python -m moonshine_tpu_torch.scripts.time_sharded [--size 512]
        [--spp 4] [--reps 2]

On room_184k (procedural.room_scene(grid=6, subdivisions=4), SAH
24/24), PathConfig(max_bounces=4, one env and one mesh-light sample a
bounce), SIZE x SIZE at SPP samples: `render` on cuda:0, then
`render_sharded` on `make_mesh()` (every visible card, each shard under
its own) and on cuda:0 repeated as many times (the same shards, all on
one card). Each is run once to warm up, then REPS times,
timed to the end of its device work. Every sharded image is held
against the one-card render within 2e-6 x max(1, |pixel|) and equal ray
counts, and the packet kernels' launches are counted on each card's
shards. Prints the card's name and power limit, then one JSON line;
exits 1 if an image differs. Needs at least one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..accel import packet
from ..integrator.path import PathConfig
from ..parallel import make_mesh, render_sharded
from ..render.camera import LensArrays
from ..render.renderer import render
from ..scene import procedural


def _timed(fn, reps):
    """fn() once to warm up, then reps times; (last result, seconds of
    each run, every card synchronised at its end)."""
    fn()
    times = []
    for _ in range(reps):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        out = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        times.append(time.perf_counter() - t0)
    return out, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
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
    n, spp = args.size, args.spp
    (sensor, rays_one), one_s = _timed(
        lambda: render(scene, la, n, n, spp, cfg), args.reps)
    ref = sensor.image
    out = {"cards": cards, "size": n, "spp": spp,
           "triangles": scene.num_tris, "one_card_s": one_s, "meshes": []}
    ok = True
    for name, mesh in (("every card", make_mesh()),
                       ("cuda:0 repeated", make_mesh([dev] * cards))):
        packet.reset_launch_counts()
        (img, rays), secs = _timed(
            lambda: render_sharded(scene, la, n, n, spp, cfg, mesh),
            args.reps)
        err = float(((img - ref).abs() / ref.abs().clamp_min(1.0)).max())
        same = err <= 2e-6 and int(rays) == rays_one
        ok &= same
        out["meshes"].append({
            "mesh": name, "shape": mesh.shape,
            "devices": sorted({str(d) for d in mesh.devices.flat}),
            "s": secs, "vs_one_card": min(secs) / min(one_s),
            "max_rel_err": err, "rays": int(rays), "rays_one_card": rays_one,
            "launches": dict(packet.LAUNCHES), "runs": args.reps + 1,
            "equal": same})
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
