"""Offline (headless) renderer CLI (port of moonshine_tpu/render/offline.py).

    python -m moonshine_tpu_torch.render.offline scene.glb sky.exr out.exr \\
        [--spp 16] [--width 1280] [--height 720] [--max-bounces 1024] \\
        [--env-samples 1] [--mesh-samples 1] [--mesh auto|SP,DP]

Loads a glTF scene and its camera, an equirectangular EXR skybox as the
background, builds the device scene, renders with `render` (one sample
at a time through the fused bounce loop, as the reference does, at any
frame size) and writes the image as a 3-channel float ZIP EXR, printing
the time of each phase as the upstream offline frontend's IntervalLogger
does. It renders on the CUDA device; without one the build raises.
`main(argv, device=...)` takes another torch device for callers that ask
for one (the CPU tests). `--mesh` renders through
`parallel.render_sharded` on a device mesh: "auto" (every visible
device) or "SP,DP" sample and row shard counts; the height must divide
by DP and spp by SP.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..integrator.path import PathConfig
from ..io.exr import read_exr, write_exr
from ..parallel import mesh_from_spec, render_sharded
from ..scene.gltf import lens_from_glb, world_from_glb
from .camera import LensArrays
from .renderer import render


class IntervalLogger:
    """Prints each phase's wall time since the previous one."""

    def __init__(self):
        self.t = time.monotonic()

    def log(self, phase: str):
        now = time.monotonic()
        print(f"{phase}: {now - self.t:.3f}s", flush=True)
        self.t = now


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="moonshine-offline",
        description="headless path tracer on one CUDA device",
    )
    p.add_argument("glb", help="glTF scene (.glb or .gltf)")
    p.add_argument("skybox", help="equirectangular EXR environment map")
    p.add_argument("out", help="output EXR path")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--max-bounces", type=int, default=1024)
    p.add_argument("--env-samples", type=int, default=1)
    p.add_argument("--mesh-samples", type=int, default=1)
    p.add_argument(
        "--mesh", default=None, metavar="SP,DP",
        help="render on a device mesh: 'auto' (all devices) or 'SP,DP' "
             "sample/row shard counts (e.g. '2,4'); height must divide by "
             "DP and spp by SP")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> int:
    args = parse_args(argv)
    timer = IntervalLogger()

    world = world_from_glb(args.glb)
    lens = lens_from_glb(args.glb)
    sky = read_exr(args.skybox)
    world.set_background(sky[..., :3])
    timer.log("load scene")

    scene = world.build(device)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    timer.log("build device scene (BVH + atlas + envmap)")

    cfg = PathConfig(
        max_bounces=args.max_bounces,
        env_samples_per_bounce=args.env_samples,
        mesh_samples_per_bounce=args.mesh_samples,
    )
    if args.mesh:
        mesh = mesh_from_spec(args.mesh, scene.device)
        image, rays = render_sharded(
            scene, LensArrays.from_lens(lens, scene.device), args.height,
            args.width, args.spp, cfg, mesh)
        image = image.cpu().numpy()
        timer.log(f"render {args.spp} spp on mesh sp={mesh.shape['sp']} "
                  f"dp={mesh.shape['dp']} ({int(rays) / 1e6:.1f} Mrays)")
    else:
        sensor, rays = render(scene, lens, args.height, args.width,
                              spp=args.spp, cfg=cfg)
        image = sensor.image.cpu().numpy()  # waits for the device's work
        timer.log(f"render {args.spp} spp ({rays / 1e6:.1f} Mrays)")

    write_exr(args.out, image)
    timer.log("write exr")
    return 0


if __name__ == "__main__":
    sys.exit(main())
