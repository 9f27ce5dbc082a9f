"""The offline CLI, driven as moonshine_tpu_torch/render/offline.py
`main` drives it: the scene written as a .glb and its sky as a ZIP EXR
(under `workdir`), then `world_from_glb`, `lens_from_glb`, `read_exr`
and `set_background` (its "load scene" phase: `ingest_s`) and
`World.build` (`build_s`) at set-up. A unit is one image: `render` of
`spp` samples into a fresh sensor (samples 0 to spp - 1, as each CLI
invocation renders them), ended by the image's read back to the host.
The EXR write of the image is left out."""

from __future__ import annotations

import os
import time

from ..frozen.exr_writer import write_exr
from ..frozen.glb_scene import scene_glb


class Driver:
    def __init__(self, scene, lens, config, device):
        from moonshine_tpu_torch.integrator.path import PathConfig

        self.scene, self.lens, self.device = scene, lens, device
        self.height, self.width = config["height"], config["width"]
        self.samples_per_unit = config["spp"]
        self.cfg = PathConfig(
            max_bounces=config["max_bounces"],
            env_samples_per_bounce=config["env_samples_per_bounce"],
            mesh_samples_per_bounce=config["mesh_samples_per_bounce"])
        self.calls: dict = {}
        self.images: list = []
        self.held: list = []

    def unit(self) -> None:
        from moonshine_tpu_torch.render.renderer import render

        sensor, _ = render(self.scene, self.lens, self.height, self.width,
                           spp=self.samples_per_unit, cfg=self.cfg)
        self.images.append(sensor.image.cpu().numpy())
        self.held.append(sensor.sample_count)

    def outputs(self) -> dict:
        """Every image of the window and the samples each holds."""
        return dict(images=self.images, held=self.held)

    def forget(self) -> None:
        """Drop the warm-up image."""
        self.images, self.held = [], []

    def close(self) -> None:
        self.scene = self.images = None


def setup(desc, config, workdir, device, spans) -> Driver:
    import torch

    from moonshine_tpu_torch.io.exr import read_exr
    from moonshine_tpu_torch.scene.gltf import lens_from_glb, world_from_glb

    t = time.perf_counter()
    glb = os.path.join(workdir, "scene.glb")
    exr = os.path.join(workdir, "sky.exr")
    with open(glb, "wb") as f:
        f.write(scene_glb(desc))
    write_exr(exr, desc["sky"])
    spans["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    world = world_from_glb(glb)
    lens = lens_from_glb(glb)
    sky = read_exr(exr)
    world.set_background(sky[..., :3])
    spans["ingest_s"] = time.perf_counter() - t

    t = time.perf_counter()
    scene = world.build(device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    spans["build_s"] = time.perf_counter() - t
    return Driver(scene, lens, config, device)
