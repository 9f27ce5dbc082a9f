"""The online viewer's engine: moonshine_tpu_torch/engine/engine.py
`Engine`, which render/viewer.py drives, with the configuration's
PathConfig, the scene entered through its handles
(portbench/frozen/engine_handles.py), one sensor of the viewport's size
and one lens. Set-up builds the scene (`Engine._ensure_scene`, as the
first frame would: `build_s`) and renders one frame (`first_frame_s`:
its graph captures), then resets the sensor. A unit is one frame:
`Engine.render(sensor, lens, spp, wait=False)` followed by a device
synchronise, the moment the frame is ready on the card (the upstream
viewer blits it there and never reads it back); frames run closed-loop
into the one sensor with a still camera. `calls["engine_render"]` is the
host-clock time until `render` returns."""

from __future__ import annotations

import time

import numpy as np

from ..frozen.engine_handles import enter


class Driver:
    def __init__(self, engine, sensor, lens, config, device):
        self.engine, self.sensor, self.lens = engine, sensor, lens
        self.samples_per_unit = config["spp"]
        self.cuda = device != "cpu"
        self.calls = {"engine_render": []}

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def unit(self) -> None:
        t = time.perf_counter()
        self.engine.render(self.sensor, self.lens, self.samples_per_unit,
                           wait=False)
        self.calls["engine_render"].append(time.perf_counter() - t)
        self._sync()

    def outputs(self) -> dict:
        """The sensor's running mean and the samples it holds."""
        image = self.engine.get_sensor_data(self.sensor)[..., :3]
        return dict(images=[np.ascontiguousarray(image)],
                    held=[self.engine.sample_count(self.sensor)])

    def forget(self) -> None:
        """Restart the sensor's accumulation and the call times: the
        window's frames accumulate from sample 0."""
        self.engine.reset_sensor(self.sensor)
        self.calls = {"engine_render": []}

    def close(self) -> None:
        self.engine = None


def setup(desc, config, workdir, device, spans) -> Driver:
    from moonshine_tpu_torch.engine import Engine
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.scene.types import Lens

    t = time.perf_counter()
    engine = Engine(config=PathConfig(
        max_bounces=config["max_bounces"],
        env_samples_per_bounce=config["env_samples_per_bounce"],
        mesh_samples_per_bounce=config["mesh_samples_per_bounce"]),
        device=device)
    enter(engine, desc)
    sensor = engine.create_sensor(config["width"], config["height"])
    lens = engine.create_lens(Lens(**desc["lens"]))
    spans["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    with engine._lock:  # what render does before its first frame
        engine._ensure_scene()
    driver = Driver(engine, sensor, lens, config, device)
    driver._sync()
    spans["build_s"] = time.perf_counter() - t
    return driver
