"""Progressive accumulation sensor (port of moonshine_tpu/render/sensor.py;
parity: core/Sensor.zig and main.hlsl:43-51). The stored image is the
running mean of all samples so far."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Sensor(NamedTuple):
    image: torch.Tensor  # [H, W, 3] f32 running mean
    sample_count: int

    @staticmethod
    def create(height: int, width: int, device="cpu") -> "Sensor":
        return Sensor(image=torch.zeros((height, width, 3),
                                        dtype=torch.float32, device=device),
                      sample_count=0)

    def clear(self) -> "Sensor":
        """Restart accumulation; the first accumulate overwrites."""
        return self._replace(sample_count=0)


def accumulate(sensor: Sensor, sample_sum: torch.Tensor,
               samples_per_run: int) -> Sensor:
    """Fold `samples_per_run` new samples (their sum) into the mean."""
    count = sensor.sample_count
    if count == 0:
        image = sample_sum / samples_per_run
    else:
        image = sensor.image + (sample_sum - sensor.image * samples_per_run
                                ) / float(count + samples_per_run)
    return Sensor(image=image, sample_count=count + samples_per_run)
