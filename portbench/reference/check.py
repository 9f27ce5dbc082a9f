"""The comparison that decides a run's `correct`.

After the window, a sample of the frame's pixels drawn from the seed is
worked out again by the plain reference (tracer.py) over the samples
that the program folded into them, and each image the window produced
is held to it at those pixels. The numbers compared, each against the
limit the configuration's file states (`check.limits`):

  off_share  the share of the sampled pixels whose widest channel gap,
             |program - reference| / (|reference| + 1e-3), passes 1e-3
             (the worst image where the window made several)
  mean_gap   |sum of program - sum of reference| / sum of |reference|
             over the sampled pixels and channels (the worst image)
  samples_gap  the samples the window's images should hold less those
             they hold, in absolute value (exact: limit 0)
  images_missing  1 where the window left no image to judge (limit 0)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import scene as S
from . import tracer as T

PIXEL_TOL = 1e-3


def sample_pixels(seed: int, height: int, width: int, count: int):
    """`count` distinct flat pixel ids (y * width + x), drawn from the
    seed, in ascending order."""
    rs = np.random.default_rng([seed % 2**63, 0x706978])
    return np.sort(rs.choice(height * width, size=min(count, height * width),
                             replace=False))


def reference_values(desc: dict, config: dict, flat_ids, n_samples: int,
                     device, prec: T.Precision = T.FLOAT32,
                     phases: dict | None = None):
    """[P, 3]: the sensor's running mean over samples 0 .. n_samples - 1
    at the pixels `flat_ids`, as the reference makes it; `phases` gets
    the seconds of its scene build (`reference_scene_s`)."""
    t = time.perf_counter()
    sc = S.build(desc, config["reference_materials"] == "engine", device)
    if phases is not None:
        phases["reference_scene_s"] = time.perf_counter() - t
    cfg = T.Config(config["max_bounces"], config["env_samples_per_bounce"],
                   config["mesh_samples_per_bounce"])
    lens = T.Lens.of(desc["lens"], device)
    out = T.pixels(sc, cfg, lens, config["width"], config["height"],
                   flat_ids, np.arange(n_samples), config["flip_image"],
                   prec)
    return out.cpu().numpy()


def gaps(got: np.ndarray, ref: np.ndarray) -> dict:
    """off_share and mean_gap of one image's values at the sampled
    pixels ([P, 3] each)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    pixel = (np.abs(got - ref) / (np.abs(ref) + 1e-3)).max(axis=1)
    pixel = np.where(np.isfinite(pixel), pixel, np.inf)
    total = float(np.abs(ref).sum())
    mean_gap = abs(float(got.sum()) - float(ref.sum())) / max(total, 1e-30)
    return dict(off_share=float(np.mean(pixel > PIXEL_TOL)),
                mean_gap=mean_gap if np.isfinite(mean_gap) else np.inf)


def judge(images, expected_samples: int, held_samples: int, ref,
          flat_ids, limits: dict) -> tuple[dict, int]:
    """({name: (value, limit)}, images that fail) of the window's images
    (each [H, W, 3]) against the reference's values at flat_ids."""
    worst = dict(off_share=0.0, mean_gap=0.0)
    failed = 0
    for image in images:
        got = np.asarray(image, np.float32).reshape(-1, 3)[flat_ids]
        g = gaps(got, ref)
        if any(g[k] > limits[k] for k in g):
            failed += 1
        worst = {k: max(worst[k], g[k]) for k in worst}
    numbers = {k: (v, limits[k]) for k, v in worst.items()}
    numbers["samples_gap"] = (abs(expected_samples - held_samples), 0)
    numbers["images_missing"] = (0 if images else 1, 0)
    return numbers, failed


def correct(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())


def free_device() -> None:
    """Let go of what the program left on the card before the reference
    runs."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
