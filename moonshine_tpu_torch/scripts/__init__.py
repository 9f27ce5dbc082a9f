"""Measurement entry points of the port, each run as a module on the card:

    python -m moonshine_tpu_torch.scripts.profile_vpacket [--full]
    python -m moonshine_tpu_torch.scripts.profile_vpu
    python -m moonshine_tpu_torch.scripts.probe_bitcast
    python -m moonshine_tpu_torch.scripts.compare_traverse [--against DIR]
    python -m moonshine_tpu_torch.scripts.compare_treelet [--against DIR ...]
    python -m moonshine_tpu_torch.scripts.compare_tlas [--against DIR ...]
    python -m moonshine_tpu_torch.scripts.compare_shade [--against DIR ...]
    python -m moonshine_tpu_torch.scripts.compare_sort [--against DIR ...]
    python -m moonshine_tpu_torch.scripts.compare_frame [--against DIR ...]
        [--accumulate-forms] [--count-forms]
    python -m moonshine_tpu_torch.scripts.compare_loop [--against DIR ...]
        [--blocks 4,8,16,32]

`cuda_ms` is their kernel timer (CUDA events around many launches);
`shadow_batch` builds the any-hit launch that the 1080p frame times;
`skybox` is the offline cell's seeded sky.
"""

from __future__ import annotations

import time

import numpy as np

# clock rate assumed to turn a hold time into torch.cuda._sleep cycles (at
# or above the H100's boost clock, so a hold lasts at least as asked)
_HOLD_HZ = 2.0e9
_HOLD_MAX_S = 0.1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time in ms of fn over `reps` calls after one warm-up
    call; needs a CUDA device.

    The stream is held by a spin kernel while the host queues the `reps`
    calls (as long as the warm-up call took on the host, times two, at
    most 0.1 s), so the events time the device's work back to back, not
    the host's gaps between launches: a 0.06 ms kernel whose Python
    wrapper takes longer than that on a busy host would otherwise read as
    the wrapper's time."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, _HOLD_MAX_S) * _HOLD_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def shadow_batch(o, d, hit, inf_t: float = 1.0e12):
    """The main path's any-hit batch for a bounce whose closest hits are
    `hit` (room_184k's camera rays): one env shadow ray (a seeded
    direction on the camera's side, t_max `inf_t`) then one mesh-light
    shadow ray (to the ceiling light, t_max just short of it) per lane,
    concatenated as integrator/path.py does it, so 2N lanes, dead where
    the closest-hit ray missed. Returns (o, d, t_max, active)."""
    import torch

    dev = o.device
    n = o.shape[0]
    p = o + hit.t[:, None].clamp_max(1e6) * d - 1e-4 * d
    to_l = torch.tensor([0.0, 0.0, 13.5], device=dev) - p
    dist = torch.linalg.norm(to_l, dim=1)
    env_d = np.random.RandomState(11).randn(n, 3).astype(np.float32)
    env_d = torch.from_numpy(env_d / np.linalg.norm(env_d, axis=1,
                                                    keepdims=True)).to(dev)
    env_d = torch.where((env_d * d).sum(1, keepdim=True) > 0, -env_d, env_d)
    return (torch.cat([p, p]), torch.cat([env_d, to_l / dist[:, None]]),
            torch.cat([torch.full((n,), inf_t, device=dev),
                       dist * (1 - 1e-4)]),
            (hit.tri >= 0).repeat(2))


def skybox():
    """A 2048x1024 equirectangular sky: a vertical gradient, seeded
    low-frequency clouds and a small bright sun, float32 [h, w, 3]."""
    h, w = 1024, 2048
    rs = np.random.RandomState(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    elev = 1.0 - yy / h
    sky = np.stack([0.25 + 0.35 * elev, 0.35 + 0.4 * elev,
                    0.5 + 0.45 * elev], -1)
    coarse = rs.rand(8, 16, 1).astype(np.float32)
    sky *= 0.8 + 0.4 * np.repeat(np.repeat(coarse, h // 8, 0), w // 16, 1)
    sky[h // 5:h // 5 + 12, w // 3:w // 3 + 12] = 400.0
    return sky.astype(np.float32)
