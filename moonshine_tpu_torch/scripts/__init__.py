"""Measurement entry points of the port, each run as a module on the card:

    python -m moonshine_tpu_torch.scripts.profile_vpacket [--full]
    python -m moonshine_tpu_torch.scripts.profile_vpu
    python -m moonshine_tpu_torch.scripts.probe_bitcast

`cuda_ms` is their kernel timer (CUDA events around many launches).
"""

from __future__ import annotations

import time

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
