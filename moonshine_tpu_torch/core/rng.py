"""Counter-based per-lane RNG (port of moonshine_tpu/core/rng.py).

The reference's PCG-RXS-M-XS stream keyed by (sample, x, y), bit for bit.
torch has no uint32 add or right shift, so states are int64 tensors
holding uint32 values, masked to 32 bits after every multiply and add.
Products stay below 2^62 (multipliers are < 2^30), so nothing overflows
int64, and the arithmetic is the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_LCG_MULT = 747796405
_LCG_INC = 2891336453
_RXS_MULT = 277803737


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _lcg(a: torch.Tensor) -> torch.Tensor:
    return (a * _LCG_MULT + _LCG_INC) & _MASK


def _rxs_m_xs(a: torch.Tensor) -> torch.Tensor:
    b = (((a >> ((a >> 28) + 4)) ^ a) * _RXS_MULT) & _MASK
    return (b >> 22) ^ b


def hash_pcg(a: torch.Tensor) -> torch.Tensor:
    """One-shot PCG hash of uint32 values held in int64."""
    return _rxs_m_xs(_lcg(a))


def seed(sample_index, x, y) -> torch.Tensor:
    """Per-lane states from (sample index, pixel x, pixel y)
    (Rng::fromSeed, random.hlsl:28-31)."""
    x = _u32(x)
    device = x.device
    y = _u32(y, device)
    s = _u32(sample_index, device)
    return hash_pcg((s + hash_pcg((x + hash_pcg(y)) & _MASK)) & _MASK)


def next_float(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance each lane; return (new_state, float32 uniform in [0, 1)) from
    the top 24 bits of the permuted state (exact in float32)."""
    state = _lcg(state)
    bits = _rxs_m_xs(state)
    return state, (bits >> 8).to(torch.float32) * (2.0**-24)


def next_float2(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two uniforms per lane; the result has trailing dim 2."""
    state, a = next_float(state)
    state, b = next_float(state)
    return state, torch.stack([a, b], dim=-1)
