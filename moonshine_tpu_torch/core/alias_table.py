"""Alias-method discrete sampling (port of moonshine_tpu/core/alias_table.py).

`build` is Vose's algorithm on the host in numpy (alias_table.zig:37-127);
`sample` is the batched draw in torch (sampleAlias, mappings.hlsl:114-126).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mappings import coin_flip_remap


class AliasTable(NamedTuple):
    """select[i] = probability of keeping bucket i; alias[i] = fallback
    bucket. `weight_sum` is the unnormalised total weight, `count` the
    number of entries."""

    select: np.ndarray  # [n] float32
    alias: np.ndarray  # [n] uint32
    weight_sum: float
    count: int


def build(weights: np.ndarray) -> AliasTable:
    """Vose's algorithm over nonnegative weights."""
    weights = np.asarray(weights, np.float64)
    n = len(weights)
    total = float(weights.sum())
    select = np.ones(max(n, 1), np.float64)
    alias = np.arange(max(n, 1), dtype=np.uint32)
    if n > 0 and total > 0.0:
        scaled = weights * (n / total)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            lo = small.pop()
            hi = large.pop()
            select[lo] = scaled[lo]
            alias[lo] = hi
            scaled[hi] = (scaled[hi] + scaled[lo]) - 1.0
            (small if scaled[hi] < 1.0 else large).append(hi)
        for i in large + small:
            select[i] = 1.0
    return AliasTable(select=select.astype(np.float32), alias=alias,
                      weight_sum=total, count=n)


def sample(select: torch.Tensor, alias: torch.Tensor, count: int, rand):
    """Batched draw: rand [...] in [0, 1) -> (bucket index [...] int64,
    remapped rand). Reuses the random number twice like sampleAlias.
    `alias` is an int64 tensor of fallback buckets."""
    scaled = rand * float(count)
    idx = torch.clamp_max(scaled.to(torch.int64), count - 1)
    rand = scaled - torch.floor(scaled)
    keep, rand = coin_flip_remap(select[idx], rand)
    return torch.where(keep, idx, alias[idx]), rand
