"""The reference's sky table (reference/sky.py on any device, and its
restated Vose build) against the program's host build, bit for bit; the
run's exposure leaves the sky's sampling table as it is."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.core import alias_table as program_alias
from moonshine_tpu_torch.lights.envmap import build_envmap
from portbench.reference import alias_table, sky
from portbench.scenes.room import exposure, make
from portbench.scenes.room import sky as make_sky


def _same(a: dict, b: dict) -> bool:
    return (all(np.array_equal(a[k], b[k]) for k in ("rgbl", "select",
                                                     "alias"))
            and a["integral"] == b["integral"])


@pytest.mark.parametrize("shape", [(16, 32), (64, 128), (128, 256)])
def test_sky_table_equals_the_programs_host_build(shape):
    equirect = make_sky(2**31 + shape[0], *shape)
    assert _same(sky.build(equirect, "cpu"), build_envmap(equirect))


@pytest.mark.parametrize("case", ["uniform", "skewed", "zeros", "ones",
                                  "one_weight"])
def test_alias_build_equals_the_programs(case):
    rs = np.random.default_rng(7)
    weights = {"uniform": rs.random(4096), "skewed": rs.random(4096) ** 12,
               "zeros": np.zeros(5), "ones": np.ones(9),
               "one_weight": np.array([0.0, 0.0, 2.5, 0.0])}[case]
    a, b = program_alias.build(weights), alias_table.build(weights)
    assert np.array_equal(a.select, b.select)
    assert np.array_equal(a.alias, b.alias)
    assert (a.weight_sum, a.count) == (b.weight_sum, b.count)


def test_exposure_leaves_the_sampling_table_unchanged():
    """Seeds of every exposure give the same alias table, the same
    integral over the exposure, and texels scaled exactly."""
    seeds = {}
    for seed in range(2**31, 2**31 + 64):
        seeds.setdefault(float(exposure(seed)), seed)
    assert sorted(seeds) == [0.25, 0.5, 1.0, 2.0, 4.0]
    base = build_envmap(make_sky(0, 64, 128))
    for e, seed in seeds.items():
        got = build_envmap(make(seed, grid=2, subdivisions=1, sky_height=64,
                                sky_width=128)["sky"])
        assert np.array_equal(got["select"], base["select"])
        assert np.array_equal(got["alias"], base["alias"])
        assert np.array_equal(got["rgbl"], base["rgbl"] * np.float32(e))
        assert got["integral"] == base["integral"] * e


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 3000000101, 5])
def test_sky_table_on_the_card_equals_the_host_build(cuda, seed):
    """The cells' 2048x1024 sky, resampled on the card."""
    equirect = make_sky(seed, 1024, 2048)
    assert _same(sky.build(equirect, "cuda"), build_envmap(equirect))
