"""The CUDA traversal kernels against their plain torch versions, on a
GPU only (marked `cuda`; each test skips when torch sees no CUDA device).

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py makes the same comparison at the render's real shapes."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import packet
from moonshine_tpu_torch.accel.wide import build_wide

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(device, n_tris=700, cap=12, width=16, n_rays=5000, seed=3):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 4 + rs.randn(n_tris, 3, 3) * 0.5
            ).astype(np.float32)
    wbvh = build_wide(tris, leaf_cap=cap, width=width, device=device)
    o = torch.from_numpy((rs.randn(n_rays, 3) * 6).astype(np.float32))
    d = torch.from_numpy(rs.randn(n_rays, 3).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    active = torch.from_numpy(rs.rand(n_rays) > 0.2)
    t_max = torch.from_numpy((rs.rand(n_rays) * 10).astype(np.float32))
    return wbvh, o.to(device), d.to(device), active.to(device), \
        t_max.to(device)


@pytest.mark.parametrize("cap,width", [(12, 16), (24, 24)])
def test_closest_hit_kernel_matches_plain(cuda, cap, width):
    w, o, d, active, _ = _scene(cuda, cap=cap, width=width)
    got = packet.closest_hit_packet(w, o, d, 1e12, active_in=active)
    want = packet.closest_hit_plain(w, o, d, 1e12, active_in=active)
    torch.cuda.synchronize()
    assert torch.equal(got.tri >= 0, want.tri >= 0)
    torch.testing.assert_close(got.t, want.t, rtol=1e-5, atol=0)
    same = got.tri == want.tri
    assert same.float().mean() > 0.999
    torch.testing.assert_close(got.u[same], want.u[same], rtol=0, atol=1e-4)


@pytest.mark.parametrize("cap,width", [(12, 16), (24, 24)])
def test_any_hit_kernel_matches_plain(cuda, cap, width):
    w, o, d, active, t_max = _scene(cuda, cap=cap, width=width)
    got = packet.any_hit_packet(w, o, d, t_max, active_in=active)
    want = packet.any_hit_plain(w, o, d, t_max, active_in=active)
    assert got.dtype == torch.bool
    assert torch.equal(got, want)


def test_launch_counters(cuda):
    w, o, d, active, t_max = _scene(cuda)
    packet.reset_launch_counts()
    packet.closest_hit_packet(w, o, d, 1e12)
    packet.any_hit_packet(w, o, d, t_max, active_in=active)
    packet.any_hit_packet(w, o, d, t_max)
    packet.closest_hit_plain(w, o, d, 1e12)  # the plain version never counts
    assert packet.LAUNCHES == {"closest_hit": 1, "any_hit": 2}
