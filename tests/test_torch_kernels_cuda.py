"""The CUDA kernels (packet, treelet and format-V traversal, the slab and
ALU microbenchmarks, the quantised-row decode probe) against their plain
torch versions, on a GPU only (marked `cuda`; each test skips when torch
sees no CUDA device).

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py makes the same comparison at the render's real shapes."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import native, packet, treelet, vpacket
from moonshine_tpu_torch.accel.wide import build_wide
from moonshine_tpu_torch.scripts import probe_bitcast, profile_vpu

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(device, n_tris=700, cap=12, width=16, n_rays=5000, seed=3,
           max_rows=None):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 4 + rs.randn(n_tris, 3, 3) * 0.5
            ).astype(np.float32)
    wbvh = build_wide(tris, leaf_cap=cap, width=width, device=device,
                      max_rows=max_rows)
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


def test_stack_capacity(cuda):
    """Both kernels hold the reference's VMEM-class stack of 512."""
    libs = native.build_all()
    assert libs["traverse"].stack_capacity == packet.STACK_DEPTH == 512
    assert libs["treelet"].stack_capacity == 512
    assert libs["vpacket"].stack_capacity == 512


@pytest.mark.parametrize("max_rows", [48, 6])
def test_treelet_kernels_match_plain(cuda, max_rows):
    """The treelet kernel against its plain version on 8-wide / 8-slot
    trees of many treelets (max_rows=6 gives K > 32): the same hits, t, u,
    v bit for bit (same expressions, same per-lane visit order), and the
    same occlusion."""
    w, o, d, active, t_max = _scene(cuda, n_tris=1500, cap=8, width=8,
                                    max_rows=max_rows)
    assert treelet.available(w)
    got = treelet.closest_hit_treelet(w, o, d, 1e12, active_in=active)
    want = treelet.closest_hit_treelet_plain(w, o, d, 1e12, active_in=active)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    occ = treelet.any_hit_treelet(w, o, d, t_max, active_in=active)
    assert torch.equal(occ, treelet.any_hit_treelet_plain(
        w, o, d, t_max, active_in=active))
    assert torch.equal(occ, packet.any_hit_plain(w, o, d, t_max,
                                                 active_in=active))
    pk = packet.closest_hit_packet(w, o, d, 1e12, active_in=active)
    assert torch.equal(got.t, pk.t)


def test_treelet_launch_counters(cuda):
    w, o, d, active, t_max = _scene(cuda, n_tris=1500, cap=8, width=8,
                                    max_rows=48)
    treelet.reset_launch_counts()
    treelet.closest_hit_treelet(w, o, d, 1e12, active_in=active)
    treelet.any_hit_treelet(w, o, d, t_max, active_in=active)
    treelet.closest_hit_treelet_plain(w, o, d, 1e12)  # never counts
    assert treelet.LAUNCHES == {"treelet_closest_hit": 1,
                                "treelet_any_hit": 1}


@pytest.mark.parametrize("cap,width", [(12, 16), (24, 24), (8, 8)])
def test_v_kernels_match_plain(cuda, cap, width):
    """The format-V kernels equal their plain versions bit for bit, and
    the packet kernel on the same tree in t, tri, u, v and occlusion."""
    w, o, d, active, t_max = _scene(cuda, cap=cap, width=width)
    v = vpacket.v_from_wide(w)
    got = vpacket.closest_hit_vpacket(v, o, d, 1e12, active_in=active)
    want = vpacket.closest_hit_plain(v, o, d, 1e12, active_in=active)
    pk = packet.closest_hit_packet(w, o, d, 1e12, active_in=active)
    torch.cuda.synchronize()
    for g, x, y in zip(got, want, pk):
        assert torch.equal(g, x) and torch.equal(g, y)
    occ = vpacket.any_hit_vpacket(v, o, d, t_max, active_in=active)
    assert occ.dtype == torch.bool
    assert torch.equal(occ, vpacket.any_hit_plain(v, o, d, t_max,
                                                  active_in=active))
    assert torch.equal(occ, packet.any_hit_packet(w, o, d, t_max,
                                                  active_in=active))
    hbm = vpacket.closest_hit_vpacket_hbm(v, o, d, 1e12, active_in=active)
    for g, x in zip(got, hbm):
        assert torch.equal(g, x)


def test_v_launch_counters(cuda):
    w, o, d, active, t_max = _scene(cuda)
    v = vpacket.v_from_wide(w)
    vpacket.reset_launch_counts()
    vpacket.closest_hit_vpacket(v, o, d, 1e12)
    vpacket.any_hit_vpacket_hbm(v, o, d, t_max, active_in=active)
    vpacket.closest_hit_plain(v, o, d, 1e12)  # never counts
    assert vpacket.LAUNCHES == {"v_closest_hit": 1, "v_any_hit": 1}


@pytest.mark.parametrize("seed", [None, 1])
def test_vpu_kernels_match_plain(cuda, seed):
    """Every configuration of the reference's main(), on its inputs and on
    seeded ones where lanes hit: equal slab counts, bit-equal ALU
    outputs; each wrapper counts its launches."""
    profile_vpu.reset_launch_counts()
    for _, dt, fma_form, packed in profile_vpu.SLAB_CONFIGS:
        rows, planes = profile_vpu.slab_inputs(dt, cuda, seed=seed)
        got = profile_vpu.slab(rows, planes, fma_form, packed, 20)
        want = profile_vpu.slab_plain(rows, planes, fma_form, packed, 20)
        assert got.dtype == torch.int32 and int(got) == int(want)
        assert (int(got) > 0) == (seed is not None)
    for _, dt, r in profile_vpu.ALU_CONFIGS:
        a, b = profile_vpu.alu_inputs(dt, r, cuda, seed=seed)
        assert torch.equal(profile_vpu.alu(a, b, 20),
                           profile_vpu.alu_plain(a, b, 20))
    assert profile_vpu.LAUNCHES == {"vpu_slab": 5, "vpu_alu": 4}


def test_bitcast_kernel_matches_plain(cuda):
    """The decode probe at all six widths, on the reference's rows and on
    seeded ones, bit for bit; one launch counted per call."""
    probe_bitcast.reset_launch_counts()
    for rowlen in probe_bitcast.ROWLENS:
        for rows in (probe_bitcast.reference_rows(rowlen, cuda),
                     probe_bitcast.seeded_rows(rowlen, rowlen, cuda)):
            got = probe_bitcast.decode_rows(rows)
            want = probe_bitcast.decode_rows_plain(rows)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert probe_bitcast.LAUNCHES == {"bitcast": 12}
    with pytest.raises(ValueError):
        probe_bitcast.decode_rows(rows[:, ::2])
