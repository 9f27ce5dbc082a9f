"""The CUDA kernels (packet, treelet and format-V traversal, the slab and
ALU microbenchmarks, the quantised-row decode probe) against their plain
torch versions, on a GPU only (marked `cuda`; each test skips when torch
sees no CUDA device).

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The packet and format-V kernels are held to their plain versions bit for
bit (t, tri, u, v, occlusion, ties included) over widths 8/16/24/32 x
leaf caps 1/7/12/24, n = 0/1/4099, mostly dead batches and a 497-entry
stack bound, and the V kernels also to the packet kernels; the treelet
walk on 8- and 16-wide trees, one treelet, a deep
stack bound and K beyond its shared memory; treelet phase 1 (pending
words and nearest treelets) over K and ray counts. chip_smoke.py makes
the same comparisons at the render's real shapes."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import native, packet, treelet, vpacket
from moonshine_tpu_torch.accel.wide import build_wide
from moonshine_tpu_torch.scripts import cuda_ms, probe_bitcast, profile_vpu

from test_torch_group_walk import CAPS, WIDTHS, tie_scene

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


def _tie_case(device, cap, width, n_rays=3000, seed=11):
    """tie_scene's tree and rays on `device`: exact equal-t ties, dead
    lanes, finite t_max."""
    tris, o, d, active, t_max = tie_scene(seed + cap + width, n_tris=700,
                                          n_rays=n_rays)
    wbvh = build_wide(tris, leaf_cap=cap, width=width, device=device)
    return wbvh, *(torch.from_numpy(x).to(device)
                   for x in (o, d, active, t_max))


def _assert_equal(got, want):
    torch.cuda.synchronize()
    for g, x in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == x.dtype and torch.equal(g, x)


GRID = [(cap, width) for cap in CAPS for width in WIDTHS]


@pytest.mark.parametrize("cap,width", GRID)
def test_closest_hit_kernel_matches_plain(cuda, cap, width):
    """t, tri, u, v bit for bit, equal-t ties included, with an unbounded
    and a per-lane t_max."""
    w, o, d, active, t_max = _tie_case(cuda, cap, width)
    for tm in (1e12, t_max):
        _assert_equal(
            packet.closest_hit_packet(w, o, d, tm, active_in=active),
            packet.closest_hit_plain(w, o, d, tm, active_in=active))


@pytest.mark.parametrize("cap,width", GRID)
def test_any_hit_kernel_matches_plain(cuda, cap, width):
    w, o, d, active, t_max = _tie_case(cuda, cap, width)
    got = packet.any_hit_packet(w, o, d, t_max, active_in=active)
    assert got.dtype == torch.bool
    _assert_equal(got, packet.any_hit_plain(w, o, d, t_max,
                                            active_in=active))


@pytest.mark.parametrize("n", [0, 1, 4099])
def test_kernels_on_small_and_ragged_batches(cuda, n):
    """No ray, one ray, and a count that no group count or fetch size
    divides; nothing is launched for n = 0."""
    w, o, d, active, t_max = _tie_case(cuda, 12, 24, n_rays=max(n, 1))
    o, d, active, t_max = o[:n], d[:n], active[:n], t_max[:n]
    packet.reset_launch_counts()
    _assert_equal(packet.closest_hit_packet(w, o, d, 1e12, active_in=active),
                  packet.closest_hit_plain(w, o, d, 1e12, active_in=active))
    _assert_equal(packet.any_hit_packet(w, o, d, t_max),
                  packet.any_hit_plain(w, o, d, t_max))
    assert packet.LAUNCHES == {"closest_hit": int(n > 0),
                               "any_hit": int(n > 0)}


@pytest.mark.parametrize("live", [0, 37, 700])
def test_kernels_on_mostly_dead_batches(cuda, live):
    """20,000 lanes of which `live` are active, as in the offline path's
    late segments, and a seventh of those with t_max <= 0: the warps
    retire dead lanes 32 at a time and hand the live ones to groups."""
    n = 20000
    w, o, d, _, t_max = _tie_case(cuda, 12, 24, n_rays=n)
    act = np.zeros(n, bool)
    act[np.random.RandomState(live).choice(n, live, replace=False)] = True
    active = torch.from_numpy(act).to(cuda)
    t_max = torch.where(torch.arange(n, device=cuda) % 7 == 0, -t_max, t_max)
    _assert_equal(packet.closest_hit_packet(w, o, d, t_max, active),
                  packet.closest_hit_plain(w, o, d, t_max, active))
    _assert_equal(packet.any_hit_packet(w, o, d, t_max, active),
                  packet.any_hit_plain(w, o, d, t_max, active))


def test_kernels_with_a_deep_stack_bound(cuda):
    """Stacks sized from a bound above 256 (so above 48 KB of shared
    memory a block). No tree small enough for a test has such a bound:
    max_stack = 31 * depth + 1 on a 32-wide tree needs depth 9, and the
    wide collapse of a few thousand triangles is 2-3 levels deep. So the
    case raises the tree's declared depth, which sizes the stacks as a
    real bound of 257-512 would; the hits must not change."""
    w, o, d, active, t_max = _tie_case(cuda, 7, 32)
    deep = w._replace(max_depth=16)
    layout = packet.kernel_layout(deep)
    assert deep.max_stack == layout.stack_depth == 497
    assert layout.shared_bytes > 48 * 1024
    _assert_equal(packet.closest_hit_packet(deep, o, d, 1e12, active),
                  packet.closest_hit_plain(w, o, d, 1e12, active))
    _assert_equal(packet.any_hit_packet(deep, o, d, t_max, active),
                  packet.any_hit_plain(w, o, d, t_max, active))


def test_shared_layout_matches_kernel(cuda):
    """The kernel's own count of its shared memory equals kernel_layout's,
    R counts the root and its internal children, and every width has its
    kernel (2 or 4 lanes a ray)."""
    lib = native.build_all(("traverse",))["traverse"]
    for cap, width in GRID:
        w, *_ = _tie_case(cuda, cap, width, n_rays=8)
        layout = packet.kernel_layout(w)
        assert lib.shared_bytes(layout.top_rows, w.nodes[0].numel(),
                                layout.stack_depth) == layout.shared_bytes
        assert lib.group_lanes(width) in (2, 4)
        root = w.nodes.reshape(w.num_nodes, -1)[0, 6 * width:7 * width]
        assert layout.top_rows == 1 + int((root >= 0).sum())


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


@pytest.mark.parametrize("case", ["16-wide", "7 slots", "one treelet",
                                  "deep bound", "many treelets"])
def test_treelet_kernels_on_more_trees(cuda, case):
    """The walk against its plain version bit for bit where its design
    branches: a 16-wide tree with 12 slots (float4 rows of other widths),
    7 slots (leaves read one float at a time), one treelet holding the
    whole tree (its stack bound is the tree's), a declared bound of 497
    (blocks shrink to 64 threads, over 48 KB of shared memory), and over
    2048 treelets, a leaf treelet per leaf (max_rows=1) on 20,000
    triangles."""
    width, cap, max_rows, n_tris = {
        "16-wide": (16, 12, 48, 1500), "7 slots": (8, 7, 48, 1500),
        "one treelet": (8, 8, 10**9, 1500), "deep bound": (8, 8, 48, 1500),
        "many treelets": (8, 8, 1, 20000)}[case]
    w, o, d, active, t_max = _scene(cuda, n_tris=n_tris, cap=cap,
                                    width=width, n_rays=3000,
                                    max_rows=max_rows)
    k = w.t_roots.shape[0]
    lib = native.treelet_lib()
    if case == "deep bound":
        w = w._replace(treelet_stack=497)
        assert lib.block(497) == 64
    else:
        assert lib.block(w.treelet_stack) == 128
    if case == "one treelet":
        assert k == 1 and w.treelet_stack == w.max_stack
    if case == "many treelets":
        assert k > 2048
    got = treelet.closest_hit_treelet(w, o, d, 1e12, active_in=active)
    want = treelet.closest_hit_treelet_plain(w, o, d, 1e12,
                                             active_in=active)
    _assert_equal(tuple(got), tuple(want))
    for tm in (t_max, 1e12):
        _assert_equal(
            treelet.any_hit_treelet(w, o, d, tm, active_in=active),
            treelet.any_hit_treelet_plain(w, o, d, tm, active_in=active))


def _pending_case(device, k, n, seed):
    """A tree whose treelet plan is replaced by k seeded boxes (phase 1
    reads only the boxes): duplicates (equal entry t), inverted boxes
    (never entered), rays inside boxes (entry 0), axis-parallel
    directions (safe_inv clamps), dead lanes, t_max <= 0, finite and
    1e12 t_max."""
    rs = np.random.RandomState(seed)
    w, *_ = _scene(device, n_tris=300, cap=8, width=8, n_rays=1)
    c = rs.randn(k, 3) * 4
    ext = rs.rand(k, 3) * 2 + 0.05
    lo, hi = c - ext, c + ext
    dup = rs.rand(k) < 0.2
    src = rs.randint(0, k, k)
    lo[dup], hi[dup] = lo[src[dup]], hi[src[dup]]
    inverted = rs.rand(k) < 0.1
    lo[inverted], hi[inverted] = 0.0, -1.0
    w = w._replace(t_roots=torch.arange(k, dtype=torch.int32, device=device),
                   t_lo=torch.tensor(lo, dtype=torch.float32, device=device),
                   t_hi=torch.tensor(hi, dtype=torch.float32, device=device))
    o = rs.randn(n, 3) * 5
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axis = rs.rand(n) < 0.2
    d[axis] = np.eye(3)[rs.randint(0, 3, int(axis.sum()))] * rs.choice(
        [-1.0, 1.0], (int(axis.sum()), 1))
    d[rs.rand(n) < 0.1, 1] = 0.0
    t = np.where(rs.rand(n) < 0.5, 1e12, rs.rand(n) * 8)
    t[rs.rand(n) < 0.2] = -1e30  # dead
    t[rs.rand(n) < 0.05] = 0.0
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return w, f(o), f(d), f(t)


@pytest.mark.parametrize("k", [2, 33, 64, 75, 1100])
@pytest.mark.parametrize("n", [0, 1, 4099])
def test_treelet_pending_matches_plain(cuda, k, n):
    """Phase 1's kernel against its plain version bit for bit (words and
    nearest treelets): K below, at and above word and tile sizes (bit 31
    set), no ray, one ray, a count no block size divides; one launch for
    n > 0."""
    w, o, d, t = _pending_case(cuda, k, n, seed=k + n)
    treelet.reset_launch_counts()
    pend, near = treelet._pending_masks(w, o, d, t)
    want = treelet._pending_masks_plain(w, o, d, t)
    _assert_equal((pend, near), want)
    assert pend.shape == (n, -(-k // 32))
    assert treelet.LAUNCHES["treelet_pending"] == int(n > 0)
    if n == 4099:
        assert (near < k).sum() >= 40 and (near == k).sum() >= 1000
        if k > 32:
            assert (pend < 0).any()


def test_treelet_launch_counters(cuda):
    w, o, d, active, t_max = _scene(cuda, n_tris=1500, cap=8, width=8,
                                    max_rows=48)
    treelet.reset_launch_counts()
    treelet.closest_hit_treelet(w, o, d, 1e12, active_in=active)
    treelet.any_hit_treelet(w, o, d, t_max, active_in=active)
    treelet.closest_hit_treelet_plain(w, o, d, 1e12)  # never counts
    assert treelet.LAUNCHES == {"treelet_pending": 2,
                                "treelet_closest_hit": 1,
                                "treelet_any_hit": 1}


V_CASES = ([f"{width}/{cap}" for cap, width in GRID]
           + ["n=0", "n=1", "n=4099", "dead 0", "dead 37", "dead 700",
              "deep bound"])


def _v_case(device, case):
    """(rows, lanes) of one V case: tie_scene trees over widths x caps with
    a per-lane t_max; no ray, one ray and 4099 rays; 20,000 lanes of which
    0 / 37 / 700 are active and a seventh have t_max <= 0; and a 32-wide
    tree declared 16 deep, so that its stacks hold 497 entries (over 48 KB
    of shared memory a block)."""
    if "/" in case:
        width, cap = map(int, case.split("/"))
        return _tie_case(device, cap, width)
    if case.startswith("n="):
        n = int(case[2:])
        w, o, d, active, t_max = _tie_case(device, 12, 24, n_rays=max(n, 1))
        return w, o[:n], d[:n], active[:n], t_max[:n]
    if case.startswith("dead"):
        live, n = int(case.split()[1]), 20000
        w, o, d, _, t_max = _tie_case(device, 12, 24, n_rays=n)
        act = np.zeros(n, bool)
        act[np.random.RandomState(live).choice(n, live,
                                               replace=False)] = True
        t_max = torch.where(torch.arange(n, device=device) % 7 == 0, -t_max,
                            t_max)
        return w, o, d, torch.from_numpy(act).to(device), t_max
    w, o, d, active, t_max = _tie_case(device, 7, 32)
    return w._replace(max_depth=16), o, d, active, t_max


@pytest.mark.parametrize("case", V_CASES)
def test_v_kernels_match_plain(cuda, case):
    """The format-V kernels equal their plain versions and the packet
    kernels on the same tree bit for bit (t, tri, u, v, occlusion, equal-t
    ties included), unbounded and with a per-lane t_max, through the plain
    and the sorting wrappers; one launch a call for n > 0, none for n = 0;
    the stack bound the kernel gets is the tree's."""
    w, o, d, active, t_max = _v_case(cuda, case)
    v = vpacket.v_from_wide(w)
    n = o.shape[0]
    layout = vpacket.kernel_layout(v)
    assert layout.stack_depth == v.max_stack == w.max_stack
    if case == "deep bound":
        assert layout.stack_depth == 497
        assert layout.shared_bytes > 48 * 1024
    vpacket.reset_launch_counts()
    for tm in (1e12, t_max):
        got = vpacket.closest_hit_vpacket(v, o, d, tm, active_in=active)
        _assert_equal(tuple(got), tuple(vpacket.closest_hit_plain(
            v, o, d, tm, active_in=active)))
        _assert_equal(tuple(got), tuple(packet.closest_hit_packet(
            w, o, d, tm, active_in=active)))
        _assert_equal(tuple(got), tuple(vpacket.closest_hit_vpacket_hbm(
            v, o, d, tm, active_in=active)))
        occ = vpacket.any_hit_vpacket(v, o, d, tm, active_in=active)
        assert occ.dtype == torch.bool
        _assert_equal(occ, vpacket.any_hit_plain(v, o, d, tm,
                                                 active_in=active))
        _assert_equal(occ, packet.any_hit_packet(w, o, d, tm,
                                                 active_in=active))
        _assert_equal(occ, vpacket.any_hit_vpacket_hbm(v, o, d, tm,
                                                       active_in=active))
    assert vpacket.LAUNCHES == {"v_closest_hit": 4 * int(n > 0),
                                "v_any_hit": 4 * int(n > 0)}


def test_v_shared_layout_matches_kernel(cuda):
    """The V kernel's own count of its shared memory equals
    vpacket.kernel_layout's on every width and cap, and every width has
    its kernel."""
    lib = native.build_all(("vpacket",))["vpacket"]
    for cap, width in GRID:
        w, *_ = _tie_case(cuda, cap, width, n_rays=8)
        v = vpacket.v_from_wide(w)
        layout = vpacket.kernel_layout(v)
        assert lib.shared_bytes(layout.top_rows, v.nodes[0].numel(),
                                layout.stack_depth) == layout.shared_bytes
        assert lib.group_lanes(width) in (1, 2, 4, 8)


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
    seeded ones where lanes hit, at visit counts either side of a chunk's
    edge and of the v % 128 wrap (1, 20, 127, 129, 2000): equal slab
    counts, bit-equal ALU outputs; each wrapper counts its launches, and
    a launch of another build of vpu.cu (`lib=`) is not counted."""
    visit_counts = (1, 20, 127, 129, 2000)
    profile_vpu.reset_launch_counts()
    for visits in visit_counts:
        for _, dt, fma_form, packed in profile_vpu.SLAB_CONFIGS:
            rows, planes = profile_vpu.slab_inputs(dt, cuda, seed=seed)
            got = profile_vpu.slab(rows, planes, fma_form, packed, visits)
            want = profile_vpu.slab_plain(rows, planes, fma_form, packed,
                                          visits)
            assert got.dtype == torch.int32 and int(got) == int(want)
            if visits >= 20:
                assert (int(got) > 0) == (seed is not None)
        for _, dt, r in profile_vpu.ALU_CONFIGS:
            a, b = profile_vpu.alu_inputs(dt, r, cuda, seed=seed)
            assert torch.equal(profile_vpu.alu(a, b, visits),
                               profile_vpu.alu_plain(a, b, visits))
    n = len(visit_counts)
    assert profile_vpu.LAUNCHES == {"vpu_slab": 5 * n, "vpu_alu": 4 * n}
    a, b = profile_vpu.alu_inputs(torch.float32, device=cuda, seed=seed)
    profile_vpu.alu(a, b, 3, lib=native.vpu_lib())
    assert profile_vpu.LAUNCHES["vpu_alu"] == 4 * n


def test_vpu_slab_odd_lanes_and_offsets(cuda):
    """Lane counts that leave a tile, a bf16x2 pair or a warp part-filled,
    and planes that start on an odd element: counts equal the plain
    version's."""
    for dt in (torch.float32, torch.bfloat16):
        rows, planes = profile_vpu.slab_inputs(dt, cuda, seed=2)
        for n in (1, 33, 511, 513, 1025, 8191):
            part = [p.reshape(-1)[1:n + 1] for p in planes]
            for fma_form, packed in ((False, False), (True, False),
                                     (False, True)):
                got = profile_vpu.slab(rows, part, fma_form, packed, 129)
                want = profile_vpu.slab_plain(rows, part, fma_form, packed,
                                              129)
                assert int(got) == int(want), (dt, n, fma_form, packed)


def test_vpu_slab_many_lanes(cuda):
    """532,480 lanes (65 x 8192, seeded, all distinct): one block a lane
    tile fills the card, so chunks hold as many visits as a block may
    walk (256) and no fewer than the visits need; counts equal the plain
    version's at 1, 256, 257 and 2000 visits."""
    rs = np.random.RandomState(3)
    n = 65 * profile_vpu.ROWS * 128
    o = rs.uniform(-2.0, 2.0, (3, n))
    d = rs.uniform(0.05, 1.0, (3, n)) * rs.choice([-1, 1], (3, n))
    rows = profile_vpu.slab_inputs(torch.float32, cuda, seed=1)[0]
    for _, dt, fma_form, packed in profile_vpu.SLAB_CONFIGS:
        planes = [torch.from_numpy(x.astype(np.float32)).to(cuda, dt)
                  for x in (*o, *(1.0 / d))]
        for visits in (1, 256, 257, 2000):
            got = profile_vpu.slab(rows, planes, fma_form, packed, visits)
            want = profile_vpu.slab_plain(rows, planes, fma_form, packed,
                                          visits)
            assert int(got) == int(want) > 0, (dt, fma_form, packed, visits)


def test_vpu_probes(cuda):
    """The latency probe's cycles are positive and give a clock within the
    H100's range; the chain floor lies under the ALU kernel's time; an
    empty kernel takes under 0.05 ms."""
    lat, hz = profile_vpu.latencies(cuda, iters=1 << 16)
    assert 0.5e9 < hz < 2.5e9
    assert all(0 < c < 100 for ops in lat.values() for c in ops.values())
    floor = profile_vpu.chain_floor_ms(lat["f32"], hz)
    a, b = profile_vpu.alu_inputs(torch.float32, device=cuda)
    assert floor < cuda_ms(lambda: profile_vpu.alu(a, b), 3)
    assert 0 < profile_vpu.empty_ms(cuda, 10) < 0.05


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


def _refit_world():
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scene.types import translate

    world, _ = procedural.room_scene(grid=2, subdivisions=2)
    return world, translate


@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_kernels_on_refit_rows(cuda, builder):
    """A World moved and hidden after its build (a host refit, every
    shape kept): the packet kernels equal their plain versions bit for
    bit on the refit rows, and the closest-hit t equals a fresh full
    build's within 1e-5 relative."""
    world, translate = _refit_world()
    scene = world.build(cuda, builder=builder)
    world.set_transform(1, translate(0.4, -0.3, 0.2))
    world.set_visibility(2, False)
    refit = world.build(cuda, builder=builder)
    assert refit.bvh.tri_order is scene.bvh.tri_order
    assert refit.wide.nodes.shape == scene.wide.nodes.shape
    rs = np.random.RandomState(9)
    lo, hi = (refit.wide.bounds[0].cpu().numpy(),
              refit.wide.bounds[1].cpu().numpy())
    n = 20_003
    o = torch.from_numpy((lo + rs.rand(n, 3) * (hi - lo)).astype(
        np.float32)).to(cuda)
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(cuda)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    active = torch.from_numpy(rs.rand(n) > 0.1).to(cuda)
    t_max = torch.from_numpy((rs.rand(n) * 5).astype(np.float32)).to(cuda)
    w = refit.wide
    _assert_equal(packet.closest_hit_packet(w, o, d, 1e12, active_in=active),
                  packet.closest_hit_plain(w, o, d, 1e12, active_in=active))
    _assert_equal(packet.any_hit_packet(w, o, d, t_max, active_in=active),
                  packet.any_hit_plain(w, o, d, t_max, active_in=active))
    fresh, _ = _refit_world()
    fresh.set_transform(1, translate(0.4, -0.3, 0.2))
    fresh.set_visibility(2, False)
    full = fresh.build(cuda, builder=builder)
    hr = packet.closest_hit_packet(w, o, d, 1e12, active_in=active)
    hf = packet.closest_hit_packet(full.wide, o, d, 1e12, active_in=active)
    both = (hr.tri >= 0) & (hf.tri >= 0)
    assert torch.equal(hr.tri >= 0, hf.tri >= 0)
    rel = ((hr.t - hf.t).abs() / hf.t.abs().clamp_min(1e-30))[both]
    assert float(rel.max()) <= 1e-5


def test_engine_pick_and_direct_on_the_card(cuda):
    """The Engine's pick on its own stream and trace_direct on the card
    agree with the same calls on the CPU."""
    from moonshine_tpu_torch.engine import Engine
    from moonshine_tpu_torch.integrator.direct import DirectConfig, \
        trace_direct
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.flagship_scene()
    picks = []
    for dev in ("cpu", cuda):
        e = Engine(device=dev)
        e.world = world
        lh = e.create_lens(lens)
        picks.append([e.pick(lh, 64, 48, x, y)
                      for x, y in ((32, 24), (5, 40), (60, 3))])
    assert [(p.instance, p.geometry, p.primitive) for p in picks[0]] == \
        [(p.instance, p.geometry, p.primitive) for p in picks[1]]
    out = []
    for dev in ("cpu", cuda):
        scene = world.build(dev)
        from moonshine_tpu_torch.render.camera import LensArrays

        o, d, rng, _ = _sample_rays(LensArrays.from_lens(lens, dev), 64, 64,
                                    0, True, dev)
        rad, _, rays = trace_direct(scene, o, d, rng, DirectConfig())
        out.append((rad.cpu(), int(rays)))
    assert out[0][1] == out[1][1]
    assert float((out[0][0] - out[1][0]).abs().max()) < 1e-4


def test_kernels_and_sharded_render_across_cards(cuda):
    """Where two or more cards are visible: the packet and treelet
    kernels on cuda:1's tensors, launched from a thread whose current
    device is cuda:0, equal their plain versions bit for bit; and
    render_sharded on a mesh of every visible card (each shard under its
    own card) equals the render on one card within 2e-6 x max(1, |pixel|) (the
    smoke's bound: the flagship's emitters exceed 1), launches counted."""
    import threading

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.parallel import make_mesh, render_sharded
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render
    from moonshine_tpu_torch.scene import procedural

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    w, o, d, active, t_max = _scene(other, n_tris=1500, cap=8, width=8,
                                    max_rows=6)
    out = {}

    def launch():
        torch.cuda.set_device(0)
        out["closest"] = packet.closest_hit_packet(w, o, d, 1e12,
                                                   active_in=active)
        out["any"] = packet.any_hit_packet(w, o, d, t_max, active_in=active)
        out["treelet"] = treelet.closest_hit_treelet(w, o, d, 1e12,
                                                     active_in=active)
        torch.cuda.synchronize(other)

    th = threading.Thread(target=launch)
    th.start()
    th.join()
    assert out["closest"].t.device == other
    _assert_equal(out["closest"], packet.closest_hit_plain(
        w, o, d, 1e12, active_in=active))
    _assert_equal(out["any"], packet.any_hit_plain(
        w, o, d, t_max, active_in=active))
    _assert_equal(tuple(out["treelet"]), tuple(
        treelet.closest_hit_treelet_plain(w, o, d, 1e12, active_in=active)))

    world, lens = procedural.flagship_scene()
    scene = world.build(cuda)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    sensor, rays_one = render(scene, lens, 64, 64, 4, cfg)
    mesh = make_mesh()
    assert len(set(mesh.devices.flat)) == torch.cuda.device_count()
    packet.reset_launch_counts()
    img, rays = render_sharded(scene, LensArrays.from_lens(lens, cuda),
                               64, 64, 4, cfg, mesh)
    assert packet.LAUNCHES["closest_hit"] > 0
    assert int(rays) == rays_one
    ref = sensor.image
    assert float(((img - ref).abs() / ref.abs().clamp_min(1.0)).max()) \
        <= 2e-6
