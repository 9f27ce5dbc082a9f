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
the same comparisons at the render's real shapes. The two-level walk
(csrc/tlas.cu) equals its plain version bit for bit (t, tri, u, v, inst,
occlusion) on an instanced scene with rotated, scaled, mirrored and
hidden instances and on a scene of exact equal-t ties
(procedural.tie_scene), n = 0/1/4099; its counting build counts. The
bounce loop as CUDA graph replays (integrator/graphs.py) equals the eager
loop bit for bit (image, rays, launch counts): the fused flagship, a
staged 1080p batch, the looped offline form, a two-level scene, and
Engine frames, which capture anew after each edit; its device-side
control (graphs.cond / choose as IF nodes): nested bodies, a trace that
takes all three live-prefix widths and reads nothing, looped blocks that
overrun the stop. render_sharded,
its shards stepped together, equals the same shards run in turn bit for
bit on cuda:0 x4 and across cards, and replays from its second call.
The shading kernels (csrc/shade.cu: surface in its full, thin and direct
forms, the full one with the bounce's light draw, scatter, env miss and
env draw) equal their plain versions bit for bit on the flagship (every
material, a textured atlas), the room (constant atlas), two-level scenes
(mirroring instances, the tie scene) and light panels with a textured
emission or none sampled, with env maps of size 1 and 32; the kernels
work in place and leave dead lanes, so the outputs they skip are held
on the lanes that are live (the env miss writes only the lanes that
missed: every lane's radiance and mask are held, at live shares of
100%, 10% and 1%). The lane sort (csrc/sort.cu) gives
torch.argsort(key, stable=True) bit for bit and moves every column as
its plain version does (below one tile, ragged, many tiles, every key
dead, the treelet's three passes), inside a CUDA graph too; its inverse
move equals its plain version, and the coherence keys that its first
kernel makes from the lanes' inputs equal coherence_key_plain's, their
sort at full, 1%-live and all-dead batches too."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import (
    launch, native, packet, tlas, treelet, vpacket,
)
from moonshine_tpu_torch.integrator import shade
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


def _tlas_case(device, n, seed=5, scene="grid"):
    """procedural.instanced_scene at 5 x 4 instances of icosphere(2), one
    hidden, built two-level on `device`, and n seeded rays through it
    with dead lanes and a per-lane t_max; or (scene="ties")
    procedural.tie_scene's instances and rays, whose hits tie exactly
    in t."""
    import os

    from moonshine_tpu_torch.scene import procedural

    rs = np.random.RandomState(seed)
    if scene == "ties":
        world, o, d = procedural.tie_scene(n, seed=seed)
        t = tlas.device_tlas(tlas.build_tlas(world.meshes,
                                             world.instances)[0], device)
    else:
        world, _ = procedural.instanced_scene(grid=(5, 4), subdivisions=2,
                                              seed=seed)
        world.set_visibility(7, False)
        os.environ["MSN_FORCE_TLAS"] = "1"
        try:
            t = world.build(device).tlas
        finally:
            del os.environ["MSN_FORCE_TLAS"]
        o = (rs.rand(n, 3) * np.float32([16, 14, 6])
             - np.float32([8, 7, 1])).astype(np.float32)
        d = rs.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    put = lambda x: torch.from_numpy(x).to(device)
    return (t, put(o), put(d), put(rs.rand(n) > 0.2),
            put((rs.rand(n) * 12).astype(np.float32)))


@pytest.mark.parametrize("scene", ["grid", "ties"])
@pytest.mark.parametrize("n", [0, 1, 4099])
def test_tlas_kernels_match_plain(cuda, n, scene):
    """The two-level kernel against its plain version bit for bit: every
    field of the closest hit (the instance too) and the occlusion, with an
    unbounded and a per-lane t_max, with and without an active mask; on
    the instanced grid and on the scene of exact equal-t ties."""
    t, o, d, active, t_max = _tlas_case(cuda, n, scene=scene)
    for tm in (1e12, t_max):
        for act in (None, active):
            _assert_equal(
                tlas.closest_hit_tlas(t, o, d, tm, active_in=act),
                tlas.closest_hit_tlas_plain(t, o, d, tm, active_in=act))
            _assert_equal(tlas.any_hit_tlas(t, o, d, tm, active_in=act),
                          tlas.any_hit_tlas_plain(t, o, d, tm,
                                                  active_in=act))
    if n > 1:
        h = tlas.closest_hit_tlas(t, o, d, 1e12)
        assert int(h.is_hit.sum()) > n // 10
        assert set(h.inst[h.is_hit].tolist()) > {0}
        if scene == "grid":
            assert 7 not in h.inst.tolist()


def test_tlas_walk_visits(cuda):
    """The counting build gives the kernel's outputs (its launch is not
    counted) and counts a visit per box-tested node, an entry per
    instance walked, a leaf visit per triangle batch."""
    t, o, d, active, t_max = _tlas_case(cuda, 4099)
    tlas.reset_launch_counts()
    v = tlas.walk_visits(t, o, d, 1e12, active)
    assert tlas.LAUNCHES == {"tlas_closest_hit": 0, "tlas_any_hit": 0}
    assert v.top >= int(active.sum()) and v.entries > 0 and v.blas > 0
    assert v.top + v.blas <= v.boxes <= 8 * (v.top + v.blas)
    assert v.leaves <= v.tris <= 4 * v.leaves
    occ = tlas.walk_visits(t, o, d, t_max, active, any_hit=True)
    assert occ.top > 0 and occ.tris <= 4 * occ.leaves


def test_tlas_launch_counters(cuda):
    t, o, d, active, t_max = _tlas_case(cuda, 1000)
    tlas.reset_launch_counts()
    tlas.closest_hit_tlas(t, o, d, 1e12)
    tlas.any_hit_tlas(t, o, d, t_max, active_in=active)
    tlas.closest_hit_tlas_plain(t, o, d, 1e12)  # never counts
    assert tlas.LAUNCHES == {"tlas_closest_hit": 1, "tlas_any_hit": 1}


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


def _pending_case(device, k, n, seed, clustered=False, live=None):
    """A tree whose treelet plan is replaced by k seeded boxes (phase 1
    reads only the boxes): duplicates (equal entry t), inverted boxes
    (lo 0, hi -1: the slab test takes them as the box [-1, 0]^3), rays
    inside boxes (entry 0), axis-parallel directions (safe_inv clamps),
    dead lanes, t_max <= 0, finite and 1e12 t_max. `clustered`: each
    32-treelet word's boxes around a centre of its own, as the plan's
    depth-first ids make them, so a ray misses most words' unions (the
    kernel's cull) and enters some. `live`: that share of the lanes live,
    the dead ones scattered through every warp."""
    rs = np.random.RandomState(seed)
    w, *_ = _scene(device, n_tris=300, cap=8, width=8, n_rays=1)
    if clustered:
        centre = rs.randn(-(-k // 32), 3) * 8
        c = np.repeat(centre, 32, axis=0)[:k] + rs.randn(k, 3) * 0.8
        ext = rs.rand(k, 3) * 0.6 + 0.05
    else:
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
    if clustered:  # half the rays aimed at a treelet, from 12 units off
        aim = rs.rand(n) < 0.5
        at = c[rs.randint(0, k, int(aim.sum()))]
        o[aim] = at - d[aim] * 12.0
    axis = rs.rand(n) < 0.2
    d[axis] = np.eye(3)[rs.randint(0, 3, int(axis.sum()))] * rs.choice(
        [-1.0, 1.0], (int(axis.sum()), 1))
    d[rs.rand(n) < 0.1, 1] = 0.0
    t = np.where(rs.rand(n) < 0.5, 1e12, rs.rand(n) * 8)
    if live is None:
        t[rs.rand(n) < 0.2] = -1e30  # dead
        t[rs.rand(n) < 0.05] = 0.0
    else:
        t = np.maximum(t, 1e-3)
        dead = rs.rand(n) >= live
        t[dead] = np.where(rs.rand(int(dead.sum())) < 0.9, -1e30, 0.0)
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


@pytest.mark.parametrize("live", [1.0, 0.5, 0.1, 0.01])
@pytest.mark.parametrize("k", [75, 379, 1100])
def test_treelet_pending_culled_and_packed(cuda, k, live):
    """Phase 1's cull by each word's union box and its packing of the
    live rays, against the plain version bit for bit: clustered boxes,
    so that each ray enters some words' unions and misses others (words
    whose bit 31 is set among those entered), and dead lanes scattered
    through every warp at 100%, 50%, 10% and 1% live."""
    w, o, d, t = _pending_case(cuda, k, 20000, seed=k, clustered=True,
                               live=live)
    pend, near = treelet._pending_masks(w, o, d, t)
    _assert_equal((pend, near), treelet._pending_masks_plain(w, o, d, t))
    alive = t > 0.0
    entered = treelet.entered_words(w, o, d, t)
    assert entered[alive].any() and (~entered[alive]).any()
    assert ((pend < 0) & entered).any()
    assert not (pend[~alive] != 0).any() and (near[~alive] == k).all()
    if live < 1.0:  # every warp of 32 lanes holds a dead lane
        warps = (~alive)[:alive.shape[0] // 32 * 32].reshape(-1, 32)
        assert warps.any(dim=1).float().mean() > 0.25


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
    _assert_stepped_as_in_turn(scene, LensArrays.from_lens(lens, cuda), 64,
                               64, 4, cfg, mesh)


def _assert_stepped_as_in_turn(scene, la, h, w, spp, cfg, mesh):
    """render_sharded on the mesh equals its shards run in turn
    (time_sharded.in_turn) bit for bit: image, rays and packet launches;
    a call after the first copies no scene and captures no graph, and
    replays. Returns the image, the rays and the first call's counts."""
    from moonshine_tpu_torch.parallel import render_sharded
    from moonshine_tpu_torch.scripts.time_sharded import in_turn, timed_run

    stepped = lambda: render_sharded(scene, la, h, w, spp, cfg, mesh)
    first = timed_run(stepped)
    (img, rays), _, counts, launches = timed_run(stepped)
    (want, want_rays), _, _, want_launches = timed_run(
        lambda: in_turn(scene, la, h, w, spp, cfg, mesh))
    assert torch.equal(img, want) and int(rays) == int(want_rays)
    assert launches == want_launches and launches["closest_hit"] > 0
    assert counts["captures"] == 0 and counts["copies"] == 0
    assert counts["replays"] > 0
    return img, rays, first[2]


def test_sharded_on_one_card_steps_as_its_shards_in_turn(cuda):
    """cuda:0 x4 (sp=2, dp=2), each shard on its own stream: the flagship
    at 256x256 x 4 spp (unrolled, resort on: a live-count read a
    segment) and the small room at 160x120 x 2 spp in the offline CLI's
    looped form (max bounces 1024, shards that end at different
    segments) equal their shards run in turn bit for bit, launches too,
    and the one-card render within 2e-6 x max(1, |pixel|). The four
    shards ran on four distinct streams."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.parallel import make_mesh, sharding
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural

    mesh = make_mesh([cuda] * 4, sp=2)
    for make, (h, w, spp), cfg in (
            (procedural.flagship_scene, (256, 256, 4), PathConfig(**CFG4)),
            (lambda: procedural.room_scene(grid=2, subdivisions=2),
             (120, 160, 2), PathConfig(max_bounces=1024))):
        world, lens = make()
        scene, la = world.build(cuda), LensArrays.from_lens(lens, cuda)
        img, rays, first = _assert_stepped_as_in_turn(scene, la, h, w, spp,
                                                      cfg, mesh)
        assert first["captures"] > 0
        acc, rays_one = render_spp(scene, la, h, w, 0, spp, cfg)
        ref = acc / spp
        assert int(rays) == int(rays_one)
        assert float(((img - ref).abs() / ref.abs().clamp_min(1.0)).max()) \
            <= 2e-6
    assert len({s.cuda_stream for s in sharding._STREAMS[cuda][:4]}) == 4


def test_engine_on_a_dp_mesh_replays_from_its_second_frame(cuda):
    """An Engine (its defaults: max bounces 1024, NEE off) on a dp-only
    mesh of cuda:0 x2, the small room at 160x120: its first frame
    captures, every later frame only replays and copies nothing, and the
    accumulated image agrees with the Engine's without a mesh within
    2e-6 x max(1, |pixel|)."""
    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.parallel import make_mesh
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.room_scene(grid=2, subdivisions=2)
    images = []
    for mesh in (None, make_mesh([cuda] * 2, sp=1)):
        e = _engine_of(world, cuda)
        if mesh is not None:
            e.set_mesh(mesh)
        sensor, lh = e.create_sensor(160, 120), e.create_lens(lens)
        for frame in range(3):
            graphs.reset_counts()
            img = e.render(sensor, lh)
            counts = dict(graphs.COUNTS)
            if mesh is not None:
                assert (counts["captures"] > 0) == (frame == 0)
                assert counts["replays"] > 0 and counts["copies"] == 0
        images.append(img)
    ref, got = images
    assert np.isfinite(got).all()
    assert float((np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max()) \
        <= 2e-6


# --- the bounce loop as CUDA graph replays (integrator/graphs.py) ---

def _launches():
    return {**packet.LAUNCHES, **treelet.LAUNCHES, **tlas.LAUNCHES,
            **shade.LAUNCHES}


def _eager_and_replayed(monkeypatch, fn):
    """fn() on the eager loop (graphs.eager()) and as graph replays, each
    from a clear cache after a warm-up call (for the graphs, the one that
    captures): [(fn's result, launches), ...] for eager then replays;
    asserts that the second ran only replays."""
    import contextlib

    from moonshine_tpu_torch.integrator import graphs

    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: replays.append(1) or replay(g))
    out = []
    for eager in (True, False):
        graphs.clear()
        with graphs.eager() if eager else contextlib.nullcontext():
            fn()
            captured = len(replays)
            for m in (packet, treelet, tlas, shade):
                m.reset_launch_counts()
            res = fn()
            torch.cuda.synchronize()
            out.append((res, _launches()))
        assert (len(replays) > captured) != eager
    graphs.clear()
    return out


def _assert_same_render(out):
    (a, la), (b, lb) = out
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y
    assert la == lb and any(la.values())


def _room_cuda(cuda, **kw):
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.room_scene(**kw)
    return world.build(cuda), LensArrays.from_lens(lens, cuda)


CFG4 = dict(max_bounces=4, env_samples_per_bounce=1,
            mesh_samples_per_bounce=1)


def test_graphs_fused_flagship_equal_eager(cuda, monkeypatch):
    """The flagship, 256x256 x 3 spp through render_spp (the fused path,
    resort on: resorted segments over live prefixes): replays equal the
    eager loop bit for bit, rays and launches too."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.flagship_scene()
    scene, la = world.build(cuda), LensArrays.from_lens(lens, cuda)
    stats = {}
    out = _eager_and_replayed(monkeypatch, lambda: render_spp(
        scene, la, 256, 256, 5, 3, PathConfig(**CFG4), stats=stats))
    assert stats["path"] == "fused" and stats["resort"]
    _assert_same_render(out)


def test_graphs_staged_room_1080p_equal_eager(cuda, monkeypatch):
    """room_184k at 1920x1080 x 1 spp (the staged path, one batch of
    2,073,600 lanes, resort on): replays equal the eager loop."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import render_spp

    scene, la = _room_cuda(cuda, grid=6, subdivisions=4)
    stats = {}
    out = _eager_and_replayed(monkeypatch, lambda: render_spp(
        scene, la, 1080, 1920, 3, 1, PathConfig(**CFG4), stats=stats))
    assert stats == dict(path="staged", resort=True, segments=6)
    _assert_same_render(out)


def test_graphs_looped_offline_form_equal_eager(cuda, monkeypatch):
    """The offline CLI's form: render_sample with max_bounces 1024 (the
    looped form, one host read a segment), room_184k at 320x240 with the
    resort off and on: replays equal the eager loop."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import render_sample

    scene, la = _room_cuda(cuda, grid=6, subdivisions=4)
    for resort in (None, True):
        cfg = PathConfig(max_bounces=1024, resort_bounces=resort)
        out = _eager_and_replayed(monkeypatch, lambda: render_sample(
            scene, la, 240, 320, 2, cfg))
        _assert_same_render(out)


def test_graphs_instanced_equal_eager(cuda, monkeypatch):
    """40 instances of icosphere(4) built two-level (MSN_FORCE_TLAS=1),
    512x512 x 2 spp: the two-level walk and the instance transform as
    replays equal the eager loop."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural

    monkeypatch.setenv("MSN_FORCE_TLAS", "1")
    world, lens = procedural.instanced_scene(grid=(8, 5), subdivisions=4)
    scene = world.build(cuda)
    assert scene.tlas is not None
    la = LensArrays.from_lens(lens, cuda)
    out = _eager_and_replayed(monkeypatch, lambda: render_spp(
        scene, la, 512, 512, 0, 2, PathConfig(**CFG4)))
    _assert_same_render(out)
    assert out[1][1]["tlas_closest_hit"] > 0


def test_graphs_conditional_bodies(cuda):
    """graphs.cond / choose under capture (IF nodes, csrc/graph_cond.cu):
    nested bodies that allocate, write static buffers and launch (a
    stand-in wrapper's count), replayed over every combination of their
    predicates with other allocations live between replays, equal the
    eager step; the launches counted are the bodies' that ran (read from
    the device log when the counts are read), and no replay touches
    memory outside the graph's."""
    from moonshine_tpu_torch.integrator import graphs

    x = torch.zeros(1 << 16, device=cuda)
    sel = torch.zeros((), dtype=torch.int64, device=cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    counts = launch.Counts({"outer": 0, "inner": 0, "step": 0})

    def inner():
        launch.count_launch(counts, "inner")
        x.add_(torch.full_like(x, 10.0))

    def step():
        launch.count_launch(counts, "step")
        x.add_(1.0)
        graphs.choose(sel, {
            0: lambda: x.mul_(3.0),
            2: lambda: (launch.count_launch(counts, "outer"),
                        x.copy_(x * 2.0 + 1.0),
                        graphs.cond(flag, inner))})

    def want(s, f):
        y = 1.0
        if s == 0:
            y *= 3.0
        elif s == 2:
            y = y * 2.0 + 1.0 + (10.0 if f else 0.0)
        return y

    steps = graphs.Steps(cuda)
    graphs.reset_counts()
    steps.run("step", step)  # eager, the warm captures, the capture
    assert graphs.COUNTS["captures"] == 1 and graphs.COUNTS["conds"] >= 1
    others = [torch.full((1 << 18,), 7.0, device=cuda) for _ in range(8)]
    expected = dict(counts)
    for s_, f in [(0, False), (1, True), (2, False), (2, True), (0, True)]:
        x.zero_()
        sel.fill_(s_)
        flag.fill_(f)
        steps.run("step", step)
        torch.cuda.synchronize()
        assert torch.equal(x, torch.full_like(x, want(s_, f)))
        expected["step"] += 1
        expected["outer"] += s_ == 2
        expected["inner"] += s_ == 2 and f
    assert dict(counts) == expected
    assert all(bool((t == 7.0).all()) for t in others)
    assert graphs.COUNTS["reads"] == 0


@pytest.mark.parametrize("kind", ["int64", "bool"])
def test_graphs_switch_every_pair(cuda, kind):
    """graphs.choose captured as one SWITCH node (csrc/graph_cond.cu):
    with an int64 pair, the resorted segment's six (prev, w) branches
    replayed at every pair of -1..3, so pairs with no branch run none;
    with a bool index, two branches and one (False then matches none).
    The body that ran is the only one whose flag moved and whose launch
    counted (the device log), and each replay launched one set kernel."""
    from moonshine_tpu_torch.integrator import graphs

    if kind == "int64":
        sel = (torch.zeros((), dtype=torch.int64, device=cuda),
               torch.zeros((), dtype=torch.int64, device=cuda))
        keys = [(p, k) for p in range(3) for k in range(p + 1)]
        values = [(p, k) for p in range(-1, 4) for k in range(-1, 4)]
    else:
        sel = torch.zeros((), dtype=torch.bool, device=cuda)
        keys = [True, False]
        values = [True, False]
    flags = torch.zeros(len(keys), dtype=torch.int64, device=cuda)
    counts = launch.Counts({key: 0 for key in keys})

    def body(i, key):
        launch.count_launch(counts, key)
        flags[i:i + 1].add_(1)

    branches = {key: (lambda i=i, key=key: body(i, key))
                for i, key in enumerate(keys)}
    for table in ([branches] if kind == "int64"
                  else [branches, {True: branches[True]}]):
        steps = graphs.Steps(cuda)
        steps.run("switch", lambda: graphs.choose(sel, table))
        for value in values:
            for t, v in zip(sel if kind == "int64" else (sel,),
                            value if kind == "int64" else (value,)):
                t.fill_(v)
            flags.zero_()
            for key in counts:
                counts[key] = 0
            graphs.reset_launch_counts()
            steps.run("switch", lambda: graphs.choose(sel, table))
            torch.cuda.synchronize()
            hit = value if value in table else None
            want = [int(key == hit) for key in keys]
            assert flags.tolist() == want, (value, flags.tolist())
            assert [counts[key] for key in keys] == want
            assert graphs.LAUNCHES["graph_if"] == 1
            assert graphs.LAUNCHES["graph_tail"] == 0


@pytest.mark.parametrize("guard_first", [False, True])
def test_graphs_folded_guard_stops_mid_block(cuda, guard_first):
    """graphs.loop captured (csrc/graph_cond.cu): each step's tail counts
    it and sets the next step's guard, only the first guard has a set
    kernel. Steps that set the live count from a schedule: it reaches 0
    mid-block (and a later step would make lanes live again), the cap
    on the counter stops the loop, no step after the unguarded first
    runs (none with the first guarded); the replays, two of each schedule in alternation, equal the eager loop
    (graphs.eager()) bit for bit: the steps' writes, the counter, the
    live count and the launch counts."""
    from moonshine_tpu_torch.integrator import graphs

    n_steps, cap = 8, 6 + int(guard_first)
    live = torch.zeros((), dtype=torch.int64, device=cuda)
    bounce = torch.zeros_like(live)
    sched = torch.zeros(n_steps, dtype=torch.int64, device=cuda)
    x = torch.zeros(n_steps, device=cuda)
    counts = launch.Counts({"step": 0})

    def step(i):
        launch.count_launch(counts, "step")
        live.copy_(sched[i])
        x[i:i + 1].add_(float(i + 1))

    def block():
        graphs.loop(((live, ">", 0), (bounce, "<", cap)),
                    [lambda i=i: step(i) for i in range(n_steps)], bounce,
                    lambda: bounce.add_(1), guard_first=guard_first)

    schedules = {"stop at 3": ([5, 4, 0, 6, 6, 6, 6, 6], 7),
                 "cap": ([1] * n_steps, 7),
                 "none": ([0] * n_steps, 0)}

    def load(name):
        values, live0 = schedules[name]
        sched.copy_(torch.tensor(values, device=cuda))
        live.fill_(live0)
        bounce.zero_()
        x.zero_()
        counts["step"] = 0
        graphs.reset_launch_counts()

    def state():
        torch.cuda.synchronize()
        return (x.clone(), int(bounce), int(live), counts["step"],
                graphs.LAUNCHES["graph_if"], graphs.LAUNCHES["graph_tail"])

    want = {}
    with graphs.eager():
        for name in schedules:
            load(name)
            block()
            want[name] = state()
    steps = graphs.Steps(cuda)
    load("stop at 3")
    steps.run("block", block)  # the eager run, the warm and the capture
    order = ["stop at 3", "cap", "stop at 3", "none", "cap", "none"]
    for name in order:
        load(name)
        steps.run("block", block)
        got = state()
        x_want, b_want, l_want, n_want = want[name][:4]
        assert torch.equal(got[0], x_want), name
        assert got[1:4] == (b_want, l_want, n_want), name
        assert got[4] == int(guard_first)  # the first guard's set kernel
        assert got[5] == n_want  # a tail for every step that ran
    assert want["stop at 3"][1] == 3 and want["cap"][1] == cap
    assert want["none"][1] == (0 if guard_first else 1)


def _three_widths(dev, n=4096, seed=7):
    """(scene, o, d, rng): a Lambert sphere of albedo 0.5 under a white
    sky and n rays: 40% from its centre (they live until the roulette
    after bounce 3 takes most), 30% at it from outside (they leave after
    one bounce), 30% away from it (they miss), so a resorted trace runs
    its segments over n, then n/2, then n/4 lanes."""
    from moonshine_tpu_torch.core import rng as R
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scene.types import (
        Geometry, Instance, Lambert, MaterialInfo,
    )
    from moonshine_tpu_torch.scene.world import World

    w = World()
    mesh = w.add_mesh(procedural.icosphere_mesh(2, with_normals=False))
    mat = w.add_material(MaterialInfo(variant=Lambert(color=(0.5, 0.5,
                                                             0.5))))
    w.add_instance(Instance(transform=np.eye(3, 4, dtype=np.float32),
                            geometries=[Geometry(mesh, mat)]))
    w.set_background(None)
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    a, b = int(0.4 * n), int(0.7 * n)
    o[a:] = [0, -3, 0]
    aim = np.float32([0, 3, 0]) + rs.uniform(-0.3, 0.3, (b - a, 3)
                                             ).astype(np.float32)
    d[a:b] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    d[b:] = [0, -1, 0]
    rng = R.seed(0, torch.arange(n), torch.zeros(n, dtype=torch.int64))
    return (w.build(dev), torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev), rng.to(dev))


def test_graphs_all_widths_read_nothing(cuda, monkeypatch):
    """trace_paths over 4096 lanes whose resorted segments run over n,
    then n/2, then n/4 lanes (`_three_widths`; each width and each
    prefix chosen on the device), unrolled: replays equal the eager loop
    bit for bit (radiance, RNG, rays, segments, launches) and read the
    host 0 times a trace."""
    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.integrator import path as P
    from moonshine_tpu_torch.integrator.path import PathConfig, trace_paths

    scene, o, d, rng = _three_widths(cuda)
    widths = []
    resorted = P._Trace._resorted
    monkeypatch.setattr(
        P._Trace, "_resorted",
        lambda self, *a: widths.append(a[3]) or resorted(self, *a))
    cfg = PathConfig(**CFG4, resort_bounces=True)
    out = _eager_and_replayed(monkeypatch,
                              lambda: trace_paths(scene, o, d, rng, cfg))
    _assert_same_render(out)
    assert set(widths[:5]) == {4096, 2048, 1024}  # the eager loop's five
    trace_paths(scene, o, d, rng, cfg)  # captures
    graphs.reset_counts()
    trace_paths(scene, o, d, rng, cfg)
    torch.cuda.synchronize()
    assert graphs.COUNTS["reads"] == 0 and graphs.COUNTS["conds"] == 0
    assert graphs.COUNTS["replays"] == 3  # reset, the trace, finish


def test_graphs_looped_block_overruns_the_stop(cuda, monkeypatch):
    """The looped form stopped by the cap inside a block (max_bounces
    LOOP_BLOCK + 1: the second block's guards fail after its third
    segment) and stopped by the last lane dying inside one (max_bounces
    1024), the room at 320x240 with the resort off and on: replays equal
    the eager loop bit for bit, and each sample reads the live count at
    most ceil(segments / LOOP_BLOCK) + 1 times."""
    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.integrator import path as P
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import render_spp

    scene, la = _room_cuda(cuda, grid=6, subdivisions=4)
    for bounces in (P.LOOP_BLOCK + 1, 1024):
        for resort in (False, True):
            cfg = PathConfig(max_bounces=bounces, unroll=False,
                             resort_bounces=resort)
            stats = {}
            out = _eager_and_replayed(monkeypatch, lambda: render_spp(
                scene, la, 240, 320, 4, 1, cfg, stats=stats))
            _assert_same_render(out)
            render_spp(scene, la, 240, 320, 4, 1, cfg)  # captures
            graphs.reset_counts()
            render_spp(scene, la, 240, 320, 4, 1, cfg, stats=stats)
            segments = stats["segments"]
            if bounces < 1024:
                assert segments == bounces + 2
            # the stats' segment count is one read more
            assert graphs.COUNTS["reads"] - 1 <= \
                -(-segments // P.LOOP_BLOCK) + 1


def _engine_of(world, dev):
    """An Engine holding `world` through its handles: StandardPBR from
    solid textures (Lambert as metalness 0, roughness 1; a mirror as
    metalness 1, roughness 0; glass as its ior)."""
    from moonshine_tpu_torch.engine import Engine
    from moonshine_tpu_torch.scene.types import Lambert, StandardPBR

    e = Engine(device=dev)
    for m in world.meshes:
        e.create_mesh(m.positions, m.indices, m.normals, m.texcoords,
                      m.indexed_attributes)
    for info in world.materials:
        v = info.variant
        if isinstance(v, StandardPBR):
            fields = (v.color, v.metalness, v.roughness, v.ior)
        elif isinstance(v, Lambert):
            fields = (v.color, 0.0, 1.0, 1.5)
        else:  # Mirror, Glass
            fields = ((1.0, 1.0, 1.0), 1.0, 0.0, getattr(v, "ior", 1.5))
        color, metal, rough, ior = fields
        solid = e.create_solid_texture
        e.create_material(color=solid(color), metalness=solid(metal),
                          roughness=solid(rough),
                          emissive=solid(info.emissive), ior=ior)
    for inst in world.instances:
        e.create_instance(inst.transform, [(g.mesh, g.material, g.sampled)
                                           for g in inst.geometries],
                          inst.visible)
    e.set_background(None)
    return e


def test_graphs_engine_frames_recapture_after_edits(cuda, monkeypatch):
    """Engine frames (its defaults: max_bounces 1024, NEE off; the small
    room at 160x120): an eager frame, a frame that captures and one that
    replays, all equal bit for bit; after a material edit and after a
    transform edit (a refit) the scene's tensors are new, so the next
    graph frame captures anew (never replays on the old scene) and the
    frames still agree; the image changes with each edit. A second
    thread picks while a frame captures: neither fails."""
    import threading

    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scene.types import translate

    world, lens = procedural.room_scene(grid=2, subdivisions=2)
    e = _engine_of(world, cuda)
    sensor, lh = e.create_sensor(160, 120), e.create_lens(lens)
    captures = []
    capture = graphs.Steps._capture
    monkeypatch.setattr(graphs.Steps, "_capture",
                        lambda self, fn: captures.append(1)
                        or capture(self, fn))
    graphs.clear()

    def frames():
        out = []
        for eager in (True, False, False):
            e.reset_sensor(sensor)
            if eager:
                with graphs.eager():
                    out.append(e.render(sensor, lh))
            else:
                before = len(captures)
                out.append(e.render(sensor, lh))
                out.append(len(captures) - before)
        img, graphed, n_new, replayed, n_again = out
        assert np.array_equal(img, graphed) and np.array_equal(img, replayed)
        assert n_new > 0 and n_again == 0
        return img

    first = frames()
    e.set_material_color(0, e.create_solid_texture([0.3, 0.3, 0.3]))
    edited = frames()
    e.set_instance_transform(len(world.instances) - 1,
                             translate(0.6, -0.4, 0.3))
    refit = frames()
    assert not np.array_equal(first, edited)
    assert not np.array_equal(edited, refit)

    e.set_instance_visibility(0, False)
    picks, stop = [], threading.Event()

    def pick():
        while not stop.is_set():
            picks.append(e.pick(lh, 160, 120, 80, 100))

    th = threading.Thread(target=pick)
    th.start()
    try:
        before = len(captures)
        e.reset_sensor(sensor)
        img = e.render(sensor, lh)
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and picks
    assert len(captures) > before and np.isfinite(img).all()
    graphs.clear()


# --- the shading kernels (csrc/shade.cu, integrator/shade.py) ---

def _bits(x):
    """x's bits: floats as int32 words with every NaN the same word."""
    if x.dtype == torch.float32:
        return torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                           x).view(torch.int32)
    return x


def _assert_bits(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    same = _bits(got) == _bits(want)
    assert bool(same.all()), (
        f"{what}: {int((~same).sum())} of {same.numel()} values differ")


def _shade_scene(kind, device):
    """(scene, two_level) of a shading case: the flagship (every material,
    a textured floor), the small room (constant atlas), the instanced
    grid built two-level (mirroring instances, one hidden) or the tie
    scene built two-level."""
    import os

    from moonshine_tpu_torch.scene import procedural

    if kind == "flagship":
        return procedural.flagship_scene()[0].build(device), False
    if kind == "room":
        return procedural.room_scene(grid=2, subdivisions=2)[0].build(
            device), False
    if kind == "instanced":
        world, _ = procedural.instanced_scene(grid=(5, 4), subdivisions=2)
        world.set_visibility(7, False)
    else:
        world = procedural.tie_scene(16)[0]
    os.environ["MSN_FORCE_TLAS"] = "1"
    try:
        scene = world.build(device)
    finally:
        del os.environ["MSN_FORCE_TLAS"]
    assert scene.tlas is not None
    if kind == "instanced":
        assert bool((scene.inst_tf[:, 12] < 0).any())  # a mirror
    return scene, True


def _shade_lanes(scene, two_level, n, seed, device):
    """Seeded lane state for the surface kernel: hits on random triangles
    (a sixth missed, tri -1 with u = v = 0 as the walks write them; some
    with junk barycentrics), instances (-1 on a miss), rays, throughput,
    radiance, last_pdf (some 0) and last_delta; a third of the lanes
    dead."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    tri = rs.randint(0, scene.num_tris, n).astype(np.int32)
    miss = rs.rand(n) < 1 / 6
    tri[miss] = -1
    u = rs.rand(n).astype(f32)
    v = (rs.rand(n) * (1 - u)).astype(f32)
    junk = rs.rand(n) < 0.05
    u[junk] = rs.randn(junk.sum()).astype(f32) * 3
    u[miss] = v[miss] = 0.0
    inst = None
    if two_level:
        inst = rs.randint(0, scene.inst_tf.shape[0], n).astype(np.int32)
        inst[miss] = -1
    d = rs.randn(n, 3).astype(f32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    hit = tlas.TlasHit(t=put(rs.rand(n).astype(f32)), tri=put(tri),
                       u=put(u), v=put(v),
                       inst=None if inst is None else put(inst))
    last_pdf = rs.rand(n).astype(f32) * 3
    last_pdf[rs.rand(n) < 0.1] = 0.0
    return dict(
        hit=hit, o=put((rs.randn(n, 3) * 4).astype(f32)), d=put(d),
        active=put(rs.rand(n) > 0.33) & (hit.tri >= 0),
        throughput=put(rs.rand(n, 3).astype(f32)),
        radiance=put(rs.rand(n, 3).astype(f32)), last_pdf=put(last_pdf),
        last_delta=put(rs.rand(n) < 0.2))


def _assert_surface(got, want, what, live, exact=True):
    """The surface kernel's outputs against the plain version's: the
    radiance and the mask on every lane (the radiance as values: a lane
    the kernel leaves adds no +0), the decoded hit on the `live` lanes
    (the kernel writes it there alone), bit for bit, or (exact=False) the
    float ones within 1e-5 relative."""
    same = (got.radiance == want.radiance) | (
        torch.isnan(got.radiance) & torch.isnan(want.radiance))
    assert bool(same.all()), f"{what} radiance"
    _assert_bits(got.active, want.active, f"{what} active")
    pairs = [(getattr(got, k), getattr(want, k), k) for k in (
        "position", "tri_n", "w_o_ss") if getattr(want, k) is not None]
    if want.frame is not None:
        pairs += [(getattr(got.frame, k), getattr(want.frame, k), k)
                  for k in ("n", "s", "t")]
        pairs += [(getattr(got.mat, k), getattr(want.mat, k), k)
                  for k in want.mat._fields]
    pairs.append((got.radiance, want.radiance, "radiance"))
    for g, w, name in pairs:
        g, w = g[live], w[live]
        if exact or not w.dtype.is_floating_point:
            _assert_bits(g, w, f"{what} {name}")
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                       msg=f"{what} {name}")


def _surface_both(args, draw=None):
    """(kernel's Surface, plain version's) on the same inputs: the kernel
    on copies of what it updates in place (active, throughput, radiance
    and the draw's rng)."""
    args = list(args)
    kernel_args = list(args)
    for j in (6, 7, 8):  # active, throughput, radiance
        if kernel_args[j] is not None:
            kernel_args[j] = kernel_args[j].clone()
    kernel_draw = None if draw is None else draw._replace(
        rng=draw.rng.clone())
    return (shade.surface(*kernel_args, draw=kernel_draw),
            shade.surface_plain(*args, draw=draw))


@pytest.mark.parametrize("kind", ["flagship", "room", "instanced", "ties"])
@pytest.mark.parametrize("n", [1, 4099])
def test_shade_surface_matches_plain(cuda, kind, n):
    """The surface kernel in its three forms against surface_plain on the
    same lanes, bit for bit: the bounce's (bounce 0 and 3, mesh samples 1
    and 0, with a draw of one env sample and no roulette), the last
    segment's and the direct integrator's; the decoded
    hit on the lanes active at the hit (every lane in the direct form),
    the radiance and the mask everywhere. One two-level lane is held
    within 1e-5 instead: torch takes an einsum of a batch of one through
    an unbatched matrix product whose cuBLAS kernel rounds the instance
    transform otherwise than the batched one the kernel reproduces (4099
    lanes and the 1080p frame's, chip_smoke.py `shade`, are bit for
    bit)."""
    scene, two_level = _shade_scene(kind, cuda)
    lanes = _shade_lanes(scene, two_level, n, 7, cuda)
    shade.reset_launch_counts()
    calls = 0
    for mode in (shade.FULL, shade.THIN, shade.DIRECT):
        for bounce, mesh_samples in ((0, 1), (3, 1), (3, 0)):
            b = torch.full((), bounce, dtype=torch.int64, device=cuda)
            args = (scene, mesh_samples, b, lanes["hit"], lanes["o"],
                    lanes["d"], lanes["active"], lanes["throughput"],
                    lanes["radiance"], lanes["last_pdf"],
                    lanes["last_delta"], mode)
            live = (torch.ones_like(lanes["active"]) if mode == shade.DIRECT
                    else lanes["active"])
            draw = None
            if mode == shade.FULL:
                rng = torch.from_numpy(np.random.RandomState(bounce).randint(
                    0, 2**32, n, dtype=np.int64)).to(cuda)
                draw = shade.DrawIn(scene.env, 1, 4, False, rng)
            _assert_surface(*_surface_both(args, draw), f"{kind} {mode} "
                            f"bounce {bounce}", live,
                            exact=not (two_level and n == 1))
            calls += 1
    assert shade.LAUNCHES["surface"] == calls


def _light_scene(name, device):
    from moonshine_tpu_torch.scene import types
    from moonshine_tpu_torch.scene.world import World

    from torch_light_world import light_world

    return light_world(types, World, name).build(device), False


@pytest.mark.parametrize("kind", ["flagship", "room", "instanced",
                                  "textured", "no_emitters"])
@pytest.mark.parametrize("counts,roulette", [((1, 1), True),
                                             ((2, 1), False),
                                             ((0, 2), True), ((0, 0), True)])
def test_shade_surface_draw_matches_plain(cuda, kind, counts, roulette):
    """The full form with the bounce's light draw (the cut, the roulette,
    each env and mesh sample and its shadow ray) against surface_plain
    with the same draw, 4099 lanes: every material and a textured BSDF
    atlas (the flagship), a constant atlas (the room), two levels (the
    instanced grid), a textured emission and a scene without emitters
    (the light panels, torch_light_world.py); env and mesh samples 1 and
    2; a third of the lanes dead and a sixth missed, lanes whose sample
    pdf is 0. Bit for bit: the mask, throughput and shadow lanes on every
    lane, the PCG state on the lanes live after the roulette, each light
    sample and shadow ray where the ray is traced."""
    if kind in ("textured", "no_emitters"):
        scene, two_level = _light_scene(kind, cuda)
    else:
        scene, two_level = _shade_scene(kind, cuda)
    n = 4099
    lanes = _shade_lanes(scene, two_level, n, 23, cuda)
    env_samples, mesh_samples = counts
    rs = np.random.RandomState(29)
    rng = torch.from_numpy(rs.randint(0, 2**32, n, dtype=np.int64)).to(cuda)
    b = torch.full((), 4 if roulette else 2, dtype=torch.int64, device=cuda)
    args = (scene, mesh_samples, b, lanes["hit"], lanes["o"], lanes["d"],
            lanes["active"], lanes["throughput"], lanes["radiance"],
            lanes["last_pdf"], lanes["last_delta"], shade.FULL)
    draw = shade.DrawIn(scene.env, env_samples, 4, roulette, rng)
    shade.reset_launch_counts()
    got, want = _surface_both(args, draw)
    assert shade.LAUNCHES["surface"] == 1
    _assert_surface(got, want, f"{kind} draw", lanes["active"])
    _assert_bits(got.throughput, want.throughput, "throughput")
    alive = want.active
    if roulette:
        assert 0 < int(alive.sum()) < int(lanes["active"].sum())
    _assert_bits(got.rng[alive], want.rng[alive], "rng")
    if not env_samples + mesh_samples:
        assert got.shadow is None and want.shadow is None
        return
    assert (got.lights.env_samples, got.lights.mesh_samples) == counts
    _assert_bits(got.shadow.lane, want.shadow.lane, "shadow lanes")
    traced = want.shadow.lane
    for k in ("o", "d", "t_max"):
        _assert_bits(getattr(got.shadow, k)[traced],
                     getattr(want.shadow, k)[traced], f"shadow {k}")
    traced = want.lights.lane
    for k in ("dir", "radiance", "pdf"):
        _assert_bits(getattr(got.lights, k)[traced],
                     getattr(want.lights, k)[traced], f"light {k}")
    # lanes whose mesh sample has pdf 0 (a point beside or behind the
    # light; every lane without emitters) trace no ray for it
    drawn = alive & ~torch.isin(want.mat.type, torch.tensor(
        [0, 2], device=cuda))
    if mesh_samples:
        zero = (want.lights.pdf[env_samples:] == 0.0) & drawn
        assert bool(zero.any()) and not bool((zero & traced[
            env_samples:]).any())
    if kind == "no_emitters" and mesh_samples:
        assert not bool(traced[env_samples:].any())


def _shade_lights(n, seed, device, counts, live):
    """Seeded NEE samples for the scatter kernel, `counts` (env, mesh)
    of them: env draws and random ones alternately, with lanes (among the
    `live` ones, as the draw traces them) and occlusion at random."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    env = _env("map", device)
    dirs, rads, pdfs = [], [], []
    s = sum(counts)
    for k in range(s):
        if k % 2 == 0:
            l_dir, l_rad, l_pdf = shade.env_draw(env, put(rs.rand(n, 2)
                                                          .astype(f32)))
        else:
            d = rs.randn(n, 3).astype(f32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            pdf = rs.rand(n).astype(f32) * 2
            pdf[rs.rand(n) < 0.1] = 0.0
            l_dir, l_rad, l_pdf = put(d), put(rs.rand(n, 3).astype(f32)), \
                put(pdf)
        dirs.append(l_dir)
        rads.append(l_rad)
        pdfs.append(l_pdf)
    if not s:
        return None
    pdf = torch.stack(pdfs)
    return shade.Lights(torch.stack(dirs), torch.stack(rads), pdf,
                        put(rs.rand(s, n) > 0.3) & (pdf > 0.0) & live,
                        put(rs.rand(s, n) < 0.3), *counts)


def _env(kind, device):
    from moonshine_tpu_torch.lights import envmap

    if kind == "constant":
        return envmap.envmap_from_arrays(envmap.constant_envmap(
            (0.7, 0.8, 1.1)), device)
    rs = np.random.RandomState(3)
    sky = (rs.rand(32, 64, 3) ** 4 * 5).astype(np.float32)
    env = envmap.envmap_from_arrays(envmap.build_envmap(sky), device)
    assert env.size == 32
    return env


@pytest.mark.parametrize("mat_type", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("counts", [(1, 1), (2, 1), (0, 0), (3, 2),
                                    (4, 6)])
def test_shade_scatter_matches_plain(cuda, mat_type, counts):
    """The scatter kernel against scatter_plain bit for bit on the
    flagship's decoded lanes, as they are (None: every material) and with
    every lane's material set to glass, Lambert, mirror or PBR; with no
    light sample, one env and one mesh sample, sample counts of 2, five
    samples, and ten (4 env, 6 mesh: each weighted by its kind's count,
    all in one launch). The kernel updates the state in place (on copies here):
    active, o, d and throughput are held on every lane, the radiance on
    every lane as values, last_pdf, last_delta and rng on the lanes live
    on entry (a dead lane writes its mask alone)."""
    scene, _ = _shade_scene("flagship", cuda)
    n = 4099
    lanes = _shade_lanes(scene, False, n, 11, cuda)
    rng = torch.from_numpy(np.random.RandomState(7).randint(
        0, 2**32, n, dtype=np.int64)).to(cuda)
    surf = shade.surface(scene, 1, 2, lanes["hit"], lanes["o"], lanes["d"],
                         lanes["active"].clone(), lanes["throughput"],
                         lanes["radiance"].clone(), lanes["last_pdf"],
                         lanes["last_delta"], shade.FULL,
                         shade.DrawIn(scene.env, 0, 4, False, rng))
    if mat_type is not None:
        surf = surf._replace(mat=surf.mat._replace(
            type=torch.full_like(surf.mat.type, mat_type)))
    live = lanes["active"]
    assert set(surf.mat.type[live].tolist()) >= (
        {0, 1, 2, 3} if mat_type is None else {mat_type})
    rs = np.random.RandomState(5)
    rng = torch.from_numpy(rs.randint(0, 2**32, n, dtype=np.int64)).to(cuda)
    lights = _shade_lights(n, 13, cuda, counts, live)
    args = (surf, lanes["o"], lanes["d"], lanes["throughput"],
            surf.radiance, rng, live, lights)
    state = dict(active=torch.ones_like(live),
                 last_pdf=torch.zeros(n, device=cuda),
                 last_delta=torch.zeros_like(live))
    shade.reset_launch_counts()
    got = shade.scatter(surf, *(x.clone() for x in args[1:6]), live, lights,
                        state=state)
    want = shade.scatter_plain(*args, state={})
    assert shade.LAUNCHES["scatter"] == 1
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        if k == "radiance":
            assert bool((g == w).all()), "scatter radiance"
            g, w = g[live], w[live]
        elif k in ("last_pdf", "last_delta", "rng"):
            g, w = g[live], w[live]
        _assert_bits(g, w, f"scatter {k}")
    assert bool(got["active"].any())
    assert got["active"] is state["active"]


@pytest.mark.parametrize("env_kind", ["constant", "map"])
def test_shade_env_kernels_match_plain(cuda, env_kind):
    """The env miss kernel against env_miss_plain (env samples 0, 1 and
    2; bounce 0 and 2; live shares of 100%, 10% and 1%, a sixth of the
    lanes missed), in place on the radiance and the mask as the loop
    calls it: every lane's radiance and mask bit for bit, the lanes it
    does not write too (their radiance as it was, -0.0 kept), and the
    env draw kernel against env_draw_plain (rand 0, near 1 and seeded),
    bit for bit, at env size 1 and 32."""
    env = _env(env_kind, cuda)
    scene, _ = _shade_scene("room", cuda)
    n = 4099
    lanes = _shade_lanes(scene, False, n, 17, cuda)
    rs = np.random.RandomState(23)
    draw = torch.from_numpy(rs.rand(n)).to(cuda)
    radiance = lanes["radiance"].clone()
    radiance[torch.from_numpy(rs.rand(n) < 0.05).to(cuda)] = -0.0
    shade.reset_launch_counts()
    for share in (1.0, 0.1, 0.01):
        active = draw < share
        missed = active & (lanes["hit"].tri < 0)
        assert int(missed.sum()) > 0 and int((active & ~missed).sum()) > 0
        for env_samples in (0, 1, 2):
            for bounce in (0, 2):
                args = (env, env_samples, bounce, lanes["d"], active,
                        lanes["hit"].tri, lanes["throughput"], radiance,
                        lanes["last_pdf"], lanes["last_delta"])
                want_rad, want_active = shade.env_miss_plain(*args)
                rad, act = radiance.clone(), active.clone()
                got = shade.env_miss(*args[:4], act, *args[5:7], rad,
                                     *args[8:])
                assert got[0] is rad and got[1] is act
                what = f"env_miss {share} {env_samples} {bounce}"
                _assert_bits(rad, want_rad, f"{what} radiance")
                _assert_bits(act, want_active, f"{what} mask")
                _assert_bits(rad[~missed], radiance[~missed],
                             f"{what} radiance of the lanes left")
                assert torch.equal(act, active & (lanes["hit"].tri >= 0))
    assert shade.LAUNCHES["env_miss"] == 18
    rs = np.random.RandomState(19)
    rand2 = rs.rand(n, 2).astype(np.float32)
    rand2[:3] = [[0, 0], [np.float32(1 - 2**-24), 0.5],
                 [0.5, np.float32(1 - 2**-24)]]
    rand2 = torch.from_numpy(rand2).to(cuda)
    for got, want, name in zip(shade.env_draw(env, rand2),
                               shade.env_draw_plain(env, rand2),
                               ("dir", "radiance", "pdf")):
        _assert_bits(got, want.contiguous(), f"env_draw {name}")
    assert shade.LAUNCHES["env_draw"] == 1


# --- the lane sort (csrc/sort.cu) ---

def _sort_case(device, n, case, seed):
    """(key int32 [n], bits, columns) of a sort case: `ties` (six keys and
    dead ones), `dead` (every key dead), `resort` / `packet` (each site's
    range, a share dead), `treelet` ((K + 1) x 512 keys, K = 379, none
    dead: three passes); columns of every kind the sites move (bool,
    int32, int64, float32 [N] and [N, 3], the treelet's [N, 12] int32
    pending words)."""
    from moonshine_tpu_torch.core import sortutil

    rs = np.random.RandomState(seed)
    bits, live, dead = {"ties": (12, 6, 0.3), "dead": (9, 1, 1.0),
                        "resort": (12, 4096, 0.4), "packet": (9, 512, 0.2),
                        "treelet": (18, 380 * 512, 0.0)}[case]
    key = rs.randint(0, live, n).astype(np.int32)
    key[rs.rand(n) < dead] = sortutil.DEAD_KEY
    cols = [rs.rand(n) > 0.5, rs.randint(-2**31, 2**31 - 1, n).astype(np.int32),
            rs.randint(-2**62, 2**62, n).astype(np.int64),
            rs.randn(n).astype(np.float32),
            rs.randn(n, 3).astype(np.float32),
            rs.randint(-2**31, 2**31 - 1, (n, 12)).astype(np.int32)]
    return (torch.from_numpy(key).to(device), bits,
            [torch.from_numpy(c).to(device) for c in cols])


@pytest.mark.parametrize("case", ["ties", "dead", "resort", "packet",
                                  "treelet"])
@pytest.mark.parametrize("n", [1, 100, 4096, 4097, 70001])
def test_sort_lanes_matches_argsort(cuda, case, n):
    """The sort kernels' permutation equals torch.argsort(key,
    stable=True) bit for bit (below one tile, one tile, ragged, many
    tiles), every moved column equals its plain move, and unsort_lanes
    (one move launch) puts them back."""
    from moonshine_tpu_torch.core import sortutil

    key, bits, cols = _sort_case(cuda, n, case, n + len(case))
    sortutil.reset_launch_counts()
    perm, moved = sortutil.sort_lanes(key, cols, bits)
    want_perm, want = sortutil.sort_lanes_plain(key, cols, bits)
    assert torch.equal(perm, torch.argsort(key, stable=True).int())
    _assert_bits(perm, want_perm, f"{case} perm")
    for j, (g, w) in enumerate(zip(moved, want)):
        _assert_bits(g, w, f"{case} column {j}")
    back = sortutil.unsort_lanes(perm, moved)
    for j, (g, w) in enumerate(zip(back, cols)):
        _assert_bits(g, w, f"{case} unsorted column {j}")
    for g, w in zip(back, sortutil.unsort_lanes_plain(perm, moved)):
        _assert_bits(g, w, f"{case} unsort against its plain version")
    assert sortutil.LAUNCHES == {"sort_lanes": 1, "unsort_lanes": 1}


def test_sort_lanes_rows_out_and_empty(cuda):
    """`rows` and `out` as the resort uses them (each array's first rows
    by the permutation, the tail arrays past the key's lanes where they
    lie, nothing else of `out` written), and an empty key."""
    from moonshine_tpu_torch.core import sortutil

    key, bits, cols = _sort_case(cuda, 9000, "resort", 3)
    longer = [torch.cat([c, c[:1000]]) for c in cols]  # 10,000 lanes
    rows = [6000, 10000, 9000, 2000, 10000, 0]
    for plain in (False, True):
        out = [torch.zeros_like(c) for c in longer]
        fn = sortutil.sort_lanes_plain if plain else sortutil.sort_lanes
        perm, got = fn(key, longer, bits, out=out, rows=rows)
        assert all(g is o for g, o in zip(got, out))
        if not plain:
            kernel = [g.clone() for g in got]
    for j, (g, w) in enumerate(zip(kernel, got)):
        _assert_bits(g, w, f"rows/out column {j}")
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    perm, got = sortutil.sort_lanes(empty, [c[:0] for c in cols], bits)
    assert perm.shape == (0,) and all(g.shape[0] == 0 for g in got)


def _wild_keys(device, n, bits, seed):
    """int32 keys of every kind for a `bits`-bit sort: in range (a few
    distinct values, so digits tie), the dead key, negative ones, 2^bits
    itself and keys past it up to the int32 maximum."""
    from moonshine_tpu_torch.core import sortutil

    rs = np.random.RandomState(seed)
    live = 1 << bits
    key = rs.randint(0, live, n).astype(np.int64)
    key[rs.rand(n) < 0.5] = rs.randint(0, min(live, 7))
    kind = rs.rand(n)
    key[kind < 0.15] = sortutil.DEAD_KEY
    key[(kind >= 0.15) & (kind < 0.2)] = -rs.randint(1, 2**31)
    key[(kind >= 0.2) & (kind < 0.22)] = live
    key[(kind >= 0.22) & (kind < 0.25)] = rs.randint(live, 2**31 - 1)
    return torch.from_numpy(key.astype(np.int32)).to(device)


@pytest.mark.parametrize("bits", [0, 7, 9, 10, 12, 18, 20, 21, 30])
@pytest.mark.parametrize("n", [4095, 8193, 1_000_003, 2_073_600])
def test_sort_lanes_every_digit_plan(cuda, bits, n):
    """Every digit plan: one pass up to 10 bits (the packet key's 9 bits in
    one pass of 513 buckets, 10 bits in one of 1025), two up to 20 (the
    resort's 12, a treelet key's 18), three above (21, 30), and the plans
    of 8-bit digits (7 bits in one pass, 9 and 12 in two, 18 in three);
    sizes whose tiles make long look-back chains and odd tails; keys of
    every kind (`_wild_keys`). The permutation equals torch.argsort of
    the mapped key bit for bit (keys past the range sort as one value
    after it), and the plain version's; two columns move as their plain
    moves do."""
    from moonshine_tpu_torch.core import sortutil

    key = _wild_keys(cuda, n, bits, n + bits)
    rs = np.random.RandomState(bits)
    cols = [torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(cuda),
            torch.from_numpy(rs.rand(n) > 0.5).to(cuda)]
    perm, moved = sortutil.sort_lanes(key, cols, bits)
    mapped = sortutil.mapped_key(key, bits)
    assert int(mapped.max()) <= 1 << bits and int(mapped.min()) >= 0
    assert torch.equal(perm, torch.argsort(mapped, stable=True).int())
    want_perm, want = sortutil.sort_lanes_plain(key, cols, bits)
    _assert_bits(perm, want_perm, f"bits {bits} perm")
    for j, (g, w) in enumerate(zip(moved, want)):
        _assert_bits(g, w, f"bits {bits} column {j}")


@pytest.mark.parametrize("case", ["packet", "treelet"])
def test_sort_lanes_replays_in_a_graph(cuda, case):
    """The sort and move captured in a CUDA graph (no host read, no sync,
    the workspace from the graph's pool) and replayed on new keys in the
    captured buffer, several times and on keys of other kinds (every key
    dead, keys past the range): the permutation of those keys each time,
    so the look-back flags and tile counters are reset by the graph
    itself (one pass for the packet key, two for the treelet's)."""
    from moonshine_tpu_torch.core import sortutil

    n = 50000
    key, bits, cols = _sort_case(cuda, n, case, 9)
    static = key.clone()
    sortutil.sort_lanes(static, cols, bits)  # the build, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with launch.launch_tally() as tally:
        with torch.cuda.graph(graph):
            perm, moved = sortutil.sort_lanes(static, cols, bits)
    assert len(tally) == 1
    fresh = [_sort_case(cuda, n, case, seed)[0] for seed in (1, 2, 3)]
    fresh += [_sort_case(cuda, n, "dead", 4)[0], _wild_keys(cuda, n, bits, 5),
              _sort_case(cuda, n, case, 1)[0]]
    for new in fresh:
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want_perm, want = sortutil.sort_lanes_plain(new, cols, bits)
        _assert_bits(perm, want_perm, "replayed perm")
        for g, w in zip(moved, want):
            _assert_bits(g, w, "replayed column")


def _key_lanes(device, n, seed, live_share=0.7, wild=True):
    """(o, d, active, major) for coherence keys: origins inside and (wild)
    far outside the box (cells past the int32 range saturate), zero and
    (wild) NaN components; `live_share` of the lanes live; major keys of
    380 treelets."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 4).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d[rs.rand(n, 3) < 0.1] = 0.0
    if wild:
        o[rs.rand(n, 3) < 0.05] = 3e38
        o[rs.rand(n, 3) < 0.02] = np.nan
        d[rs.rand(n, 3) < 0.02] = np.nan
    put = lambda x: torch.from_numpy(x).to(device)
    return (put(o), put(d), put(rs.rand(n) < live_share),
            put(rs.randint(0, 380, n).astype(np.int32)))


_KEY_BOUNDS = [[-1.5, 0.0, 2.0], [3.0, 4.5, 2.0]]  # a flat z axis


@pytest.mark.parametrize("cells", [4, 8])
@pytest.mark.parametrize("n", [1, 4099])
def test_coherence_key_matches_plain(cuda, cells, n):
    """The coherence key that the sort's first kernel makes from the
    lanes' inputs (compare_sort.keyed_of reads it back from the
    workspace) against coherence_key_plain bit for bit: origins inside
    and far outside the box (cells past the int32 range saturate), a
    flat axis, zero and NaN components, with and without the mask and
    the major key; its permutation is torch.argsort of the plain key."""
    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.scripts.compare_sort import keyed_of

    bounds = torch.tensor(_KEY_BOUNDS, device=cuda)
    o, d, active, major = _key_lanes(cuda, n, n + cells)
    for kw in ({}, {"active": active}, {"major": major},
               {"active": active, "major": major}):
        bits = ((380 if "major" in kw else 1) * cells ** 3 * 8
                - 1).bit_length()
        run, perm, got = keyed_of(native.sort_lib(), sortutil.KeyIn(
            o, d, bounds, cells, **kw), bits)
        run()
        want = sortutil.coherence_key_plain(o, d, bounds, cells, **kw)
        _assert_bits(got, want, f"coherence key {sorted(kw)}")
        _assert_bits(perm, torch.argsort(sortutil.mapped_key(want, bits),
                                         stable=True).int(),
                     f"keyed permutation {sorted(kw)}")


@pytest.mark.parametrize("share", [1.0, 0.01, 0.0])
@pytest.mark.parametrize("n", [4097, 1_000_003])
def test_sort_lanes_by_key_inputs(cuda, share, n):
    """sort_lanes given the key's inputs, as every site calls it (the
    resort's 8^3 cells with its mask and prefix rows; the packet
    dispatch's 4^3 with its mask; the treelet dispatch's 4^3 after the
    major key), on full, 1%-live and all-dead batches: the permutation
    equals torch.argsort(coherence_key_plain(...), stable=True) and
    every moved column sort_lanes_plain's, bit for bit; then the same
    sort captured in a CUDA graph and replayed on fresh lanes in the
    captured buffers."""
    from moonshine_tpu_torch.core import sortutil

    bounds = torch.tensor(_KEY_BOUNDS, device=cuda)
    o, d, active, major = _key_lanes(cuda, n, n, share, wild=False)
    cols = _sort_case(cuda, n, "resort", 3)[2]
    for cells, kw, bits in (
            (8, {"active": active}, sortutil.key_bits(8)),
            (4, {"active": active}, sortutil.key_bits(4)),
            (4, {"major": major}, (380 * 512 - 1).bit_length())):
        key_in = sortutil.KeyIn(o, d, bounds, cells, **kw)
        want_key = sortutil.coherence_key_plain(o, d, bounds, cells, **kw)
        perm, moved = sortutil.sort_lanes(key_in, cols, bits)
        _assert_bits(perm, torch.argsort(want_key, stable=True).int(),
                     f"{cells} {sorted(kw)} perm")
        want_perm, want = sortutil.sort_lanes_plain(key_in, cols, bits)
        _assert_bits(perm, want_perm, "against the plain version")
        for j, (g, w) in enumerate(zip(moved, want)):
            _assert_bits(g, w, f"{cells} {sorted(kw)} column {j}")
    # the resort's form: `rows` and `out`, inside a graph
    rows = [n // 2, n, n, n // 4, n, n // 3]
    static = [x.clone() for x in (o, d, active)]
    key_in = sortutil.KeyIn(*static[:2], bounds, 8, static[2])
    out = [torch.zeros_like(c) for c in cols]
    sortutil.sort_lanes(key_in, cols, 12, out=out, rows=rows)  # the build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with launch.launch_tally() as tally:
        with torch.cuda.graph(graph):
            sortutil.sort_lanes(key_in, cols, 12, out=out, rows=rows)
    assert len(tally) == 1
    for seed in (1, 2):
        fresh = _key_lanes(cuda, n, seed, share, wild=False)[:3]
        for x, y in zip(static, fresh):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        want_out = [torch.zeros_like(c) for c in cols]
        sortutil.sort_lanes_plain(key_in, cols, 12, out=want_out, rows=rows)
        for j, (g, w) in enumerate(zip(out, want_out)):
            _assert_bits(g, w, f"replayed column {j}")


# --- a sample's camera rays, accumulation and counts (csrc/frame.cu,
# render/frame_kernels.py; the counts in csrc/shade.cu) ---

# (height, width, y0, bh, nbatch), flipped, aperture: scanline, tiled
# (128x256), a scanline band and a tiled band below the first row, three
# samples a batch tiled, and a ragged lane count (37 x 53 x 2 lanes)
FRAME_CASES = {"scanline": ((48, 80, 0, 48, 1), True, 0.25),
               "tiled": ((128, 256, 0, 128, 1), False, 0.25),
               "band": ((96, 80, 32, 40, 1), True, 0.0),
               "tiled_band": ((128, 128, 64, 64, 1), False, 0.0),
               "batch3": ((64, 128, 0, 64, 3), True, 0.25),
               "ragged": ((61, 53, 24, 37, 2), False, 0.1)}


def _frame_lens(aperture, device, seed=0):
    from moonshine_tpu_torch.render.camera import LensArrays

    rs = np.random.RandomState(seed)
    f32 = lambda x: torch.tensor(np.float32(x), device=device)
    return LensArrays(
        origin=f32(rs.randn(3) * 2), forward=f32(rs.randn(3)),
        up=f32([0.1, 0.2, 1.0] + rs.randn(3) * 0.05),
        vfov=f32(0.5 + rs.rand()), aperture=f32(aperture),
        focus_distance=f32(1.0 + 3 * rs.rand()))


def _frame_trace(n, device):
    from moonshine_tpu_torch.integrator import path as P

    return P._Trace(n, device, P.PathConfig(), resort=True, unroll=True,
                    sort_first=False, capture=False)


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_raygen_kernel_equals_plain(cuda, case):
    """The raygen kernel (one launch) against its plain version (the
    camera rays of each sample, torch.cat, _Trace.reset) bit for bit:
    o, d, rng and every buffer and scalar reset writes, each trace's
    buffers filled with junk first; and sample_rays' kernel into fresh
    tensors against sample_rays_plain."""
    from moonshine_tpu_torch.render import frame_kernels as FK

    (h, w, y0, bh, nb), flip, aperture = FRAME_CASES[case]
    lens = _frame_lens(aperture, cuda, seed=len(case))
    sample = torch.tensor(2**32 - 2, dtype=torch.int64, device=cuda)
    traces = [_frame_trace(nb * bh * w, cuda) for _ in range(2)]
    for tr in traces:
        for st in tr.bufs:
            for v in st.values():
                v.copy_(torch.randint(0, 2, v.shape, device=cuda)
                        .to(v.dtype))
        tr.bounce.fill_(7), tr.widx.fill_(0), tr.live.fill_(-1)
    FK.reset_launch_counts()
    FK.raygen(lens, sample, h, w, y0, bh, nb, flip, traces[0])
    assert FK.LAUNCHES["raygen"] == 1
    FK.raygen_plain(lens, sample, h, w, y0, bh, nb, flip, traces[1])
    got, want = traces[0], traces[1]
    for k in got.bufs[0]:
        _assert_bits(got.bufs[0][k], want.bufs[0][k], f"raygen {k}")
    for k in ("bounce", "widx", "live"):
        _assert_bits(getattr(got, k), getattr(want, k), f"raygen {k}")
    if nb == 1:
        mine = FK.sample_rays(lens, h, w, 9, flip, cuda, y0, bh)
        plain = FK.sample_rays_plain(lens, h, w, 9, flip, cuda, y0, bh)
        for k, a, b in zip(("o", "d", "rng"), mine, plain):
            _assert_bits(a, b, f"sample_rays {k}")
        assert FK.LAUNCHES["raygen"] == 2


@pytest.mark.parametrize("pix", [False, True])
@pytest.mark.parametrize("shape", [(48, 80, 1), (48, 80, 3), (128, 256, 1),
                                   (128, 256, 3), (37, 53, 2), (40, 80, 1)])
def test_accumulate_kernel_equals_plain(cuda, shape, pix):
    """The accumulation (one launch; with pix and several samples a
    batch, a scatter first) against its plain version (index_copy_ by
    pix, the batch summed left to right, the tile un-permute, acc +=)
    bit for bit, on seeded radiance of every magnitude (subnormal sums
    too), scanline and tiled, one and three samples a batch, a band's 40
    rows: acc [h, w, 4], its 4th float (NaN here) as it was; the
    tally's adds (rays, segments, the sample index) in the same launch.
    At one sample a batch with pix, the entry point's two-pass form (a
    scratch given) gives the same bits."""
    from moonshine_tpu_torch.render import frame_kernels as FK

    h, w, nb = shape
    n = nb * h * w
    rs = np.random.RandomState(n)
    acc = rs.rand(h, w, 4)
    rad = rs.rand(n, 3) * 10.0 ** rs.randint(-6, 6, (n, 1))
    acc[::3] *= -1e-39  # subnormal sums, which an add must not flush
    rad[::5] *= 1e-39 * np.where(rs.rand(n // 5 + (n % 5 > 0), 1) < 0.5,
                                 -1.0, 1.0)
    acc = torch.from_numpy(acc.astype(np.float32)).to(cuda)
    acc[..., 3] = float("nan")
    rad = torch.from_numpy(rad.astype(np.float32)).to(cuda)
    order = (torch.from_numpy(rs.permutation(n)).to(cuda) if pix else None)
    got, want = acc.clone(), acc.clone()
    i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=cuda)
    tallies = [FK.Tally(rays=i64(5), trace_rays=i64(n * 3), segments=i64(2),
                        bounce=i64(4), sample=i64(2**33 + 1))
               for _ in range(2)]
    FK.reset_launch_counts()
    FK.accumulate(got, rad, order, nb, tallies[0])
    FK.accumulate_plain(want, rad, order, nb, tallies[1])
    assert FK.LAUNCHES["accumulate"] == 1
    _assert_bits(got, want, f"accumulate {shape} pix {pix}")
    for a, b in zip(*tallies):
        assert int(a) == int(b)
    assert int(tallies[0].sample) == 2**33 + 1 + nb
    if pix and nb == 1:
        two = acc.clone()
        FK._accumulate_launch(two, rad, order, 1, torch.empty(
            (n, 4), device=cuda), None)
        _assert_bits(two, want, f"two-pass accumulate {shape}")


def test_frame_replays_a_new_lens_and_sample(cuda, monkeypatch):
    """A frame's captured steps read the lens and the sample index on the
    device: render_spp of the flagship at 64x64 with a second lens and
    another first sample replays (no capture) and equals the eager loop
    on them bit for bit, in the unrolled and the looped form."""
    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.flagship_scene()
    scene = world.build(cuda)
    first = LensArrays.from_lens(lens, cuda)
    moved = first._replace(origin=first.origin + 0.3,
                           aperture=torch.tensor(0.05, device=cuda))
    for unroll in (True, False):
        cfg = PathConfig(**CFG4, unroll=unroll)
        with graphs.eager():
            want = render_spp(scene, moved, 64, 64, 11, 2, cfg)
        graphs.clear()
        render_spp(scene, first, 64, 64, 0, 2, cfg)  # captures
        graphs.reset_counts()
        got = render_spp(scene, moved, 64, 64, 11, 2, cfg)
        torch.cuda.synchronize()
        assert graphs.COUNTS["captures"] == 0 and graphs.COUNTS["replays"]
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    graphs.clear()


@pytest.mark.parametrize("form", ["unrolled", "looped", "resorted",
                                  "two_level"])
def test_counts_equal_torch_sums(cuda, monkeypatch, form):
    """The counts the kernels fold in (the surface's shadow rays into the
    ray count, the scatter's live lanes) after every segment of a traced
    sample on the eager loop: the live count equals the sum of the
    state's mask, the rays the lanes live at each segment's start plus
    the shadow rays set, as torch sums them; in the unrolled and looped
    forms, resorted over live prefixes (64x64 lanes), and two-level.
    Then the same sample as graph replays gives the same rays."""
    import os

    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.integrator import path as P
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural

    if form == "two_level":
        world, lens = procedural.instanced_scene(grid=(5, 4),
                                                 subdivisions=2)
        os.environ["MSN_FORCE_TLAS"] = "1"
        try:
            scene = world.build(cuda)
        finally:
            del os.environ["MSN_FORCE_TLAS"]
        assert scene.tlas is not None
    else:
        world, lens = procedural.flagship_scene()
        scene = world.build(cuda)
    la = LensArrays.from_lens(lens, cuda)
    cfg = PathConfig(**dict(CFG4, max_bounces=12 if form == "looped" else 4),
                     unroll=form != "looped",
                     resort_bounces=form == "resorted")
    expect, seen = {"rays": 0}, []
    body, surface = P._bounce_body, shade.surface

    def counted_surface(*args, **kw):
        surf = surface(*args, **kw)
        if surf.shadow is not None:
            expect["rays"] += int(surf.shadow.lane.sum())
        return surf

    def counted_body(scene, cfg, bounce, st, **kw):
        expect["rays"] += int(st["active"].sum())
        out = body(scene, cfg, bounce, st, **kw)
        seen.append((int(kw["live"]), int(out["rays"]),
                     int(out["active"].sum()), expect["rays"],
                     st["o"].shape[0]))
        return out

    with monkeypatch.context() as m:
        m.setattr(P, "_bounce_body", counted_body)
        m.setattr(shade, "surface", counted_surface)
        with graphs.eager():
            graphs.clear()
            img, rays = render_spp(scene, la, 64, 64, 3, 1, cfg)
    assert len(seen) >= 4
    for live, n_rays, want_live, want_rays, _ in seen:
        assert (live, n_rays) == (want_live, want_rays)
    assert int(rays) == seen[-1][1]
    if form == "resorted":
        assert min(s[4] for s in seen) < 4096  # a live prefix ran
    graphs.clear()
    render_spp(scene, la, 64, 64, 3, 1, cfg)
    again = render_spp(scene, la, 64, 64, 3, 1, cfg)
    assert torch.equal(again[0], img) and int(again[1]) == int(rays)
    graphs.clear()


@pytest.mark.parametrize("lanes", ["dead", "last_one", "seeded"])
def test_counts_exact_on_partial_blocks(cuda, lanes):
    """The counts the full surface kernel (its shadow rays) and the
    scatter (the lanes it leaves live) fold in, on 4099 lanes (the last
    block partial): every lane dead, one live lane (the last, in the
    partial block) and a seeded third dead with hit and missed lanes;
    each count equals the plain version's and the torch sum of the
    kernel's own mask, exactly."""
    scene, _ = _shade_scene("flagship", cuda)
    n = 4099
    lane = _shade_lanes(scene, False, n, 31, cuda)
    hit, active = lane["hit"], lane["active"]
    if lanes != "seeded":
        active = torch.zeros_like(active)
    if lanes == "last_one":
        hit = hit._replace(tri=hit.tri.clone())
        hit.tri[-1] = 1
        active[-1] = True
    rs = np.random.RandomState(3)
    rng = torch.from_numpy(rs.randint(0, 2**32, n, dtype=np.int64)).to(cuda)
    b = torch.full((), 2, dtype=torch.int64, device=cuda)
    args = (scene, 1, b, hit, lane["o"], lane["d"], active,
            lane["throughput"], lane["radiance"], lane["last_pdf"],
            lane["last_delta"], shade.FULL)
    rays = [torch.zeros((), dtype=torch.int64, device=cuda)
            for _ in range(2)]
    shade.reset_launch_counts()
    kargs = list(args)
    for j in (6, 7, 8):
        kargs[j] = kargs[j].clone()
    surf = shade.surface(*kargs, draw=shade.DrawIn(
        scene.env, 1, 4, False, rng.clone()), rays=rays[0])
    want = shade.surface_plain(*args, draw=shade.DrawIn(
        scene.env, 1, 4, False, rng.clone()), rays=rays[1])
    traced = int(surf.shadow.lane.sum())
    assert int(rays[0]) == int(rays[1]) == traced
    assert (traced == 0) == (lanes == "dead")
    lights = _shade_lights(n, 13, cuda, (1, 1), surf.active)
    live = [torch.zeros((), dtype=torch.int64, device=cuda)
            for _ in range(2)]
    outs = []
    for fn, counter in ((shade.scatter, live[0]),
                        (shade.scatter_plain, live[1])):
        state = dict(active=torch.ones_like(active),
                     last_pdf=torch.zeros(n, device=cuda),
                     last_delta=torch.zeros_like(active))
        outs.append(fn(surf, lane["o"].clone(), lane["d"].clone(),
                       lane["throughput"].clone(), surf.radiance.clone(),
                       rng.clone(), surf.active, lights,
                       state=state if fn is shade.scatter else {},
                       live=counter))
    assert int(live[0]) == int(live[1]) == int(outs[0]["active"].sum())
    assert int(want.active.sum()) == int(surf.active.sum())
    assert shade.LAUNCHES["counts"] == 2
