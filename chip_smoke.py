"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, PATH or /usr/local/cuda). Each
phase prints lines tagged with its name; a failing phase raises and the
script exits non-zero without the result line. Phases:

  device          the card's name and power limit (nvidia-smi)
  build           nvcc builds csrc/traverse.cu and csrc/treelet.cu into
                  build/, one process each, started together
  scenes          flagship, room_184k (SAH, 24-wide / 24-slot) and
                  room_184k as the treelet build (MSN_WIDE=8
                  MSN_LEAF_CAP=8): builder, layout, row bytes against the
                  reference's 10 MiB budget, dispatch mode, stack bound, K
  kernels         each kernel against its plain torch version (packet
                  kernels on flagship and room_184k, treelet kernels on the
                  treelet build, also against the packet kernel there):
                  camera rays plus a seeded bounce batch with dead lanes
  flagship        render_spp of the flagship, 512x512, 8 spp, after a
                  warm-up run; Mrays/s from one run's rays and time
  goldens         furnace (every pixel 1) and mirror_glass against the
                  committed golden image
  room_184k       render_spp of room_184k, 512x512, 2 spp (fused path)
  room_1080p      room_184k, 1920x1080 x 2 spp through render_spp (the
                  staged path, resort on), packet kernels
  treelet_1080p   the same frame with MSN_TREELETS=1 on the treelet build,
                  treelet kernels; its image against room_1080p's
  staged_vs_fused room_184k 512x512 x 1 spp through both paths
  timings         each kernel at the largest shape of the 1080p main path
                  (2,073,600 closest-hit rays, 4,147,200 shadow rays): the
                  kernel held against its plain version there and timed
                  beside it, its bound from the plain version's visit
                  counts, and the treelet dispatch's phase 1 alone

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
INF_T = 1.0e12
HD = (1080, 1920)
# the card's published peaks (H100 SXM, NVIDIA's data sheet): fp32 outside
# the tensor cores, and HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "closest_hit": ("moonshine_tpu_torch/csrc/traverse.cu",
                    "moonshine_tpu/accel/packet.py:825"),
    "any_hit": ("moonshine_tpu_torch/csrc/traverse.cu",
                "moonshine_tpu/accel/packet.py:860"),
    "treelet_closest_hit": ("moonshine_tpu_torch/csrc/treelet.cu",
                            "moonshine_tpu/accel/treelet.py:510"),
    "treelet_any_hit": ("moonshine_tpu_torch/csrc/treelet.cu",
                        "moonshine_tpu/accel/treelet.py:510"),
}
TREELET_ENV = {"MSN_WIDE": "8", "MSN_LEAF_CAP": "8"}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def say(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn over `reps` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grazing(hit, lanes):
    """Lanes whose hit lies within 1e-4 (barycentric) of a triangle edge."""
    u, v = hit.u[lanes], hit.v[lanes]
    return np.minimum(np.minimum(u, v), 1.0 - u - v) < 1e-4


def test_batch(scene, lens):
    """Camera rays (512x512) plus 100,003 seeded rays inside the scene
    box, 10% dead lanes, and a finite any-hit t_max per lane."""
    import torch

    from moonshine_tpu_torch.render.renderer import _sample_rays

    dev = scene.device
    o_cam, d_cam, _, _ = _sample_rays(lens, 512, 512, 0, True, dev)
    rs = np.random.RandomState(7)
    n_syn = 100_003  # with 262144 camera rays: not a multiple of 128
    lo, hi = (scene.wide.bounds[0].cpu().numpy(),
              scene.wide.bounds[1].cpu().numpy())
    o_syn = (lo + rs.rand(n_syn, 3) * (hi - lo)).astype(np.float32)
    d_syn = rs.randn(n_syn, 3).astype(np.float32)
    d_syn /= np.linalg.norm(d_syn, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_syn).to(dev)])
    d = torch.cat([d_cam, torch.from_numpy(d_syn).to(dev)])
    n = o.shape[0]
    active = torch.from_numpy(rs.rand(n) > 0.1).to(dev)
    diag = float(np.linalg.norm(hi - lo))
    t_fin = torch.from_numpy(
        (rs.uniform(0.02, 1.0, n) * diag).astype(np.float32)).to(dev)
    return o, d, active, t_fin


def check_closest(name, hk, hp, active, n):
    """Raises unless a kernel's hits agree with the plain ones within the
    bar: is_hit flips only on edge grazes (at most 1e-5 of the rays), t
    within 1e-5 relative, tri differing only on equal t. Returns max|dt|
    over lanes with the same triangle."""
    import torch

    from moonshine_tpu_torch.accel import packet

    torch.cuda.synchronize()
    hk = packet.Hit(*(x.cpu().numpy() for x in hk))
    hp = packet.Hit(*(x.cpu().numpy() for x in hp))
    hit_k, hit_p = hk.tri >= 0, hp.tri >= 0
    if (hit_k[~active.cpu().numpy()]).any():
        raise AssertionError(f"{name}: a dead lane reported a hit")
    miss_dif = np.nonzero(hit_k != hit_p)[0]
    graze_ok = np.where(hit_k[miss_dif], grazing(hk, miss_dif),
                        grazing(hp, miss_dif))
    both = hit_k & hit_p
    rel_t = np.abs(hk.t - hp.t) / np.maximum(np.abs(hp.t), 1e-30)
    tri_dif = np.nonzero(both & (hk.tri != hp.tri))[0]
    same = both & (hk.tri == hp.tri)
    uv_err = max(float(np.abs(hk.u - hp.u)[same].max(initial=0.0)),
                 float(np.abs(hk.v - hp.v)[same].max(initial=0.0)))
    t_err = float(np.abs(hk.t - hp.t)[same].max(initial=0.0))
    ok = (len(miss_dif) <= 1e-5 * n and graze_ok.all()
          and (rel_t[both] <= 1e-5).all() and np.array_equal(
              hk.t[~hit_k & ~hit_p], hp.t[~hit_k & ~hit_p])
          and (rel_t[tri_dif] <= 1e-5).all() and uv_err <= 1e-4)
    say("kernels", f"{name}: {n} rays, {int(hit_p.sum())} hits, is_hit "
        f"mismatches {len(miss_dif)} (grazing {int(graze_ok.sum())}), tri "
        f"ties {len(tri_dif)}, max|dt| {t_err:.3g}, max|duv| {uv_err:.3g}")
    if not ok:
        raise AssertionError(f"{name}: closest hits disagree")
    return t_err, hp


def check_any(name, ok_k, ok_p, wbvh, o, d, t_fin, active):
    """Raises unless occlusion agrees but for edge grazes and hits right at
    t_max, judged from the plain closest hit of each disagreeing lane;
    returns max|occluded_k - occluded_p| (0 or 1)."""
    import torch

    from moonshine_tpu_torch.accel import packet

    n = o.shape[0]
    ok_k, ok_p = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    occ_dif = np.nonzero(ok_k != ok_p)[0]
    occ_graze = np.zeros(0, dtype=bool)
    if len(occ_dif):
        idx = torch.from_numpy(occ_dif).to(o.device)
        hp = packet.Hit(*(x.cpu().numpy() for x in packet.closest_hit_plain(
            wbvh, o[idx], d[idx], INF_T, active_in=active[idx])))
        tf = t_fin[idx].cpu().numpy()
        occ_graze = (grazing(hp, np.arange(len(occ_dif)))
                     | (np.abs(hp.t - tf) <= 1e-5 * tf))
    say("kernels", f"{name}: {n} rays, {int(ok_p.sum())} occluded, "
        f"mismatches {len(occ_dif)} (grazing {int(occ_graze.sum())})")
    if len(occ_dif) > 1e-5 * n or not occ_graze.all():
        raise AssertionError(f"{name}: occlusion disagrees")
    return float(len(occ_dif) > 0)


def compare_packet(name, scene, lens, errs):
    from moonshine_tpu_torch.accel import packet

    o, d, active, t_fin = test_batch(scene, lens)
    n = o.shape[0]
    w = scene.wide
    t_err, _ = check_closest(
        f"{name} closest_hit",
        packet.closest_hit_packet(w, o, d, INF_T, active_in=active),
        packet.closest_hit_plain(w, o, d, INF_T, active_in=active), active, n)
    occ_err = check_any(
        f"{name} any_hit (finite t_max)",
        packet.any_hit_packet(w, o, d, t_fin, active_in=active),
        packet.any_hit_plain(w, o, d, t_fin, active_in=active), w, o, d,
        t_fin, active)
    errs["closest_hit"] = max(errs.get("closest_hit", 0.0), t_err)
    errs["any_hit"] = max(errs.get("any_hit", 0.0), occ_err)


def compare_treelet(scene, lens, errs):
    """Treelet kernels against their plain versions and against the packet
    kernel on the same 8-wide tree (t and is_hit equal, tri only on equal
    t; occlusion equal)."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet

    o, d, active, t_fin = test_batch(scene, lens)
    n = o.shape[0]
    w = scene.wide
    hk = treelet.closest_hit_treelet(w, o, d, INF_T, active_in=active)
    t_err, _ = check_closest(
        "room_184k/treelet treelet_closest_hit", hk,
        treelet.closest_hit_treelet_plain(w, o, d, INF_T, active_in=active),
        active, n)
    pk = packet.closest_hit_packet(w, o, d, INF_T, active_in=active)
    same_t = bool(torch.equal(hk.t, pk.t))
    same_hit = bool(torch.equal(hk.tri >= 0, pk.tri >= 0))
    tie_ok = bool(torch.equal(hk.t[hk.tri != pk.tri], pk.t[hk.tri != pk.tri]))
    say("kernels", f"room_184k/treelet treelet vs packet kernel: t equal "
        f"{same_t}, is_hit equal {same_hit}, tri differs on "
        f"{int((hk.tri != pk.tri).sum())} lanes, all at equal t {tie_ok}")
    if not (same_t and same_hit and tie_ok):
        raise AssertionError("treelet and packet kernels disagree")
    ok_k = treelet.any_hit_treelet(w, o, d, t_fin, active_in=active)
    occ_err = check_any(
        "room_184k/treelet treelet_any_hit (finite t_max)", ok_k,
        treelet.any_hit_treelet_plain(w, o, d, t_fin, active_in=active), w,
        o, d, t_fin, active)
    pa = packet.any_hit_packet(w, o, d, t_fin, active_in=active)
    say("kernels", f"room_184k/treelet treelet vs packet any hit: "
        f"{int((ok_k != pa).sum())} mismatches")
    if not torch.equal(ok_k, pa):
        raise AssertionError("treelet and packet any hit disagree")
    errs["treelet_closest_hit"] = t_err
    errs["treelet_any_hit"] = occ_err


def render_1080p(name, scene, lens, cfg, resort, spp=2):
    """Warm-up sample, then spp samples of the 1080p frame through
    render_spp, which must take the staged path with the resort as given
    (the reference resorts HBM-class scenes, not treelet-scheduled ones,
    which sort inside each dispatch); returns (image, stats, launches)."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet
    from moonshine_tpu_torch.render.renderer import render_spp

    h, w = HD
    render_spp(scene, lens, h, w, 100, 1, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    packet.reset_launch_counts()
    treelet.reset_launch_counts()
    t0 = time.perf_counter()
    acc, rays = render_spp(scene, lens, h, w, 0, spp, cfg, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**packet.LAUNCHES, **treelet.LAUNCHES}
    rays = int(rays)
    img = (acc / spp).cpu().numpy()
    say(name, f"{w}x{h} x {spp} spp: {rays} rays in {dt:.4f} s = "
        f"{rays / dt / 1e6:.3f} Mrays/s, {dt / spp * 1e3:.2f} ms/spp, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"path {stats['path']}, resort {stats['resort']}, segments "
        f"{stats['segments']}, launches {launches}, image mean "
        f"{img.mean():.6f}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if stats["path"] != "staged" or stats["resort"] != resort:
        raise AssertionError(f"{name}: expected the staged path with "
                             f"resort {resort}, got {stats}")
    return img, stats, launches


def bound(name, n, visits, wbvh, k32=0):
    """(bound_ms, bound_by, detail) for one kernel call on n rays that
    touched `visits` (the plain version's count on the same rays)."""
    from moonshine_tpu_torch.accel import packet

    closest = "closest" in name
    ray_in = 12 + 12 + 4 + (4 + 4 * k32 if k32 else 1)  # o, d, t_max, mask
    ray_out = 16 if closest else 1
    row = lambda x: x[0].numel() * x.element_size()
    nbytes = (n * (ray_in + ray_out) + visits.node_rows * row(wbvh.nodes)
              + visits.leaf_rows * row(wbvh.leaves))
    flops = (visits.node_slots * packet.FLOPS_PER_NODE_SLOT
             + visits.leaf_tris * (packet.FLOPS_PER_TRI_CLOSEST if closest
                                   else packet.FLOPS_PER_TRI_ANY))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, (
        f"{visits.nodes} node visits ({visits.node_slots} slots), "
        f"{visits.leaves} leaf visits ({visits.leaf_tris} triangles), "
        f"{visits.node_rows}+{visits.leaf_rows} distinct rows; "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} "
        f"GFLOP -> {t_ops:.4f} ms")


def phase1_bytes(n, k):
    """Bytes that `treelet._pending_masks` moves for n rays and k treelets,
    counted from its tensor ops on [chunk, 32] temporaries (each read and
    each write once, per-ray terms left out; a 1M-lane chunk's tensors
    exceed L2): per axis two slabs (a subtract and a multiply, 12 B each)
    and a min and a max (12 B each), on axes 1-2 also the running max and
    min (12 B each): 192 B; the hit mask 27 B, the bit-word sum 17 B, the
    entry t 17 B, its amin and argmin 8 B."""
    return n * k * 261


def shadow_batch(o, d, hit):
    """The main path's any-hit batch for a bounce whose closest hits are
    `hit`: one env shadow ray (a seeded direction on the camera's side,
    t_max unbounded) then one mesh-light shadow ray (to the ceiling light,
    t_max just short of it) per lane, concatenated as path.py does it, so
    2N lanes, dead where the closest-hit ray missed."""
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
            torch.cat([torch.full((n,), INF_T, device=dev),
                       dist * (1 - 1e-4)]),
            (hit.tri >= 0).repeat(2))


def time_kernels(scenes, timings, errs):
    """Each kernel at the largest shape the 1080p main path gives it:
    closest hit on the frame's 2,073,600 camera rays, any hit on their
    4,147,200-lane shadow batch. The kernel alone on the inputs it gets
    (treelet kernels on phase-1 sorted lanes) is timed and held against its
    plain version on the same inputs, whose visit counts also bound it.
    Any hit is held again on the batch's mesh-light half (2,073,600 lanes,
    the shadow batch of a half-width live-prefix bounce)."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet

    from moonshine_tpu_torch.render.renderer import _sample_rays

    h, w = HD
    for tree in ("default", "treelet"):
        scene, lens = scenes[f"room_184k/{tree}"]
        wb = scene.wide
        o, d, _, _ = _sample_rays(lens, h, w, 0, True, scene.device)
        n = o.shape[0]
        batches = {
            "closest_hit": (o, d, torch.full((n,), INF_T, device=o.device),
                            torch.ones(n, dtype=torch.bool, device=o.device),
                            False),
            "any_hit": (*shadow_batch(o, d, packet.closest_hit_packet(
                wb, o, d, INF_T)), True),
        }
        for base, (ro, rd, tm, act, any_hit) in batches.items():
            m = ro.shape[0]
            if tree == "default":
                kname, k32 = base, 0
                fk = packet.any_hit_packet if any_hit else \
                    packet.closest_hit_packet
                fp = packet.any_hit_plain if any_hit else \
                    packet.closest_hit_plain
                lanes = (ro, rd, tm, act)
                kern = lambda: fk(wb, ro, rd, tm, act)
                plain = lambda c=False: fp(wb, ro, rd, tm, act,
                                           count_visits=c)
                unsort = lambda x: x
            else:
                kname = f"treelet_{base}"
                t_eff = torch.where(act, tm, -1e30)
                ms_p1 = cuda_ms(
                    lambda: treelet._pending_masks(wb, ro, rd, t_eff), 3)
                perm, srt = treelet._sort_lanes(wb, ro, rd, t_eff)
                k32 = srt[3].shape[1]
                lanes = (*srt[:3], srt[2] > 0.0)
                kern = lambda a=srt, ah=any_hit: treelet._dispatch_kernel(
                    wb, *a, ah)
                plain = lambda c=False, a=srt, ah=any_hit: \
                    treelet._dispatch_plain(wb, *a, ah, count_visits=c)
                unsort = lambda x, p=perm: torch.empty_like(x).index_copy_(
                    0, p, x)
                fk = treelet.any_hit_treelet if any_hit else \
                    treelet.closest_hit_treelet
                ms_wrap = cuda_ms(lambda: fk(wb, ro, rd, tm, act), 3)
                nb = phase1_bytes(m, wb.t_roots.shape[0])
                say("timings", f"{kname} on {m} rays: whole wrapper "
                    f"(phase 1, sort, kernel, unsort) {ms_wrap:.4f} ms, "
                    f"phase 1 alone {ms_p1:.4f} ms, moving ~{nb / 1e9:.2f} "
                    f"GB (counted from its tensor ops) = "
                    f"{nb / ms_p1 / 1e9:.3f} TB/s")
                if not any_hit:  # the schedule against the packet kernel
                    runs = {"treelet kernel": lambda a=srt: (
                                treelet._dispatch_kernel(wb, *a, False)),
                            "packet kernel, the same sorted lanes":
                                lambda a=lanes: packet.closest_hit_packet(
                                    wb, *a),
                            "packet kernel, camera order": lambda: (
                                packet.closest_hit_packet(wb, ro, rd, tm,
                                                          act))}
                    ms_runs = {k: [] for k in runs}
                    for _ in range(3):  # alternated, so clocks hit all alike
                        for k, fn in runs.items():
                            ms_runs[k].append(cuda_ms(fn, 5))
                    say("timings", "closest hit on the same 8/8 tree, three "
                        "alternated rounds: " + "; ".join(
                            f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                            + " ms" for k, v in ms_runs.items()))
            ms = cuda_ms(kern, 5)
            out_k = kern()
            out_p, visits = plain(True)  # also the plain version's warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if any_hit:
                err = check_any(f"{kname} (timed batch)", out_k, out_p, wb,
                                *lanes)
                half = slice(m // 2, m)
                err = max(err, check_any(
                    f"{kname} (the batch's mesh-light half)",
                    fk(wb, ro[half], rd[half], tm[half], act[half]),
                    unsort(out_p)[half], wb, ro[half], rd[half], tm[half],
                    act[half]))
            else:
                err, _ = check_closest(f"{kname} (timed batch)", out_k,
                                       out_p, lanes[3], m)
            errs[kname] = max(errs[kname], err)
            b_ms, b_by, detail = bound(kname, m, visits, wb, k32)
            timings[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by)
            say("timings", f"{kname} on {m} rays ({tree} tree): kernel "
                f"{ms:.4f} ms, plain torch {plain_ms:.2f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({detail}); no single PyTorch "
                f"call traverses a BVH, so no library time")


def main():
    with phase("device"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "smoke run needs a CUDA device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        say("device", f"torch {torch.__version__} cuda {torch.version.cuda}"
            f" python {sys.version.split()[0]}")
        dev = torch.device("cuda", 0)

    with phase("build"):
        from moonshine_tpu_torch.accel import native, packet, treelet

        for name, lib in native.build_all().items():
            ptxas = [ln.strip() for ln in lib.log.splitlines()
                     if "registers" in ln or "spill" in ln]
            say("build", f"{lib.path.relative_to(ROOT)} in "
                f"{lib.build_seconds:.1f} s; stack capacity "
                f"{lib.stack_capacity}; " + " | ".join(ptxas))

    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import (
        _render_spp_staged,
        _sample_rays,
        render_spp,
    )
    from moonshine_tpu_torch.scene import procedural

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    room = lambda: procedural.room_scene(grid=6, subdivisions=4)
    scenes = {}
    with phase("scenes"):
        for name, make, build_env, mode_env in (
                ("flagship", procedural.flagship_scene, {}, {}),
                ("room_184k/default", room, {}, {}),
                ("room_184k/treelet", room, TREELET_ENV,
                 {"MSN_TREELETS": "1"})):
            t0 = time.perf_counter()
            world, lens = make()
            with env(**build_env):
                scene = world.build(dev)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            wb = scene.wide
            with env(**mode_env):
                mode = path._hbm_mode(wb)
            scenes[name] = (scene, LensArrays.from_lens(lens, dev))
            builder = "sah" if scene.num_tris > 50_000 else "karras"
            say("scenes", f"{name}: {scene.num_tris} triangles, {builder} "
                f"build {t_build:.2f} s, {wb.num_nodes} nodes x {wb.width} "
                f"wide, {wb.num_leaves} leaves x {wb.leaf_slots} slots, rows "
                f"{packet.row_bytes(wb)} B vs budget "
                f"{packet.VMEM_SCENE_BUDGET_BYTES} B, mode {mode}, stack "
                f"bound {wb.max_stack}, K {wb.t_roots.shape[0]}")
        if path._hbm_mode(scenes["room_184k/default"][0].wide) != "hbm":
            raise AssertionError("room_184k is not HBM-class")
        with env(MSN_TREELETS="1"):
            if path._hbm_mode(scenes["room_184k/treelet"][0].wide) != \
                    "treelet":
                raise AssertionError("the treelet build does not dispatch "
                                     "to the treelet kernel")

    errs = {}
    with phase("kernels"):
        for name in ("flagship", "room_184k/default"):
            compare_packet(name, *scenes[name], errs)
        compare_treelet(*scenes["room_184k/treelet"], errs)

    launches = {}
    with phase("flagship"):
        scene, lens = scenes["flagship"]
        spp = 8
        render_spp(scene, lens, 512, 512, 0, spp, cfg)  # warm-up
        torch.cuda.synchronize()
        stats = {}
        packet.reset_launch_counts()
        t0 = time.perf_counter()
        acc, rays = render_spp(scene, lens, 512, 512, spp, spp, cfg,
                               stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(packet.LAUNCHES)
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError("flagship image has non-finite pixels")
        if counts["closest_hit"] != stats["segments"]:
            raise AssertionError(f"closest-hit launches {counts} != "
                                 f"segments run {stats['segments']}")
        say("flagship", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, {dt / spp * 1e3:.2f} ms/spp, "
            f"image mean {img.mean():.6f}, launches {counts}, segments "
            f"{stats['segments']}, resort {stats['resort']}")

    with phase("goldens"):
        w, l = procedural.furnace_scene()
        sc = w.build(dev)
        acc, _ = render_spp(sc, LensArrays.from_lens(l, dev), 64, 64, 0, 8,
                            PathConfig(max_bounces=8, env_samples_per_bounce=0,
                                       mesh_samples_per_bounce=0,
                                       unroll=False))
        err = float((acc / 8 - 1.0).abs().max())
        say("goldens", f"furnace 64x64 x 8 spp: max|img-1| = {err:.3g}")
        if not err < 1e-5:
            raise AssertionError("furnace is not 1 everywhere")
        w, l = procedural.mirror_glass_scene()
        sc = w.build(dev)
        acc, _ = render_spp(sc, LensArrays.from_lens(l, dev), 96, 96, 0, 8,
                            PathConfig(max_bounces=6, env_samples_per_bounce=1,
                                       mesh_samples_per_bounce=0))
        img = (acc / 8).cpu().numpy()
        gold = read_exr(ROOT / "tests" / "goldens" / "mirror_glass.exr")[
            ..., :3]
        pix = (np.abs(img - gold) <= 1e-3 + 1e-3 * np.abs(gold)).all(-1)
        mean_rel = abs(img.mean() / gold.mean() - 1.0)
        say("goldens", f"mirror_glass 96x96 x 8 spp: {pix.mean():.4%} of "
            f"pixels within 1e-3, mean {img.mean():.6f} vs golden "
            f"{gold.mean():.6f} (rel {mean_rel:.3g})")
        if pix.mean() < 0.99 or mean_rel > 1e-3:
            raise AssertionError("mirror_glass drifted from its golden")

    with phase("room_184k"):
        scene, lens = scenes["room_184k/default"]
        spp = 2
        torch.cuda.reset_peak_memory_stats()
        packet.reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        acc, rays = render_spp(scene, lens, 512, 512, 0, spp, cfg,
                               stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        finite = bool(np.isfinite(img).all())
        say("room_184k", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, image "
            f"mean {img.mean():.6f}, finite {finite}, path {stats['path']}, "
            f"resort {stats['resort']}, launches {dict(packet.LAUNCHES)}")
        if not finite or min(packet.LAUNCHES.values()) == 0:
            raise AssertionError("room_184k render failed")

    # the main path: each 1080p configuration's counts are set to 0 just
    # before its timed run and read just after
    with phase("room_1080p"):
        img_default, stats, counts = render_1080p(
            "room_1080p", *scenes["room_184k/default"], cfg, resort=True)
        if (counts["closest_hit"] != stats["segments"]
                or counts["any_hit"] == 0
                or counts["treelet_closest_hit"]
                or counts["treelet_any_hit"]):
            raise AssertionError(f"room_1080p launches {counts}, segments "
                                 f"{stats['segments']}")
        launches.update(closest_hit=counts["closest_hit"],
                        any_hit=counts["any_hit"])

    with phase("treelet_1080p"):
        with env(MSN_TREELETS="1"):
            img_treelet, stats, counts = render_1080p(
                "treelet_1080p", *scenes["room_184k/treelet"], cfg,
                resort=False)
        if (counts["treelet_closest_hit"] != stats["segments"]
                or counts["treelet_any_hit"] == 0
                or counts["closest_hit"] or counts["any_hit"]):
            raise AssertionError(f"treelet_1080p launches {counts}, "
                                 f"segments {stats['segments']}")
        launches.update(treelet_closest_hit=counts["treelet_closest_hit"],
                        treelet_any_hit=counts["treelet_any_hit"])
        pix = (np.abs(img_treelet - img_default)
               <= 1e-3 + 1e-3 * np.abs(img_default)).all(-1)
        mean_rel = abs(img_treelet.mean() / img_default.mean() - 1.0)
        say("treelet_1080p", f"against room_1080p: {pix.mean():.4%} of "
            f"pixels within 1e-3, means rel {mean_rel:.3g}")
        if pix.mean() < 0.99 or mean_rel > 1e-3:
            raise AssertionError("treelet_1080p disagrees with room_1080p")

    with phase("staged_vs_fused"):
        scene, lens = scenes["room_184k/default"]
        fused, _ = render_spp(scene, lens, 512, 512, 0, 1, cfg)
        staged, _ = _render_spp_staged(scene, lens, 512, 512, 0, 1, cfg)
        rel = float(((staged - fused).abs()
                     / fused.abs().clamp_min(1e-30)).max())
        say("staged_vs_fused", f"room_184k 512x512 x 1 spp: bit-equal "
            f"{bool(torch.equal(staged, fused))}, max rel diff {rel:.3g}")
        if rel > 1e-6:
            raise AssertionError("staged and fused paths disagree")

    timings = {}
    with phase("timings"):
        time_kernels(scenes, timings, errs)

    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         **timings[k], "library_ms": None}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
