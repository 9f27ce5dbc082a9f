"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, PATH or /usr/local/cuda). Each
phase prints one line; a failing phase raises and the script exits
non-zero without the result line. Phases:

  1 device     the card's name and power limit (nvidia-smi)
  2 build      nvcc builds csrc/traverse.cu into build/
  3 kernels    each traversal kernel against its plain torch version on
               the flagship and room_184k scenes (camera rays plus a
               seeded synthetic bounce batch with dead lanes)
  4 flagship   render_spp of the 964-triangle flagship, 512x512, 8 spp,
               after a warm-up run; Mrays/s from one run's rays and time;
               kernel launch counts; kernel vs plain traversal times
  5 goldens    furnace (every pixel 1) and mirror_glass against the
               committed golden image
  6 room_184k  render_spp of the ~184k-triangle room, 512x512, 2 spp

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
INF_T = 1.0e12
REPLACES = {
    "closest_hit": "moonshine_tpu/accel/packet.py:825",
    "any_hit": "moonshine_tpu/accel/packet.py:860",
}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise


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


def compare_kernels(name, scene, lens, stats):
    """Kernel vs plain on camera rays + a synthetic bounce batch; raises
    unless they agree within the bar; folds errors into `stats`."""
    import torch

    from moonshine_tpu_torch.accel import packet
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

    hk = packet.closest_hit_packet(scene.wide, o, d, INF_T, active_in=active)
    hp = packet.closest_hit_plain(scene.wide, o, d, INF_T, active_in=active)
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
    say("kernels", f"{name} closest_hit: {n} rays, {int(hit_p.sum())} hits, "
        f"is_hit mismatches {len(miss_dif)} (grazing {int(graze_ok.sum())}), "
        f"tri ties {len(tri_dif)}, max|dt| {t_err:.3g}, max|duv| "
        f"{uv_err:.3g}")
    if not ok:
        raise AssertionError(f"{name}: closest-hit kernel disagrees with "
                             "its plain version")

    ok_k = packet.any_hit_packet(scene.wide, o, d, t_fin, active_in=active)
    ok_p = packet.any_hit_plain(scene.wide, o, d, t_fin, active_in=active)
    ok_k, ok_p = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    occ_dif = np.nonzero(ok_k != ok_p)[0]
    # a flip is allowed only on an edge graze or a hit right at t_max
    tf = t_fin.cpu().numpy()
    at_tmax = np.abs(hp.t[occ_dif] - tf[occ_dif]) <= 1e-5 * tf[occ_dif]
    occ_graze = grazing(hp, occ_dif) | at_tmax
    say("kernels", f"{name} any_hit: {n} rays (finite t_max), "
        f"{int(ok_p.sum())} occluded, mismatches {len(occ_dif)} "
        f"(grazing {int(occ_graze.sum())})")
    if len(occ_dif) > 1e-5 * n or not occ_graze.all():
        raise AssertionError(f"{name}: any-hit kernel disagrees with its "
                             "plain version")
    stats["closest_hit"] = max(stats.get("closest_hit", 0.0), t_err)
    stats["any_hit"] = max(stats.get("any_hit", 0.0),
                           float(len(occ_dif) > 0))


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
        from moonshine_tpu_torch.accel import native, packet

        lib = native.traverse_lib()
        ptxas = [ln for ln in lib.log.splitlines() if "registers" in ln
                 or "spill" in ln]
        say("build", f"{lib.path.relative_to(ROOT)} in "
            f"{lib.build_seconds:.1f} s; stack capacity "
            f"{lib.stack_capacity}; " + " | ".join(ptxas))

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import _sample_rays, render_spp
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scene.world import scene_from_arrays

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    scenes = {}
    with phase("scenes"):
        for name, make in (("flagship", procedural.flagship_scene),
                           ("room_184k", lambda: procedural.room_scene(
                               grid=6, subdivisions=4))):
            t0 = time.perf_counter()
            world, lens = make()
            arrays = world.build_arrays()
            t_host = time.perf_counter() - t0
            scene = scene_from_arrays(*arrays, dev)
            torch.cuda.synchronize()
            scenes[name] = (scene, LensArrays.from_lens(lens, dev))
            say("scenes", f"{name}: {scene.num_tris} triangles, host build "
                f"{t_host:.2f} s, {scene.wide.num_nodes} nodes x "
                f"{scene.wide.width} wide, {scene.wide.num_leaves} leaves x "
                f"{scene.wide.leaf_slots} slots, stack bound "
                f"{scene.wide.max_stack}")

    errs = {}
    with phase("kernels"):
        for name, (scene, lens) in scenes.items():
            compare_kernels(name, scene, lens, errs)

    timings = {}
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
        launches = dict(packet.LAUNCHES)
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError("flagship image has non-finite pixels")
        if launches["closest_hit"] != stats["segments"]:
            raise AssertionError(f"closest-hit launches {launches} != "
                                 f"segments run {stats['segments']}")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        say("flagship", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, {dt / spp * 1e3:.2f} ms/spp, "
            f"image mean {img.mean():.6f}, launches {launches}, segments "
            f"{stats['segments']}")

        o, d, _, _ = _sample_rays(lens, 512, 512, 0, True, dev)
        w = scene.wide
        hit = packet.closest_hit_packet(w, o, d, INF_T)
        light = torch.tensor([0.0, 0.0, 4.0], device=dev)  # light centre
        p = o + hit.t[:, None].clamp_max(1e6) * d - 1e-4 * d
        to_l = light - p
        dist = torch.linalg.norm(to_l, dim=1)
        sd = to_l / dist[:, None]
        s_t = dist * (1 - 1e-4)
        s_act = hit.tri >= 0
        timings["closest_hit"] = (
            cuda_ms(lambda: packet.closest_hit_packet(w, o, d, INF_T), 20),
            cuda_ms(lambda: packet.closest_hit_plain(w, o, d, INF_T), 2))
        timings["any_hit"] = (
            cuda_ms(lambda: packet.any_hit_packet(w, p, sd, s_t, s_act), 20),
            cuda_ms(lambda: packet.any_hit_plain(w, p, sd, s_t, s_act), 2))
        for k, (ms, plain) in timings.items():
            say("flagship", f"{k} on {o.shape[0]} first-bounce rays: kernel "
                f"{ms:.4f} ms, plain torch {plain:.4f} ms")

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
        scene, lens = scenes["room_184k"]
        spp = 2
        torch.cuda.reset_peak_memory_stats()
        packet.reset_launch_counts()
        t0 = time.perf_counter()
        acc, rays = render_spp(scene, lens, 512, 512, 0, spp, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        finite = bool(np.isfinite(img).all())
        say("room_184k", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, image "
            f"mean {img.mean():.6f}, finite {finite}, launches "
            f"{dict(packet.LAUNCHES)}")
        if not finite or min(packet.LAUNCHES.values()) == 0:
            raise AssertionError("room_184k render failed")

    kernels = [
        {"name": k, "route": "cuda",
         "source": "moonshine_tpu_torch/csrc/traverse.cu",
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timings[k][0],
         "plain_ms": timings[k][1]}
        for k in ("closest_hit", "any_hit")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
