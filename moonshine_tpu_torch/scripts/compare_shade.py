"""The shading kernels (csrc/shade.cu) on a 1080p sample's inputs, against
their plain versions and, optionally, another checkout's kernels:

    python -m moonshine_tpu_torch.scripts.compare_shade [--rounds N]
        [--against DIR ...] [--kernels surface,scatter,env_miss]

One eager sample of room_1080p (room_scene(grid=6, subdivisions=4) at
1920x1080, one env and one mesh-light sample a bounce) and of
instanced_1080p (`procedural.instanced_scene()`, built two-level by the
flatten cap) is recorded (`recording`): each shading wrapper's first call
with its inputs. The full surface form (the decode with the bounce's light
draw) and the scatter are replayed through this checkout's kernel and
plain version, the outputs held bit for bit on the lanes the kernel writes
(`held`), and timed with their in-place inputs restored before every
launch (`time_inplace`). Each `--against DIR` is an earlier checkout
(`git archive` of a commit, in a gitignored directory) whose shade.cu
takes the earlier signatures (surface writing every output of every lane
without the draw; scatter reading each light sample through a pointer
array): it is built beside this one and timed on the same inputs in
alternated rounds, its decode held bit for bit against this checkout's on
the live lanes and its scatter against the plain version. The env miss
runs at live shares of 100%, 10% and 1% of its recorded launch's lanes
(`thinned`), held bit for bit against its plain version on every lane
(radiance and mask), beside its bound (`miss_bound`), and so does its
launch at segment OFFLINE_SEGMENT of one offline_720p sample
(compare_sort.offline_cell: every lane launched, few live); an earlier
checkout's miss is the one that reads every lane and writes every
lane's radiance into a fresh tensor (its radiance held to the plain
version's). `--kernels` picks which of the three run (an earlier
checkout whose surface and scatter already take this one's signatures
runs with env_miss alone). Prints one line per measurement, then one
JSON line; exits 1 if an output differs.

`recording`, `held`, `clone` and `time_inplace` serve chip_smoke.py's
`shade` phase too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys

from moonshine_tpu_torch.accel import native
from moonshine_tpu_torch.scripts.compare_sort import offline_cell

HD = (1080, 1920)
REPS = 10
# written before each timed launch to evict what a restore left in the
# card's L2 (50 MB on an H100)
L2_FLUSH_BYTES = 256 << 20
NAMES = ("surface", "scatter", "env_miss", "env_draw")
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
PEAK_FP32 = 67e12  # H100 SXM float32 outside the tensor cores
# float operations of a lane that missed, counted from csrc/shade.cu's
# source, by env size > 1 and == 1; and the MIS weight's where env
# samples are drawn
MISS_OPS, MISS_MIS_OPS = (63, 6), (20, 17)
SHARES = (1.0, 0.1, 0.01)  # the env miss's live shares (`thinned`)
# the offline_720p segment whose env miss is timed as recorded (mostly
# dead: the resort is off past 600k lanes, so every lane is launched)
OFFLINE_SEGMENT = 30


def clone(x):
    """A deep copy of x's tensors (through tuples, NamedTuples, lists and
    dicts; anything else as it is)."""
    import torch

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(clone, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(clone, x))
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x


def tensors(x):
    """x's tensors, in the order `clone` meets them."""
    import torch

    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from tensors(y)


def fresh(name, args) -> tuple:
    """A copy of a shading call's arguments to run it on: every tensor
    cloned but the scene's or env map's (the first argument of the
    surface and env wrappers), which no kernel writes."""
    keep = 0 if name == "scatter" else 1
    return tuple(args[:keep]) + clone(tuple(args[keep:]))


def key_of(name, args) -> str:
    """A recorded call's key: the wrapper's name, with the surface's form."""
    if name != "surface":
        return name
    return f"surface/{args[11] if len(args) > 11 else 'full'}"


@contextlib.contextmanager
def recording(nth: int = 0):
    """The `nth` call (0: the first) of each shading wrapper
    (integrator/shade.py) inside the block, its arguments cloned before
    the call (the kernels and the loop's static buffers change them in
    place), on the eager loop, where the wrappers are called. Yields
    {key: (name, args, kwargs)}; the scene (the surface's first
    argument) and env maps are the caller's."""
    from moonshine_tpu_torch.integrator import graphs, shade

    rec, calls = {}, {}
    real = {k: getattr(shade, k) for k in NAMES}

    def wrap(name):
        def call(*args, **kw):
            key = key_of(name, args)
            calls[key] = calls.get(key, -1) + 1
            if calls[key] == nth:
                rec[key] = (name, fresh(name, args), clone(kw))
            return real[name](*args, **kw)
        return call

    for k in NAMES:
        setattr(shade, k, wrap(k))
    try:
        with graphs.eager():
            yield rec
    finally:
        for k in NAMES:
            setattr(shade, k, real[k])


def outputs(out) -> dict:
    """A shading function's result as {name: tensor}."""
    import torch

    if torch.is_tensor(out):
        return {"radiance": out}
    if isinstance(out, dict):
        return dict(out)
    if hasattr(out, "frame"):  # a Surface
        got = {k: getattr(out, k) for k in ("position", "tri_n", "w_o_ss",
                                            "radiance", "active",
                                            "throughput", "rng")}
        if out.frame is not None:
            got.update({f"frame.{k}": getattr(out.frame, k)
                        for k in ("n", "s", "t")})
            got.update({f"mat.{k}": getattr(out.mat, k)
                        for k in out.mat._fields})
        if out.lights is not None:
            got.update({f"lights.{k}": getattr(out.lights, k)
                        for k in ("dir", "radiance", "pdf", "lane")})
            got.update({f"shadow.{k}": getattr(out.shadow, k)
                        for k in out.shadow._fields})
        return {k: v for k, v in got.items() if v is not None}
    if len(out) == 2:  # the env miss
        return dict(zip(("radiance", "active"), out))
    return dict(zip(("dir", "radiance", "pdf"), out))


def held(key, args, want) -> dict:
    """{output: the lanes on which the kernel writes it, None for all} of
    a recorded call: the surface's decoded hit on the lanes active at the
    hit (the direct form: all), its PCG state on the lanes live after the
    roulette, a light sample and shadow ray where the ray is traced; the
    scatter's last_pdf, last_delta and rng on the lanes live on entry.
    The radiance is written on these lanes too and kept elsewhere, so it
    is held as a value on every lane (a masked add leaves no +0)."""
    names = outputs(want)
    if key in ("surface/full", "surface/thin"):
        at_hit = args[6]
        lanes = {k: at_hit for k in names}
        lanes.update(active=None, throughput=None)
        if "rng" in names:
            lanes["rng"] = want.active
        if "shadow.lane" in names:
            lanes.update({k: want.lights.lane for k in names
                          if k.startswith("lights.")})
            lanes.update({k: want.shadow.lane for k in names
                          if k.startswith("shadow.")})
            lanes["shadow.lane"] = lanes["lights.lane"] = None
        return lanes
    if key == "scatter":
        live = args[6]
        return {k: (live if k in ("last_pdf", "last_delta", "rng", "radiance")
                    else None) for k in names}
    return {k: None for k in names}


def compare(key, args, got, want):
    """([differences], worst absolute error) of the kernel's outputs `got`
    against the plain version's `want` on the lanes `held` names, bit for
    bit (floats as int32 words, every NaN alike)."""
    import torch

    got, lanes = outputs(got), held(key, args, want)
    diffs, worst = [], 0.0
    for k, w in outputs(want).items():
        g = got[k]
        if k == "radiance":  # a value everywhere
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            if not bool(same.all()):
                diffs.append(f"radiance: {int((~same).sum())} values differ")
        mask = lanes.get(k)
        if mask is not None:
            g, w = g[mask], w[mask]
        w = w.contiguous()
        if g.dtype == torch.float32:
            same = (torch.isnan(g) & torch.isnan(w)) | (
                g.view(torch.int32) == w.view(torch.int32))
            err = float(torch.nan_to_num((g.double() - w.double()).abs(),
                                         nan=0.0).max()) if g.numel() else 0.0
        else:
            same = g == w
            err = float((g != w).sum())
        worst = max(worst, err)
        bad = int((~same).sum())
        if bad:
            diffs.append(f"{k}: {bad} of {same.numel()} differ, max abs "
                         f"{err:.3g}")
    return diffs, worst


def call(fn, args, kw):
    return lambda: fn(*args, **kw)


def env_taps(env, d):
    """The env texels the miss reads at directions d: the bilinear's four
    taps and miss_radiance_and_pdf's texel (lights/envmap.py)."""
    import torch

    from moonshine_tpu_torch.core.mappings import (
        square_to_equal_area_sphere_inverse)

    S = env.size
    uv = square_to_equal_area_sphere_inverse(d)
    idx = torch.clamp((uv * S).to(torch.int64), 0, S - 1)
    xi0 = torch.clamp(torch.floor(uv[:, 0] * S - 0.5).to(torch.int64),
                      0, S - 1)
    yi0 = torch.clamp(torch.floor(uv[:, 1] * S - 0.5).to(torch.int64),
                      0, S - 1)
    xi1, yi1 = torch.clamp(xi0 + 1, 0, S - 1), torch.clamp(yi0 + 1, 0, S - 1)
    return torch.cat([idx[:, 0] * S + idx[:, 1], xi0 * S + yi0,
                      xi1 * S + yi0, xi0 * S + yi1, xi1 * S + yi1])


def miss_work(args):
    """(bytes, float operations) the env miss must move and do for a
    call's arguments: every lane its mask, a live lane its tri; a lane
    that missed its d, throughput, last_delta (last_pdf where env samples
    are drawn) and radiance read, its radiance and mask written; each
    distinct env texel those lanes reach (16 bytes); MISS_OPS on them."""
    import torch

    env, samples, _, d, active, tri = args[:6]
    miss = active & ~(tri >= 0)
    n, n_miss = active.shape[0], int(miss.sum())
    nb = n + int(active.sum()) * 4
    nb += n_miss * (12 + 12 + 1 + 24 + 1 + (4 if samples > 0 else 0))
    k = 0 if env.size > 1 else 1
    flops = n_miss * (MISS_OPS[k] + (MISS_MIS_OPS[k] if samples > 0 else 0))
    if env.size == 1:
        nb += 16 if n_miss else 0
    else:
        nb += int(torch.unique(env_taps(env, d[miss])).numel()) * 16
    return nb, flops


def miss_bound(args) -> tuple:
    """(ms, "bytes" or "operations", detail): the env miss's least time
    on this card's published rates (miss_work)."""
    nb, flops = miss_work(args)
    t_bytes, t_ops = nb / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, (f"{nb / 1e6:.3f} MB -> {t_bytes:.5f} "
                                     f"ms, {flops / 1e6:.2f} MFLOP -> "
                                     f"{t_ops:.5f} ms")


def thinned(args, share: float, seed: int = 7):
    """A recorded env miss's arguments with its mask cut to a seeded
    `share` of its live lanes (the deep segments' launches)."""
    import numpy as np
    import torch

    active = args[4]
    draw = torch.from_numpy(np.random.RandomState(seed).rand(
        active.shape[0])).to(active.device)
    return args[:4] + (active & (draw < share),) + args[5:]


def time_inplace(fn, work, pristine, reps: int) -> float:
    """Mean device time in ms of fn over `reps` launches, each timed by
    CUDA events after `work`'s tensors were restored from `pristine`'s
    (the kernels update their inputs in place; the copies stay outside
    the events) and a 256 MiB buffer was written, so that no input is
    read from the L2 the restore filled. Then a spin kernel holds the
    stream for
    twice the host time of a call, so that the events time the kernel,
    not the host's launch behind them (as scripts.cuda_ms does)."""
    import time

    import torch

    from moonshine_tpu_torch import scripts

    pairs = [(w, p) for w, p in zip(tensors(work), tensors(pristine))
             if w is not p]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for w, p in pairs:
        w.copy_(p)
    t0 = time.perf_counter()
    fn()  # warm-up
    hold = int(min(2 * (time.perf_counter() - t0), scripts._HOLD_MAX_S)
               * scripts._HOLD_HZ)
    for start, end in events:
        for w, p in pairs:
            w.copy_(p)
        flush.zero_()
        torch.cuda._sleep(hold)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


# ---- an earlier checkout's kernels, with their own signatures

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
EARLIER = {  # entry point: its argument types in the earlier shade.cu
    "msn_shade_surface": [_I, _I, _P, _L, _P, _P, _L, _P, _L, _L, _P, _L,
                          _L, _I, _I, _I, _I, _F] + [_P] * 12 + [_L]
    + [_P] * 14,
    "msn_shade_scatter": [_P] * 17 + [_I, _P, _P, _I, _L] + [_P] * 9,
    "msn_shade_env_miss": [_P, _I, _F, _I] + [_P] * 8 + [_L, _P, _P],
}


def earlier_surface(lib, args):
    """A call of the earlier surface kernel (the full form, every output
    of every lane, no draw) on the recorded full form's inputs; returns
    its outputs as a Surface-like dict."""
    import torch

    from moonshine_tpu_torch.integrator import shade

    (scene, mesh_samples, bounce, hit, o, d, active, thr, rad, last_pdf,
     last_delta) = args[:11]
    fn = lib._fn("msn_shade_surface", EARLIER["msn_shade_surface"])
    n, dev, f32 = d.shape[0], d.device, torch.float32
    two = hit.inst is not None and scene.tlas is not None
    atlas = scene.mat_atlas
    bounce = shade._bounce_on(bounce, dev)

    def run():
        vec = lambda: torch.empty((n, 3), dtype=f32, device=dev)
        lane = lambda dt=f32: torch.empty(n, dtype=dt, device=dev)
        outs = [vec() for _ in range(6)] + [lane(torch.int32), vec(), lane(),
                                            lane(), lane(), vec()]
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = native_call(fn, dev, 0, int(two), ptr(scene.tri_shade),
                         scene.num_tris,
                         ptr(scene.inst_tf if two else None),
                         ptr(scene.tlas.inst_inv if two else None),
                         scene.inst_tf.shape[0] if two else 0,
                         ptr(atlas.bsdf.data), atlas.bsdf.width,
                         atlas.bsdf.data.shape[0], ptr(atlas.emissive.data),
                         atlas.emissive.width, atlas.emissive.data.shape[0],
                         int(atlas.bsdf_constant),
                         int(atlas.emissive_constant),
                         int(atlas.normals_flat), mesh_samples,
                         shade._reciprocal(scene.emitters.weight_sum, 1e-20),
                         ptr(hit.tri), ptr(hit.u), ptr(hit.v),
                         ptr(hit.inst if two else None), ptr(o), ptr(d),
                         ptr(active), ptr(thr), ptr(rad), ptr(last_pdf),
                         ptr(last_delta), ptr(bounce), n,
                         *(x.data_ptr() for x in outs), None)
        if rc != 0:
            raise RuntimeError(f"earlier surface launch failed: {rc}")
        names = ("position", "tri_n", "frame.n", "frame.s", "frame.t",
                 "w_o_ss", "mat.type", "mat.color", "mat.metalness",
                 "mat.alpha", "mat.ior", "radiance")
        return dict(zip(names, outs))

    return run


def earlier_scatter(lib, args):
    """A call of the earlier scatter kernel (fresh outputs, each light
    sample through a pointer array) on the recorded scatter's inputs."""
    import torch

    surf, o, d, thr, rad, rng, active, lights = args[:8]
    fn = lib._fn("msn_shade_scatter", EARLIER["msn_shade_scatter"])
    n, dev = d.shape[0], d.device
    s = 0 if lights is None else lights.pdf.shape[0]
    ptrs = []
    for k in range(s):
        ptrs += [lights.dir[k].data_ptr(), lights.radiance[k].data_ptr(),
                 lights.pdf[k].data_ptr(), lights.lane[k].data_ptr(),
                 lights.occluded[k].data_ptr()]
    c_ptrs = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    c_counts = (ctypes.c_int * max(s, 1))(*(lights.n_samples(k)
                                            for k in range(s)))
    mat, frame = surf.mat, surf.frame

    def run():
        out = dict(active=torch.empty(n, dtype=torch.bool, device=dev),
                   o=torch.empty_like(o), d=torch.empty_like(d),
                   throughput=torch.empty_like(thr),
                   radiance=torch.empty_like(rad),
                   last_pdf=torch.empty(n, device=dev),
                   last_delta=torch.empty(n, dtype=torch.bool, device=dev),
                   rng=torch.empty_like(rng))
        rc = native_call(fn, dev, *(x.data_ptr() for x in (
            mat.type, mat.color, mat.metalness, mat.alpha, mat.ior,
            frame.n, frame.s, frame.t, surf.w_o_ss, surf.position,
            surf.tri_n, o, d, thr, rad, rng, active)), s, c_ptrs, c_counts,
            1, n, *(x.data_ptr() for x in out.values()))
        if rc != 0:
            raise RuntimeError(f"earlier scatter launch failed: {rc}")
        return out

    return run


def earlier_env_miss(lib, args):
    """A call of the earlier env miss kernel (every lane read and its
    radiance written into a fresh tensor, the mask left to torch) on a
    recorded miss's inputs; returns {"radiance": its output}."""
    import torch

    from moonshine_tpu_torch.integrator import shade

    env, samples, bounce, d, active, tri, thr, rad, last_pdf, last_delta = \
        args[:10]
    fn = lib._fn("msn_shade_env_miss", EARLIER["msn_shade_env_miss"])
    keep = []
    rgbl, size, inv_integral = shade._env_args(keep, env)
    bounce = shade._bounce_on(bounce, d.device)

    def run():
        out = torch.empty_like(rad)
        rc = native_call(fn, d.device, rgbl, size, inv_integral, samples,
                         *(x.data_ptr() for x in (d, active, tri, thr, rad,
                                                  last_pdf, last_delta,
                                                  bounce)),
                         d.shape[0], out.data_ptr())
        if rc != 0:
            raise RuntimeError(f"earlier env miss launch failed: {rc}")
        return {"radiance": out}

    return run


def time_miss(label, rargs, against, rounds, bad, result) -> None:
    """The env miss on a recorded call's arguments: this checkout's kernel
    held to its plain version (radiance and mask on every lane) and each
    earlier checkout's radiance to the plain version's, all timed in
    alternated rounds (cold L2), beside its bound; one line, and the
    numbers into result["cells"][label]."""
    import torch

    from moonshine_tpu_torch.integrator import shade

    work = fresh("env_miss", rargs)
    got = shade.env_miss(*fresh("env_miss", rargs))
    want = shade.env_miss_plain(*rargs)
    diffs, _ = compare("env_miss", rargs, got, want)
    runs = {"this": (call(shade.env_miss, work, {}), work)}
    for name, lib in against.items():
        early = earlier_env_miss(lib, rargs)
        if not torch.equal(early()["radiance"], want[0]):
            diffs.append(f"{name} radiance")
        runs[name] = (early, None)
    ms = {name: [] for name in runs}
    for _ in range(rounds):
        for name, (fn, w) in runs.items():
            ms[name].append(time_inplace(fn, w, rargs, REPS) if w is not None
                            else time_inplace(fn, [], [], REPS))
    bound, by, detail = miss_bound(rargs)
    n, live = rargs[4].shape[0], int(rargs[4].sum())
    miss = int((rargs[4] & (rargs[5] < 0)).sum())
    print(f"{label} on {n} lanes, {live} live, {miss} missed: " + ", ".join(
        f"{name} {min(x):.4f} ms (rounds {', '.join(f'{y:.4f}' for y in x)})"
        for name, x in ms.items())
        + f"; bound {bound:.5f} ms by {by} ({detail})"
        + ("; outputs held bit for bit" if not diffs else
           "; DIFFER: " + "; ".join(diffs)), flush=True)
    if diffs:
        bad.append(f"{label}: " + "; ".join(diffs))
    result["cells"][f"{label} {live} live"] = {
        "ms": ms, "n": n, "live": live, "missed": miss, "bound_ms": bound}


def native_call(fn, dev, *args):
    from moonshine_tpu_torch.accel.launch import call_on

    return call_on(fn, dev, *args)


def cells(dev):
    """{name: (scene, LensArrays, PathConfig)}: room_1080p and
    instanced_1080p."""
    import warnings

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    out = {}
    for name, make in (("room_1080p", lambda: procedural.room_scene(
            grid=6, subdivisions=4)), ("instanced_1080p",
                                       procedural.instanced_scene)):
        world, lens = make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scene = world.build(dev)
        out[name] = (scene, LensArrays.from_lens(lens, dev), cfg)
    return out


def record_sample(scene, lens, cfg, sample: int = 7):
    """The recorded shading calls of one eager 1080p sample."""
    import torch

    from moonshine_tpu_torch.render.renderer import render_spp

    with recording() as rec:
        render_spp(scene, lens, HD[0], HD[1], sample, 1, cfg)
    torch.cuda.synchronize()
    return rec


def main(argv=None) -> int:
    import torch

    from moonshine_tpu_torch.integrator import shade

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", action="append", default=[],
                    help="an earlier checkout whose shade.cu runs beside")
    ap.add_argument("--kernels", default="surface,scatter,env_miss",
                    help="which of surface, scatter and env_miss to run")
    args = ap.parse_args(argv)
    kinds = set(args.kernels.split(","))
    if not kinds <= {"surface", "scatter", "env_miss"}:
        raise ValueError(f"--kernels takes surface, scatter, env_miss: "
                         f"{args.kernels}")
    if not torch.cuda.is_available():
        raise RuntimeError("compare_shade needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    against = native.build_against(args.against, ("shade",))()["shade"]
    own = native.shade_lib()
    for label, lib in {"this": own, **against}.items():
        print(f"{label}: {lib.path.name}, built in {lib.build_seconds:.1f} s;"
              f" ptxas: {native.ptxas_summary(lib.log)}", flush=True)
    dev = torch.device("cuda", 0)
    bad, result = [], {"card": smi, "cells": {}}
    plain = {"surface": shade.surface_plain, "scatter": shade.scatter_plain}
    for cell, (scene, lens, cfg) in cells(dev).items():
        rec = record_sample(scene, lens, cfg)
        result["cells"][cell] = {}
        for key in ("surface/full", "scatter"):
            if key.split("/")[0] not in kinds:
                continue
            name, rargs, kw = rec[key]
            work = fresh(name, rargs)
            got = getattr(shade, name)(*fresh(name, rargs), **clone(kw))
            want = plain[name](*rargs, **kw)
            diffs, _ = compare(key, rargs, got, want)
            runs = {"this": (call(getattr(shade, name), work, clone(kw)),
                             work)}
            for label, lib in against.items():
                early = (earlier_surface if name == "surface"
                         else earlier_scatter)(lib, rargs)
                e_out = early()
                if name == "surface":  # the decode, on the live lanes
                    mine = outputs(got)
                    live = rargs[6]
                    for k, v in e_out.items():
                        if k != "radiance" and not torch.equal(
                                v[live], mine[k][live]):
                            diffs.append(f"{label} {k}")
                else:
                    for k, v in e_out.items():
                        w = want[k]
                        if not torch.equal(v, w) and k not in (
                                "last_pdf", "rng", "last_delta"):
                            diffs.append(f"{label} {k}")
                runs[label] = (early, None)
            if diffs:
                bad.append(f"{cell} {key}: " + "; ".join(diffs))
            ms = {label: [] for label in runs}
            for _ in range(args.rounds):
                for label, (fn, w) in runs.items():
                    ms[label].append(time_inplace(fn, w, rargs, REPS)
                                     if w is not None else
                                     time_inplace(fn, [], [], REPS))
            n = rargs[1].shape[0] if name == "scatter" else rargs[5].shape[0]
            print(f"{cell} {key} on {n} lanes: " + ", ".join(
                f"{label} {min(x):.4f} ms (rounds "
                f"{', '.join(f'{y:.4f}' for y in x)})"
                for label, x in ms.items())
                + ("; outputs held bit for bit" if not diffs else
                   "; DIFFER: " + "; ".join(diffs)), flush=True)
            result["cells"][cell][key] = {"ms": ms, "n": n}
        # the env miss at its live shares, beside its bound
        if "env_miss" in kinds:
            for share in SHARES:
                time_miss(f"{cell} env_miss", thinned(rec["env_miss"][1],
                                                      share),
                          against, args.rounds, bad, result)
    if "env_miss" in kinds:  # a mostly dead segment of the looped form
        with recording(OFFLINE_SEGMENT) as rec:
            offline_cell(dev)(0)
        if "env_miss" not in rec:
            raise AssertionError(f"offline_720p's sample ran fewer than "
                                 f"{OFFLINE_SEGMENT + 1} segments")
        time_miss(f"offline_720p env_miss (segment {OFFLINE_SEGMENT})",
                  rec["env_miss"][1], against, args.rounds, bad, result)
    result["mismatch"] = bad
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
