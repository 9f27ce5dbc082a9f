"""The two-level walk (csrc/tlas.cu) against another checkout's, on the
same rays, on the card:

    python -m moonshine_tpu_torch.scripts.compare_tlas [--rounds N]
        [--against DIR ...]

On instanced_1080p (`procedural.instanced_scene()`: 4096 instances of
icosphere(6), built two-level by the flatten cap), at the frame's two
largest launches (`batches`): its 2,073,600 camera rays (closest hit)
and their 4,147,200-lane shadow batch (any hit). Without `--against` it
times this checkout's kernel alone. Each `--against DIR` is another
checkout (an earlier commit unpacked by `git archive`, or a variant of
this one, in a gitignored directory): its csrc/tlas.cu is built beside
this one (unless it and the headers beside it equal this checkout's) and
runs on the same rays, its outputs held bit for bit against this
checkout's kernel. A tlas.cu whose entry points take the reference's 15
TLAS arrays (`TlasLib.records` False) is the earlier one-thread-a-ray
kernel, launched with that signature. Kernel times come from alternated
rounds of scripts.cuda_ms; the new walk's visits a ray from its counting
build. Prints one line per measurement, then one JSON line; exits 1 if
an output differs or a launch is refused.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings

import numpy as np

from moonshine_tpu_torch.accel import native

HD = (1080, 1920)
INF_T = 1.0e12
REPS = 10


def instanced_1080p(dev):
    """(scene, LensArrays, build warnings) of instanced_1080p."""
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.instanced_scene()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scene = world.build(dev)
    return scene, LensArrays.from_lens(lens, dev), [
        str(w.message) for w in caught]


def batches(scene, la, dev):
    """The frame's two largest launches: {name: (ray_o, ray_d, t_max,
    active, any_hit)}. The camera rays (1920x1080, sample 0, the first
    launch of a sample) and the first bounce's shadow batch: an env ray
    (a seeded direction on the camera's side) and a ray to the lamp's
    centre per lane, dead where the camera ray missed."""
    import torch

    from moonshine_tpu_torch.accel import tlas
    from moonshine_tpu_torch.render.renderer import _sample_rays

    h, w = HD
    o, d, _, _ = _sample_rays(la, h, w, 0, True, dev)
    n = o.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    hit = tlas.closest_hit_tlas(scene.tlas, o, d, INF_T, active_in=ones)
    p = o + hit.t[:, None].clamp_max(1e6) * d - 1e-4 * d
    to_l = torch.tensor([0.0, 0.0, 20.0], device=dev) - p
    dist = torch.linalg.norm(to_l, dim=1)
    env_d = torch.from_numpy(np.random.RandomState(11).randn(n, 3).astype(
        np.float32)).to(dev)
    env_d = env_d / torch.linalg.norm(env_d, dim=1, keepdim=True)
    env_d = torch.where((env_d * d).sum(1, keepdim=True) > 0, -env_d, env_d)
    return {
        "tlas_closest_hit": (o, d, torch.full((n,), INF_T, device=dev), ones,
                             False),
        "tlas_any_hit": (torch.cat([p, p]),
                         torch.cat([env_d, to_l / dist[:, None]]),
                         torch.cat([torch.full((n,), INF_T, device=dev),
                                    dist * (1 - 1e-4)]),
                         hit.is_hit.repeat(2), True),
    }


def launcher(lib, t, ro, rd, tm, act, any_hit):
    """A call of `lib`'s kernel on these rays (its own signature)."""
    import torch

    from moonshine_tpu_torch.accel import packet, tlas

    if lib.records:
        return lambda: tlas._launch(t, ro, rd, tm, act, any_hit, lib=lib)
    n, dev = ro.shape[0], ro.device
    args = [getattr(t, k).data_ptr() for k in tlas.ARRAY_FIELDS] + [
        t.num_instances, t.blas_tris.shape[0], ro.data_ptr(), rd.data_ptr(),
        tm.data_ptr(), act.data_ptr(), n]

    def run():
        if any_hit:
            outs = (torch.empty(n, dtype=torch.bool, device=dev),)
        else:
            tt = torch.empty(n, dtype=torch.float32, device=dev)
            outs = (tt, torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty_like(tt), torch.empty_like(tt),
                    torch.empty(n, dtype=torch.int32, device=dev))
        fn = lib.any_hit if any_hit else lib.closest_hit
        rc = packet._call_on(fn, dev, *args, *(x.data_ptr() for x in outs))
        if rc != 0:
            raise RuntimeError(f"tlas launch failed: cudaError {rc}")
        return outs[0] if any_hit else tlas.TlasHit(*outs)

    return run


def same(got, want) -> bool:
    import torch

    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def compare(libs, rounds, bad, dev):
    """Each library's kernel at both launches, alternated; returns
    {launch: {label: [ms per round]}} and prints the walk's visits."""
    import torch

    from moonshine_tpu_torch.accel import tlas
    from moonshine_tpu_torch.scripts import cuda_ms

    scene, la, warned = instanced_1080p(dev)
    t = scene.tlas
    print(f"instanced_1080p: {t.num_instances} instances, "
          f"{t.num_obj_tris} object triangles, {t.walk.nodes.shape[0]} "
          f"8-wide nodes, stack depth {t.walk.stack_depth}; warned "
          f"{bool(warned)}", flush=True)
    result = {}
    for name, (ro, rd, tm, act, any_hit) in batches(scene, la, dev).items():
        runs = {label: launcher(lib, t, ro, rd, tm, act, any_hit)
                for label, lib in libs.items()}
        want = runs["this"]()
        for label, run in runs.items():
            if label != "this" and not same(run(), want):
                bad.append(f"{name}: {label}")
                print(f"{name}: {label}'s outputs differ", flush=True)
        torch.cuda.synchronize()
        ms = {label: [] for label in runs}
        for _ in range(rounds):  # alternated, so clocks hit all alike
            for label, run in runs.items():
                ms[label].append(cuda_ms(run, REPS))
        n = ro.shape[0]
        v = tlas.walk_visits(t, ro, rd, tm, act, any_hit)
        per = {k: getattr(v, k) / n for k in v._fields}
        print(f"{name} on {n} rays ({int(act.sum())} live): " + ", ".join(
            f"{label} {min(x):.4f} ms (rounds {', '.join(f'{y:.4f}' for y in x)})"
            for label, x in ms.items()) + "; the walk a ray: " + ", ".join(
            f"{k} {x:.2f}" for k, x in per.items()), flush=True)
        result[name] = {"ms": ms, "visits": v._asdict(), "n": n}
    return result


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout whose tlas.cu runs beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_tlas needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    against = native.build_against(args.against, ("tlas",))()
    own = native.build_all(("tlas", "tlas_count"))
    libs = {"this": own["tlas"], **against["tlas"]}
    for name, lib in {**libs, "this (counting)": own["tlas_count"]}.items():
        print(f"{name}: {lib.path.name}, built in {lib.build_seconds:.1f} s; "
              f"ptxas: {native.ptxas_summary(lib.log)}", flush=True)
    bad: list[str] = []
    result = {"card": smi,
              "launches": compare(libs, args.rounds, bad,
                                  torch.device("cuda", 0)),
              "mismatch": bad}
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
