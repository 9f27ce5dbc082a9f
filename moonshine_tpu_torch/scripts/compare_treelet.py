"""The treelet dispatch (csrc/treelet.cu: phase 1 and the walk) against
what it replaces, on the same rays, on the card:

    python -m moonshine_tpu_torch.scripts.compare_treelet [--rounds N]
        [--against DIR ...]

On room_184k built 8-wide / 8-slot (MSN_WIDE=8 MSN_LEAF_CAP=8, the
treelet_1080p cell's tree), at the 1080p frame's launches (2,073,600
camera rays; their 4,147,200-lane shadow batch; a deep bounce's
closest-hit launch, bounce 3 of an eager treelet_1080p sample, recorded
by `record_launches`): phase 1's kernel against its plain torch version
(bit for bit, both timed, with `pending_bounds`: the all-pairs bound and
the bound of the work the kernel's cull leaves), the walk on the
phase-1 sorted lanes, and the whole wrappers (phase 1, sort, walk,
unsort). Phase 1 alone also at live shares of 50%, 10% and 1% of the
camera launch, the dead lanes scattered (`thinned`). Each `--against DIR` is another checkout (an earlier commit, or
a variant of this one, unpacked into a gitignored directory): its
csrc/treelet.cu is built beside this one (unless it and the headers
beside it equal this checkout's), and its walk and, where it has
one, its phase 1 run on the same lanes, alternated with this checkout's,
and must give the same outputs bit for bit. A treelet.cu without phase 1
is taken to have the one-thread-per-ray walk's signature (roots and K
only; no boxes, no stack bound). Kernel times come from alternated rounds
of scripts.cuda_ms. Prints one line per measurement, then one JSON line;
exits 1 if an output differs or a launch is refused.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from moonshine_tpu_torch.accel import native

TREELET_TREE = (8, 8)  # MSN_WIDE, MSN_LEAF_CAP


def _walk_launcher(lib, wb, srt, any_hit):
    """The walk of `lib` on the sorted lanes `srt`."""
    import torch

    from moonshine_tpu_torch.accel import launch, packet, treelet

    if lib.pending is not None:
        return lambda: treelet._dispatch_kernel(wb, *srt, any_hit, lib=lib)
    o, d, t, pend, first = srt
    n, dev = o.shape[0], o.device
    args = [wb.nodes.data_ptr(), wb.leaves.data_ptr(), wb.nodes[0].numel(),
            wb.leaves[0].numel(), wb.width, wb.leaf_slots,
            wb.t_roots.data_ptr(), wb.t_roots.shape[0], pend.data_ptr(),
            pend.shape[1], first.data_ptr(), o.data_ptr(), d.data_ptr(),
            t.data_ptr(), n]

    def run():
        if any_hit:
            outs = (torch.empty(n, dtype=torch.bool, device=dev),)
        else:
            tt = torch.empty(n, dtype=torch.float32, device=dev)
            outs = (tt, torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty_like(tt), torch.empty_like(tt))
        fn = lib.any_hit if any_hit else lib.closest_hit
        rc = launch.call_on(fn, dev, *args, *(x.data_ptr() for x in outs))
        if rc != 0:
            raise RuntimeError(f"walk launch failed: cudaError {rc}")
        return outs[0] if any_hit else packet.Hit(*outs)

    return run


def record_launches(scene, lens, cfg, height=1080, width=1920):
    """Every treelet dispatch of one eager sample of the frame (sample 0,
    MSN_TREELETS=1), in order: (any_hit, o, d, t_eff) as phase 1 gets
    them, copied."""
    import os

    import torch

    from moonshine_tpu_torch.accel import treelet
    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.render.renderer import render_spp

    rec = []
    real = treelet._run

    def run(wbvh, ray_o, ray_d, t_max, active_in, any_hit, plain, **kw):
        t = treelet._t_max_lanes(t_max, ray_o.shape[0], ray_o.device)
        t_eff = t if active_in is None else torch.where(active_in, t,
                                                        treelet._NEG)
        rec.append((any_hit, ray_o.clone(), ray_d.clone(), t_eff.clone()))
        return real(wbvh, ray_o, ray_d, t_max, active_in, any_hit, plain,
                    **kw)

    before = os.environ.get("MSN_TREELETS")
    os.environ["MSN_TREELETS"] = "1"
    treelet._run = run
    try:
        with graphs.eager():
            render_spp(scene, lens, height, width, 0, 1, cfg)
    finally:
        treelet._run = real
        if before is None:
            os.environ.pop("MSN_TREELETS", None)
        else:
            os.environ["MSN_TREELETS"] = before
    torch.cuda.synchronize()
    return rec


def deep_launch(rec, bounce: int = 3):
    """The closest-hit launch of `bounce` among recorded launches (the last
    one where the sample stopped before it)."""
    closest = [r for r in rec if not r[0]]
    return closest[min(bounce, len(closest) - 1)]


def thinned(t_eff, share: float, seed: int = 7):
    """t_eff with all but `share` of its live lanes made dead (-1e30), the
    dead lanes scattered by a seeded draw."""
    import torch

    g = torch.Generator(device=t_eff.device).manual_seed(seed)
    keep = torch.rand(t_eff.shape, generator=g, device=t_eff.device) < share
    return torch.where(keep, t_eff, torch.full_like(t_eff, -1.0e30))


def pending_bounds(wb, o, d, t_eff, pend, peak_bytes=3.35e12,
                   peak_flops=67e12) -> dict:
    """Phase 1's bounds on one launch: each ray's o, d and t_max read and
    its words and nearest treelet written once, the boxes read once; the
    operations either every live (ray, treelet) pair's box test
    (`all_pairs`, the yardstick of earlier rows) or the work the kernel's
    cull leaves (`culled`: a union test a live ray and word, a box test
    a treelet of each word it enters), each test packet.FLOPS_PER_NODE_SLOT, plus an
    entry max and compare a pending pair. Each: (ms, "bytes" or
    "operations"); with the counts."""
    from moonshine_tpu_torch.accel import packet, treelet

    m, k32 = o.shape[0], pend.shape[1]
    k = wb.t_roots.shape[0]
    alive = t_eff > 0.0
    live = int(alive.sum())
    pairs = int(treelet.pending_bits(pend, k).sum())
    import torch

    hits = treelet.entered_words(wb, o, d, t_eff)
    size = torch.clamp(k - 32 * torch.arange(k32, device=hits.device),
                       max=32)  # the treelets of each word
    entered = int(hits.sum())
    box_tests = int((hits.to(torch.int64) * size).sum())
    nbytes = m * (12 + 12 + 4 + 4 * k32 + 4) + k * 24
    t_bytes = nbytes / peak_bytes * 1e3
    out = {"live": live, "lanes": m, "k": k, "pairs": pairs,
           "entered_words": entered, "bytes": nbytes}
    for name, tests in (("all_pairs", live * k),
                        ("culled", live * k32 + box_tests)):
        flops = tests * packet.FLOPS_PER_NODE_SLOT + 2 * pairs
        t_ops = flops / peak_flops * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "operations" if t_ops >= t_bytes else "bytes")
        out[f"{name}_flops"] = flops
    return out


def _same(got, want) -> bool:
    import torch

    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def compare(libs, rounds, bad):
    """Phase 1, the walk and the wrappers at both 1080p launches."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scripts import compare_traverse, cuda_ms
    from moonshine_tpu_torch.scripts import shadow_batch

    scene, lens = compare_traverse._room(*TREELET_TREE)
    wb = scene.wide
    dev = wb.nodes.device
    k = wb.t_roots.shape[0]
    o, d, _, _ = _sample_rays(lens, 1080, 1920, 0, True, dev)
    n = o.shape[0]
    batches = {"closest": (o, d, torch.full((n,), 1.0e12, device=dev),
                           torch.ones(n, dtype=torch.bool, device=dev)),
               "any": shadow_batch(o, d, packet.closest_hit_packet(
                   wb, o, d, 1.0e12))}
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    _, do, dd, dt = deep_launch(record_launches(scene, lens, cfg))
    batches["deep"] = (do, dd, dt, dt > 0.0)
    t_cam = batches["closest"][2]
    thin = {share: thinned(t_cam, share) for share in (0.5, 0.1, 0.01)}
    print(f"8/8 tree: K = {k} treelets, treelet stack bound "
          f"{wb.treelet_stack} (the tree's {wb.max_stack}), walk blocks of "
          f"{libs['this'].block(wb.treelet_stack)} threads", flush=True)
    out = {}
    for kind, (ro, rd, tm, act) in batches.items():
        any_hit = kind == "any"
        m = ro.shape[0]
        t_eff = torch.where(act, tm, -1.0e30)
        label = f"{kind} hit, {m} lanes"
        want_p1 = treelet._pending_masks_plain(wb, ro, rd, t_eff)
        b = pending_bounds(wb, ro, rd, t_eff, want_p1[0])
        print(f"{label}: phase 1 bounds: all pairs {b['all_pairs'][0]:.4f} "
              f"ms by {b['all_pairs'][1]}, culled {b['culled'][0]:.4f} ms "
              f"by {b['culled'][1]} ({b['live']} live, "
              f"{b['entered_words']} words entered of {b['live']} x "
              f"{want_p1[0].shape[1]}, {b['pairs']} pending pairs)",
              flush=True)
        p1 = {name: (lambda lib=lib: treelet._pending_kernel(
            lib, wb, ro, rd, t_eff))
              for name, lib in libs.items() if lib.pending is not None}
        for name, fn in p1.items():
            if not _same(fn(), want_p1):
                bad.append(f"{label} phase 1 {name}")
        perm, srt = treelet._sort_lanes(wb, ro, rd, t_eff)
        walks = {name: _walk_launcher(lib, wb, srt, any_hit)
                 for name, lib in libs.items()}
        want = walks["this"]()
        for name, fn in walks.items():
            try:
                if not _same(fn(), want):
                    bad.append(f"{label} walk {name}")
            except RuntimeError as e:  # a launch the card refused
                print(f"{label} walk {name}: {e}", flush=True)
                bad.append(f"{label} walk {name}")
        torch.cuda.synchronize()
        print(f"{label}: phase 1 of {sorted(p1)} = plain, walks of "
              f"{sorted(walks)} equal: "
              f"{not [b for b in bad if b.startswith(label)]}", flush=True)
        fk = treelet.any_hit_treelet if any_hit else \
            treelet.closest_hit_treelet
        runs = {**{f"phase 1 {x}": f for x, f in p1.items()},
                **{f"walk {x}": f for x, f in walks.items()},
                "wrapper this": lambda: fk(wb, ro, rd, tm, act)}
        ms = {x: [] for x in runs}
        for _ in range(rounds):  # alternated, so clocks hit all alike
            for x, f in runs.items():
                ms[x].append(cuda_ms(f, 5))
        ms["phase 1 plain"] = [cuda_ms(
            lambda: treelet._pending_masks_plain(wb, ro, rd, t_eff), 2)]
        for x, v in ms.items():
            print(f"{label} {x}: " + " / ".join(f"{y:.4f}" for y in v)
                  + " ms", flush=True)
        out[kind] = ms
        out[f"{kind}_bounds"] = b
    for share, t_eff in thin.items():  # phase 1 alone at thinned shares
        label = f"closest hit at {share:.0%} live"
        want_p1 = treelet._pending_masks_plain(wb, o, d, t_eff)
        p1 = {name: (lambda lib=lib, t=t_eff: treelet._pending_kernel(
            lib, wb, o, d, t))
              for name, lib in libs.items() if lib.pending is not None}
        for name, fn in p1.items():
            if not _same(fn(), want_p1):
                bad.append(f"{label} phase 1 {name}")
        ms = {x: [] for x in p1}
        for _ in range(rounds):
            for x, f in p1.items():
                ms[x].append(cuda_ms(f, 5))
        b = pending_bounds(wb, o, d, t_eff, want_p1[0])
        for x, v in ms.items():
            print(f"{label} phase 1 {x}: " + " / ".join(f"{y:.4f}" for y in v)
                  + f" ms (bounds: all pairs {b['all_pairs'][0]:.4f}, culled "
                  f"{b['culled'][0]:.4f} ms)", flush=True)
        out[f"closest_{share}"] = {**{f"phase 1 {x}": v
                                      for x, v in ms.items()}, "bounds": b}
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout whose treelet.cu runs beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_treelet needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    against = native.build_against(args.against, ("treelet",))()
    libs = {"this": native.build_all(("treelet",))["treelet"],
            **against["treelet"]}
    for name, lib in libs.items():
        print(f"{name}: {lib.path.name}, built in {lib.build_seconds:.1f} s; "
              f"ptxas: {native.ptxas_summary(lib.log)}", flush=True)
    bad: list[str] = []
    result = {"card": smi, "ms": compare(libs, args.rounds, bad),
              "mismatch": bad}
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
