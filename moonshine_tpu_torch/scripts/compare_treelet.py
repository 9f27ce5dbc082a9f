"""The treelet dispatch (csrc/treelet.cu: phase 1 and the walk) against
what it replaces, on the same rays, on the card:

    python -m moonshine_tpu_torch.scripts.compare_treelet [--rounds N]
        [--against DIR ...]

On room_184k built 8-wide / 8-slot (MSN_WIDE=8 MSN_LEAF_CAP=8, the
treelet_1080p cell's tree), at the 1080p frame's launches (2,073,600
camera rays; their 4,147,200-lane shadow batch): phase 1's kernel against
its plain torch version (bit for bit, both timed), the walk on the
phase-1 sorted lanes, and the whole wrappers (phase 1, sort, walk,
unsort). Each `--against DIR` is another checkout (an earlier commit, or
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


def _same(got, want) -> bool:
    import torch

    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def compare(libs, rounds, bad):
    """Phase 1, the walk and the wrappers at both 1080p launches."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet
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
