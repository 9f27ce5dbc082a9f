"""The lane sort (csrc/sort.cu) at each site's first 1080p call, split into
its parts, against the plain versions, torch.argsort and, optionally,
other checkouts' kernels:

    python -m moonshine_tpu_torch.scripts.compare_sort [--rounds N]
        [--samples N] [--against DIR ...]

One eager sample of room_1080p (room_scene(grid=6, subdivisions=4) at
1920x1080, one env and one mesh-light sample a bounce: the resort, the
packet dispatch's sorts of the 2,073,600 camera rays and of the
4,147,200-lane shadow batch, and the dispatch's inverse move) and of
treelet_1080p (that scene built MSN_WIDE=8 MSN_LEAF_CAP=8 and dispatched
with MSN_TREELETS=1: the treelet dispatch's sort) is recorded
(`record_sorts`): each site's first call with its inputs. At each site
the key (coherence_key, from the lanes it was made of), the permutation
passes (msn_sort_lanes alone) and the move (msn_move_lanes alone) are
held bit for bit against the recorded key, torch.argsort(key,
stable=True) and the plain moves, and timed apart, each launch after a
256 MiB write (a cold L2; compare_shade.time_inplace), beside
torch.argsort and their bounds (`bounds`). Each `--against DIR` is
another checkout (an earlier commit unpacked by `git archive` into a
gitignored directory) whose sort.cu has the same entry points: it is
built beside this one, and its passes and move run on the same inputs in
alternated rounds, held bit for bit against this checkout's. Then
room_1080p and offline_720p (the offline CLI's scene as the smoke renders
it in process: room_184k untextured with a seeded sky, 1280x720,
max_bounces 1024) are sampled as graph replays with each build's library
in turn, `--samples` timed samples a round, their images held bit for
bit. Prints one line per measurement, then one JSON line; exits 1 if an
output differs.

`record_sorts`, `site_calls`, `key_inputs`, `bits_equal`, `bounds`,
`passes_of` and `move_of` serve chip_smoke.py's `sort` phase too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

from moonshine_tpu_torch.accel import native

HD = (1080, 1920)
OFFLINE_HW = (720, 1280)
TREELET_ENV = {"MSN_WIDE": "8", "MSN_LEAF_CAP": "8"}
REPS = 10
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
# integer operations a lane and digit pass of the sort kernels (the
# digit, the match, the popcounts, the rank), over the card's int32 rate:
# 64 INT32 lanes an SM x 132 SMs x 1.98 GHz
SORT_OPS_PER_LANE_PASS = 12
PEAK_INT32 = 64 * 132 * 1.98e9
SECTOR = 32  # bytes: the unit in which L2 and device memory move data
SITES = ("resort", "packet closest hit", "packet shadow batch",
         "treelet closest hit")


@contextlib.contextmanager
def _env(**values):
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


def record_sorts(render):
    """The first sort_lanes call of each (bits, lanes) and the first
    unsort_lanes call of each lane count in render() (run on the eager
    loop, where the wrappers are called at every launch): their inputs
    cloned, as {("sort", bits, n): (key, arrays, rows, out shapes),
    ("unsort", n): (perm, arrays)}."""
    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.integrator import graphs

    rec = {}
    real = sortutil.sort_lanes, sortutil.unsort_lanes

    def sort(key, arrays, bits, out=None, rows=None):
        rec.setdefault(("sort", bits, key.shape[0]), (
            key.clone(), [a.clone() for a in arrays], rows,
            None if out is None else [o.shape for o in out]))
        return real[0](key, arrays, bits, out=out, rows=rows)

    def unsort(perm, arrays):
        rec.setdefault(("unsort", perm.shape[0]), (
            perm.clone(), [a.clone() for a in arrays]))
        return real[1](perm, arrays)

    sortutil.sort_lanes, sortutil.unsort_lanes = sort, unsort
    try:
        with graphs.eager():
            render()
    finally:
        sortutil.sort_lanes, sortutil.unsort_lanes = real
    return rec


def site_calls(room, room_lens, tree, tree_lens, cfg) -> dict:
    """{site: recorded call} for the four sites (`SITES`) and "unsort",
    from one eager 1080p sample of room_1080p and of treelet_1080p
    (`tree`, built with TREELET_ENV, dispatched with MSN_TREELETS=1)."""
    from moonshine_tpu_torch.accel import packet, treelet
    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.render.renderer import render_spp

    h, w = HD
    rec = record_sorts(lambda: render_spp(room, room_lens, h, w, 0, 1, cfg))
    with _env(MSN_TREELETS="1"):
        rec.update(record_sorts(lambda: render_spp(tree, tree_lens, h, w, 0,
                                                   1, cfg)))
    keys = dict(zip(SITES, (
        ("sort", path.RESORT_BITS, h * w),
        ("sort", packet.SORT_KEY_BITS, h * w),
        ("sort", packet.SORT_KEY_BITS, 2 * h * w),
        ("sort", treelet.key_bits(tree.wide), h * w))))
    keys["unsort"] = ("unsort", h * w)
    missing = [k for k, v in keys.items() if v not in rec]
    if missing:
        raise AssertionError(f"no recorded call for {missing}: recorded "
                             f"{sorted(rec)}")
    return {site: (k[1] if k[0] == "sort" else None, rec[k])
            for site, k in keys.items()}


def key_inputs(site, arrays, room, tree):
    """(o, d, bounds, cells, keywords) that the site's key came from."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator import path

    if site == "resort":
        names = [k for k in path._init_state(
            torch.zeros(1, 3), torch.zeros(1, 3), torch.zeros(1))
            if k != "rays"]
        st = dict(zip(names, arrays))
        return (st["o"], st["d"], room.wide.bounds, path.RESORT_CELLS,
                dict(active=st["active"]))
    if site.startswith("packet"):
        return (arrays[0], arrays[1], room.wide.bounds, packet.SORT_CELLS,
                dict(active=arrays[3]))
    return (arrays[0], arrays[1], tree.wide.bounds, packet.SORT_CELLS,
            dict(major=arrays[4]))


def bits_equal(a, b):
    """a and b equal bit for bit (floats compared as their words)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = (a.contiguous().view(torch.int32),
                b.contiguous().view(torch.int32))
    return bool((a == b).all())


def _row_bytes(a) -> int:
    return (a.shape[1] if a.ndim == 2 else 1) * a.element_size()


def sectors_per_row(row: int) -> float:
    """The mean count of 32-byte sectors that a row of `row` bytes spans,
    over the rows of a contiguous array (row i at byte i * row)."""
    period = SECTOR // math.gcd(row, SECTOR)
    return sum((i * row + row - 1) // SECTOR - (i * row) // SECTOR + 1
               for i in range(period)) / period


def bounds(n, arrays, rows, passes) -> dict:
    """The least times of one sort_lanes call (`passes` digit passes,
    `native.sort_lib().passes(bits)`) or, with passes = 0, of one
    unsort_lanes call, on the card's published rates:
    "sort": the whole call: the key read and the permutation written once
    (an unsort reads the permutation), each array's moved rows read and
    written once, and the passes' integer operations;
    "perm": the permutation alone (the key read, the permutation written,
    the operations);
    "move": the move alone (the permutation read, the rows read and
    written once), by bytes;
    "move_sectors": the move counted in 32-byte sectors: every row on the
    side that the permutation scatters (the reads of a gather, the writes
    of a scatter) as the sectors it spans, no sector shared between rows
    (no reuse in L2), the other side and the permutation by bytes.
    Each is (ms, what bounds it, detail)."""
    moved = sum(_row_bytes(a) * r for a, r in zip(arrays, rows))
    ordered = sum(sectors_per_row(_row_bytes(a)) * SECTOR * min(r, n)
                  for a, r in zip(arrays, rows))
    moved_perm = sum(_row_bytes(a) * min(r, n) for a, r in zip(arrays, rows))
    ops = n * passes * SORT_OPS_PER_LANE_PASS
    t_ops = ops / PEAK_INT32 * 1e3
    ms = lambda b: b / PEAK_BYTES * 1e3

    def by(nbytes, what):
        t = ms(nbytes)
        return ((max(t, t_ops), "operations" if t_ops > t else "bytes",
                 f"{nbytes / 1e6:.2f} MB ({what}) -> {t:.4f} ms, {passes} "
                 f"passes, {ops / 1e6:.1f} M int ops -> {t_ops:.4f} ms"))

    out = {"sort": by(n * (8 if passes else 4) + 2 * moved,
                      "key, permutation, rows each way")}
    move = n * 4 + 2 * moved
    out["move"] = (ms(move), "bytes", f"{move / 1e6:.2f} MB (permutation, "
                   f"rows each way) -> {ms(move):.4f} ms")
    sect = n * 4 + moved + ordered + (moved - moved_perm)
    out["move_sectors"] = (ms(sect), "sectors", (
        f"{sect / 1e6:.2f} MB (permutation, rows by bytes on the ordered "
        f"side, the permuted side's {ordered / 1e6:.2f} MB of whole "
        f"sectors) -> {ms(sect):.4f} ms"))
    if passes:
        out["perm"] = by(n * 8, "key, permutation")
    return out


def sort_launches(fn) -> dict:
    """The device operations of one call of fn under torch.profiler:
    {"kernels": count, "memsets": count, "names": sorted kernel names,
    "us": [(name, device us) of each operation in launch order]} (a warm
    L2: nothing is flushed between the operations)."""
    import torch

    from moonshine_tpu_torch.render.profile_frame import _trace_events

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then holds no device events
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in _trace_events(prof)
                      if e.get("cat") in ("kernel", "gpu_memset")),
                     key=lambda e: e["ts"])
        if ops:
            break
    short = lambda e: (e["name"].replace("(anonymous namespace)::", "")
                       .split("(")[0].split("<")[0])
    names = [short(e) for e in ops if e["cat"] == "kernel"]
    return {"kernels": len(names), "memsets": len(ops) - len(names),
            "names": sorted(set(names)),
            "us": [(short(e) if e["cat"] == "kernel" else "memset",
                    round(e.get("dur", 0.0), 2)) for e in ops]}


def _call(lib, fn_name, dev, *args):
    from moonshine_tpu_torch.accel.launch import call_on

    rc = call_on(getattr(lib, fn_name), dev, *args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")


def passes_of(lib, key, bits):
    """(run, perm): run() launches lib's permutation passes alone on key
    into perm (its workspace allocated once, outside)."""
    import torch

    n, dev = key.shape[0], key.device
    work = torch.empty(lib.work_ints(n, bits), dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    return (lambda: _call(lib, "sort", dev, key.data_ptr(), n, bits,
                          work.data_ptr(), perm.data_ptr())), perm


def move_of(lib, perm, arrays, rows, out_shapes, scatter):
    """(run, outs): run() launches lib's move alone: the arrays by perm
    into outs (fresh zeros of the recorded shapes), each array's first
    min(rows, n) rows by the permutation and the rest up to rows where
    they lie (gathering), or every row scattered (the inverse)."""
    import torch

    from moonshine_tpu_torch.core import sortutil

    n = perm.shape[0]
    shapes = out_shapes or [a.shape for a in arrays]
    outs = [torch.zeros(sh, dtype=a.dtype, device=a.device)
            for sh, a in zip(shapes, arrays)]
    rows_perm = [min(r, n) for r in rows]
    return (lambda: sortutil._move(lib, perm, n, arrays, outs, rows_perm,
                                   rows, scatter)), outs


def cold_ms(fn) -> float:
    """fn's mean device time over REPS launches, each after a 256 MiB
    write (compare_shade.time_inplace: nothing to restore)."""
    from moonshine_tpu_torch.scripts.compare_shade import time_inplace

    return time_inplace(fn, [], [], REPS)


def cells(dev):
    """(room, room_lens, tree, tree_lens, cfg): room_184k built as the
    default and as treelet_1080p's tree, the 1080p cells' PathConfig."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.room_scene(grid=6, subdivisions=4)
    room = world.build(dev)
    with _env(**TREELET_ENV):
        world, _ = procedural.room_scene(grid=6, subdivisions=4)
        tree = world.build(dev)
    lens = LensArrays.from_lens(lens, dev)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    return room, lens, tree, lens, cfg


def offline_cell(dev):
    """(sample(i), name): one offline_720p sample as the offline CLI
    renders it at its defaults (room_184k with constant materials and the
    seeded sky of scripts.skybox, 1280x720, max_bounces 1024, one env and
    one mesh-light sample a bounce)."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_sample
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts import skybox

    world, lens = procedural.room_scene(grid=6, subdivisions=4,
                                        textured=False)
    world.set_background(skybox())
    scene = world.build(dev)
    lens = LensArrays.from_lens(lens, dev)
    cfg = PathConfig(max_bounces=1024, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    h, w = OFFLINE_HW
    return lambda i: render_sample(scene, lens, h, w, i, cfg)


def time_samples(samples: dict, libs: dict, rounds: int, count: int):
    """{cell: {label: [ms a sample, a round each]}} and the mismatches:
    each cell's sample (samples: name -> sample(i)) rendered as graph
    replays with each library of `libs` loaded as the lane sort's in
    turn (the order reversed every other round), the graphs captured
    anew for each (a warm-up sample), then `count` samples timed on the
    host clock; each library's image of sample 0 held bit for bit
    against the first's."""
    import torch

    from moonshine_tpu_torch.integrator import graphs

    own = native._LOADED.get("sort")
    out, bad, first = {}, [], {}
    try:
        for cell, sample in samples.items():
            out[cell] = {label: [] for label in libs}
            for r in range(rounds):
                order = list(libs) if r % 2 == 0 else list(libs)[::-1]
                for label in order:
                    native._LOADED["sort"] = libs[label]
                    graphs.clear()
                    img = sample(0)[0].clone()  # the warm-up: captures
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(count):
                        sample(0)
                    torch.cuda.synchronize()
                    out[cell][label].append(
                        (time.perf_counter() - t0) * 1e3 / count)
                    ref = first.setdefault(cell, img)
                    if not torch.equal(img, ref):
                        bad.append(f"{cell}: {label}'s image differs")
            print(f"{cell} a sample as graph replays, {count} a round: "
                  + ", ".join(f"{label} {min(v):.2f} ms (rounds "
                              f"{', '.join(f'{x:.2f}' for x in v)})"
                              for label, v in out[cell].items()),
                  flush=True)
    finally:
        native._LOADED["sort"] = own
        graphs.clear()
    return out, bad


def main(argv=None) -> int:
    import torch

    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.render.renderer import render_spp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--samples", type=int, default=3,
                    help="timed samples a round and library (0: none)")
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout whose sort.cu runs beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_sort needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    against = native.build_against(args.against, ("sort",))()["sort"]
    own = native.sort_lib()
    libs = {"this": own, **against}
    for label, lib in libs.items():
        print(f"{label}: {lib.path.name}, built in {lib.build_seconds:.1f} s;"
              f" ptxas: {native.ptxas_summary(lib.log)}", flush=True)
    dev = torch.device("cuda", 0)
    room, room_lens, tree, tree_lens, cfg = cells(dev)
    calls = site_calls(room, room_lens, tree, tree_lens, cfg)
    bad, result = [], {"card": smi, "sites": {}}
    for site in (*SITES, "unsort"):
        bits, call = calls[site]
        scatter = site == "unsort"
        if scatter:
            perm, arrays = call
            n, rows, out_shapes, key = perm.shape[0], None, None, None
        else:
            key, arrays, rows, out_shapes = call
            n = key.shape[0]
        rows = rows or [a.shape[0] for a in arrays]
        row = {"n": n, "bits": bits, "arrays": len(arrays), "rows": rows}
        diffs = []
        if not scatter:
            o, d, bnd, c, kw = key_inputs(site, arrays, room, tree)
            got_key = sortutil.coherence_key(o, d, bnd, c, **kw)
            want_key = sortutil.coherence_key_plain(o, d, bnd, c, **kw)
            if not (bits_equal(got_key, key) and bits_equal(want_key, key)):
                diffs.append("coherence key")
            row["key_ms"] = cold_ms(
                lambda: sortutil.coherence_key(o, d, bnd, c, **kw))
            lib_perm = torch.argsort(key, stable=True).int()
            row["argsort_ms"] = cold_ms(
                lambda: torch.argsort(key, stable=True))
            _, want = sortutil.sort_lanes_plain(
                key, arrays, bits, rows=rows,
                out=None if out_shapes is None else [
                    torch.zeros(sh, dtype=a.dtype, device=dev)
                    for sh, a in zip(out_shapes, arrays)])
        else:
            want = sortutil.unsort_lanes_plain(perm, arrays)
        runs = {}
        for label, lib in libs.items():
            if not scatter:
                p_run, perm = passes_of(lib, key, bits)
                p_run()
                if not bits_equal(perm, lib_perm):
                    diffs.append(f"{label} permutation")
                launches = sort_launches(p_run)
            m_run, outs = move_of(lib, perm if scatter else lib_perm, arrays,
                                  rows, out_shapes, scatter)
            m_run()
            if not all(bits_equal(g, w_) for g, w_ in zip(outs, want)):
                diffs.append(f"{label} move")
            runs[label] = (None if scatter else p_run, m_run,
                           None if scatter else launches)
        ms = {label: {"passes": [], "move": []} for label in libs}
        for r in range(args.rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for label in order:
                p_run, m_run, _ = runs[label]
                if p_run is not None:
                    ms[label]["passes"].append(cold_ms(p_run))
                ms[label]["move"].append(cold_ms(m_run))
        passes = 0 if scatter else own.passes(bits)
        b = bounds(n, arrays, rows, passes)
        row.update(ms=ms, bounds={k: v[:2] for k, v in b.items()},
                   launches={k: v[2] for k, v in runs.items()})
        result["sites"][site] = row
        fmt = lambda xs: (f"{min(xs):.4f} ms (rounds "
                          f"{', '.join(f'{x:.4f}' for x in xs)})")
        head = (f"{site}: {n} lanes, {len(arrays)} arrays, rows {rows}"
                + ("" if scatter else f", bits {bits}, {passes} passes"))
        print(head + ("; outputs held bit for bit" if not diffs else
                      "; DIFFER: " + "; ".join(diffs)), flush=True)
        if not scatter:
            print(f"  key {row['key_ms']:.4f} ms; torch.argsort "
                  f"{row['argsort_ms']:.4f} ms; permutation bound "
                  f"{b['perm'][0]:.4f} ms by {b['perm'][1]} "
                  f"({b['perm'][2]})", flush=True)
        for label in libs:
            parts = ([] if scatter else
                     [f"passes {fmt(ms[label]['passes'])}"])
            parts.append(f"move {fmt(ms[label]['move'])}")
            if not scatter:
                lc = runs[label][2]
                parts.append(f"passes launch {lc['kernels']} kernels "
                             f"and {lc['memsets']} memsets: "
                             + ", ".join(f"{k} {v} us" for k, v in lc["us"]))
            print(f"  {label}: " + "; ".join(parts), flush=True)
        print(f"  move bound {b['move'][0]:.4f} ms by bytes ({b['move'][2]});"
              f" by sectors {b['move_sectors'][0]:.4f} ms "
              f"({b['move_sectors'][2]})", flush=True)
        if diffs:
            bad.append(f"{site}: " + "; ".join(diffs))
    if args.samples:
        samples = {"room_1080p": lambda i: render_spp(
            room, room_lens, HD[0], HD[1], i, 1, cfg),
            "offline_720p": offline_cell(dev)}
        result["samples"], sample_bad = time_samples(
            samples, libs, args.rounds, args.samples)
        bad += sample_bad
    result["mismatch"] = bad
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
