"""Arithmetic microbenchmarks of the traversal's child test (port of
scripts/profile_vpu.py), and the wrappers of their CUDA kernels
(csrc/vpu.cu).

    python -m moonshine_tpu_torch.scripts.profile_vpu [--against DIR ...]

Answers on the card what the reference asked of the TPU's vector unit:
  1. Is bfloat16 elementwise math faster than float32 (the pure ALU chain
     `alu`, and the slab test's mul/sub/min/max mix)?
  2. Does the slab test written `lo * inv - o * inv` (FMA-shaped) beat
     `(lo - o) * inv` (sub-mul)?
  3. What does one "any lane hit" per child cost against one packed
     8-bit word per visit and its max over lanes?

`slab` and `alu` launch the CUDA kernels for CUDA tensors and run their
plain torch versions (`slab_plain`, `alu_plain`, loops over visits) for
CPU tensors; any other device raises. Each takes its inputs as
arguments; `slab_inputs` and `alu_inputs` make the reference's (`run()`
at profile_vpu.py:97-100 and :134-136), on which no lane hits any child,
or seeded ones on which lanes do. `main` times the reference's nine
configurations with CUDA events and prints them as the reference does,
in ms per dispatch and us per visit. `latency` times one thread's chain
of one operation class in clock64() cycles and `chain_floor_ms` turns
those into the ALU chain's least time; `empty_ms` times an empty kernel.

Each `--against DIR` is another checkout of the repo (an earlier commit
unpacked with `git archive`, or a copy of this one with a variant of
csrc/vpu.cu, in a gitignored directory): its vpu.cu is built beside this
checkout's and its kernels run on the same inputs, in turns, for every
configuration on the reference's inputs and on seeded ones (seed 1), each
output held against the plain version at 2000 visits. Times are means
over ROUNDS alternated rounds of `scripts.cuda_ms` of REPS launches (the
whole dispatch: the wrapper's output allocation and sum included, as the
reference timed its dispatch); the wrapper's share is timed alone. Prints
each build's ptxas report, one line per configuration and one JSON line;
exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..accel import native
from . import cuda_ms

VISITS = 2000
ROWS = 64  # lanes: ROWS x 128
CHILDREN = 8

LAUNCHES = {"vpu_slab": 0, "vpu_alu": 0}

# (name, dtype, fma_form, packed_any) and (name, dtype, rows), in the
# reference's order (profile_vpu.py:151-173)
ALU_CONFIGS = [
    ("pure ALU f32 (64x128, 10 ops/iter)", torch.float32, 64),
    ("pure ALU bf16 (64x128, 10 ops/iter)", torch.bfloat16, 64),
    ("pure ALU f32 (256x128)", torch.float32, 256),
    ("pure ALU bf16 (256x128)", torch.bfloat16, 256),
]
SLAB_CONFIGS = [
    ("slab f32 sub-mul, per-child any", torch.float32, False, False),
    ("slab f32 FMA-form, per-child any", torch.float32, True, False),
    ("slab f32 sub-mul, packed-or any", torch.float32, False, True),
    ("slab bf16 sub-mul, per-child any", torch.bfloat16, False, False),
    ("slab bf16 sub-mul, packed-or any", torch.bfloat16, False, True),
]
_DTYPES = (torch.float32, torch.bfloat16)
SEED = 1  # the seeded inputs that --against and the checks use
ROUNDS, REPS = 4, 20  # --against: alternated rounds, launches a round
# the latency probe's kinds and operation classes (csrc/vpu.cu
# msn_vpu_latency): float32, scalar bfloat16 (the ALU kernel's), bf16x2
# (the slab kernel's); sub is add's instruction
KINDS = ("f32", "bf16", "bf16x2")
OPS = ("mul", "add", "min", "max")
# start value, then y for mul (1), add (0), min (above) and max (below)
_PROBE_IN = [1.5, 1.0, 0.0, 4.0, -4.0]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def slab_inputs(dtype, device="cuda", seed: int | None = None):
    """(rows [128, 128] f32, six [ROWS, 128] planes ox oy oz ix iy iz of
    `dtype`). seed=None: the reference's, rows all 0.5 and plane i all
    0.1 (i + 1), which no child box test passes. A seed: origins in [-2,
    2), inverse directions 1/d with |d| in [0.05, 1), and per row and
    child either a box near the origins (lo in [-1.5, 0.5), hi = lo +
    [0.1, 1.5) per axis), which many lanes hit, or one 0.01 wide at
    distance 40-60, which no lane is likely to hit."""
    if seed is None:
        rows = torch.full((128, 128), 0.5, dtype=torch.float32, device=device)
        planes = [torch.full((ROWS, 128), 0.1 * (i + 1), device=device)
                  for i in range(6)]
    else:
        rs = np.random.RandomState(seed)
        rows_np = np.zeros((128, 128), np.float32)
        near = rs.rand(128, 1, CHILDREN) < 0.5
        lo = np.where(near, rs.uniform(-1.5, 0.5, (128, 3, CHILDREN)),
                      rs.uniform(40.0, 60.0, (128, 3, CHILDREN)))
        size = np.where(near, rs.uniform(0.1, 1.5, (128, 3, CHILDREN)), 0.01)
        rows_np[:, :24] = lo.reshape(128, 24)
        rows_np[:, 24:48] = (lo + size).reshape(128, 24)
        rows = torch.from_numpy(rows_np).to(device)
        o = rs.uniform(-2.0, 2.0, (3, ROWS, 128))
        d = rs.uniform(0.05, 1.0, (3, ROWS, 128)) * rs.choice([-1, 1],
                                                              (3, ROWS, 128))
        planes = [torch.from_numpy(x.astype(np.float32)).to(device)
                  for x in (*o, *(1.0 / d))]
    return rows, [p.to(dtype) for p in planes]


def alu_inputs(dtype, rows: int = ROWS, device="cuda",
               seed: int | None = None):
    """(a, b) of [rows, 128] `dtype`: the reference's 1.0 and 0.5, or with
    a seed a in [0.5, 2) and b in [0.25, 1)."""
    if seed is None:
        a = torch.full((rows, 128), 1.0, device=device)
        b = torch.full((rows, 128), 0.5, device=device)
    else:
        rs = np.random.RandomState(seed)
        a = torch.from_numpy(rs.uniform(0.5, 2.0, (rows, 128))
                             .astype(np.float32)).to(device)
        b = torch.from_numpy(rs.uniform(0.25, 1.0, (rows, 128))
                             .astype(np.float32)).to(device)
    return a.to(dtype), b.to(dtype)


# --- plain torch versions ---

def slab_plain(rows, planes, fma_form: bool, packed_any: bool,
               visits: int = VISITS) -> torch.Tensor:
    """The slab microbenchmark in torch ops, one visit per loop step: the
    8 children's box tests on every lane in the planes' dtype, compares in
    float32; returns the int32 count (per-child: visits x children with
    any lane hit; packed: the sum over visits of the max over lanes of the
    packed hit word)."""
    dt = planes[0].dtype
    o = [p.reshape(-1) for p in planes[:3]]
    inv = [p.reshape(-1) for p in planes[3:]]
    oinv = [o[c] * inv[c] for c in range(3)]
    prune = float(torch.finfo(dt).max)
    bit = (1 << torch.arange(CHILDREN, device=rows.device))[:, None]
    acc = torch.zeros((), dtype=torch.int64, device=rows.device)
    for v in range(visits):
        row = rows[v % 128].to(dt)
        lo = [row[c * CHILDREN:(c + 1) * CHILDREN, None] for c in range(3)]
        hi = [row[24 + c * CHILDREN:24 + (c + 1) * CHILDREN, None]
              for c in range(3)]
        if fma_form:
            t0 = [lo[c] * inv[c] - oinv[c] for c in range(3)]
            t1 = [hi[c] * inv[c] - oinv[c] for c in range(3)]
        else:
            t0 = [(lo[c] - o[c]) * inv[c] for c in range(3)]
            t1 = [(hi[c] - o[c]) * inv[c] for c in range(3)]
        tnear = torch.maximum(
            torch.maximum(torch.minimum(t0[0], t1[0]),
                          torch.minimum(t0[1], t1[1])),
            torch.minimum(t0[2], t1[2])).float()
        tfar = torch.minimum(
            torch.minimum(torch.maximum(t0[0], t1[0]),
                          torch.maximum(t0[1], t1[1])),
            torch.maximum(t0[2], t1[2])).float()
        hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= prune)  # [8, n]
        if packed_any:
            acc += (hit * bit).sum(0).max()
        else:
            acc += hit.any(1).sum()
    return acc.to(torch.int32)


def alu_plain(a, b, visits: int = VISITS) -> torch.Tensor:
    """The dependent ALU chain in torch ops, each op rounded to the
    dtype; constants rounded to the dtype first (JAX's weak typing)."""
    c = lambda x: torch.tensor(x, dtype=a.dtype, device=a.device)
    c_up, c_down, c_hi, c_lo = c(1.0000001), c(0.9999999), c(1.5), c(0.5)
    for _ in range(visits):
        a = a * b + a
        a = torch.minimum(a * c_up, a + b)
        a = torch.maximum(a - b, a * c_down)
        a = a * b + b
        a = torch.minimum(a, b * c_hi)
        a = torch.maximum(a, b * c_lo)
    return a


# --- CUDA wrappers ---

def _device_kind(x) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return kind


def slab(rows, planes, fma_form: bool, packed_any: bool,
         visits: int = VISITS, lib=None) -> torch.Tensor:
    """The slab microbenchmark: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns the int32 count. `lib`: another
    build of vpu.cu to launch instead (its launches are not counted)."""
    if (rows.dtype != torch.float32 or tuple(rows.shape) != (128, 128)
            or len(planes) != 6):
        raise ValueError("rows must be float32 [128, 128], with six planes")
    dt, n = planes[0].dtype, planes[0].numel()
    if dt not in _DTYPES or any(p.dtype != dt or p.numel() != n
                                or p.device != rows.device for p in planes):
        raise ValueError("planes must share one dtype (float32 or bfloat16), "
                         "size and device with rows")
    if _device_kind(rows) == "cpu":
        return slab_plain(rows, planes, fma_form, packed_any, visits)
    rows = rows.contiguous()
    if rows.data_ptr() % 16:  # the kernel reads rows as float4s
        rows = rows.clone()
    planes = [p.contiguous() for p in planes]
    out = torch.zeros(visits * (1 if packed_any else CHILDREN),
                      dtype=torch.int32, device=rows.device)
    rc = (lib or native.vpu_lib()).slab(
        rows.data_ptr(), *(p.data_ptr() for p in planes), n, visits,
        int(dt == torch.bfloat16), int(fma_form), int(packed_any),
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slab kernel launch failed: cudaError {rc}")
    if lib is None:
        LAUNCHES["vpu_slab"] += 1
    return out.sum(dtype=torch.int32)


def alu(a, b, visits: int = VISITS, lib=None) -> torch.Tensor:
    """The ALU chain: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. `lib` as for `slab`."""
    if (a.dtype not in _DTYPES or b.dtype != a.dtype or a.shape != b.shape
            or a.device != b.device):
        raise ValueError("a and b must share one dtype (float32 or "
                         "bfloat16), shape and device")
    if _device_kind(a) == "cpu":
        return alu_plain(a, b, visits)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    rc = (lib or native.vpu_lib()).alu(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), visits,
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ALU kernel launch failed: cudaError {rc}")
    if lib is None:
        LAUNCHES["vpu_alu"] += 1
    return out


# --- floors: the latency probe and an empty kernel ---

def _cuda_device(device):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes run on a CUDA device, not {device}")
    return device


def latency(kind: str, op: str, iters: int = 1 << 20,
            device="cuda") -> tuple[int, float]:
    """(clock64() cycles, ms) of one thread's chain of `iters` dependent
    `op`s of `kind` (KINDS, OPS); the ms are cuda_ms's mean of 3 launches,
    so cycles / ms gives the SM clock of this run."""
    device = _cuda_device(device)
    lib = native.vpu_lib()
    src = torch.tensor(_PROBE_IN, dtype=torch.float32, device=device)
    out = torch.empty(1, dtype=torch.float32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)

    def run():
        rc = lib.latency(KINDS.index(kind), OPS.index(op), src.data_ptr(),
                         out.data_ptr(), cycles.data_ptr(), iters,
                         torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"latency probe launch failed: cudaError {rc}")
    ms = cuda_ms(run, 3)
    return int(cycles.item()), ms


def latencies(device="cuda", iters: int = 1 << 20) -> tuple[dict, float]:
    """({kind: {op: cycles per op}}, SM clock in Hz) from one probe run of
    every kind and class; the clock is the probes' cycles over their
    event-timed ns, summed."""
    lat, cyc, sec = {}, 0, 0.0
    for kind in KINDS:
        lat[kind] = {}
        for op in OPS:
            c, ms = latency(kind, op, iters, device)
            lat[kind][op] = c / iters
            cyc, sec = cyc + c, sec + ms * 1e-3
    return lat, cyc / sec


def chain_floor_ms(lat: dict, hz: float, visits: int = VISITS) -> float:
    """The ALU chain's least time in ms: `visits` times the latency (in
    cycles, `lat` = {op: cycles}) of one iteration's critical path at `hz`.
    Per iteration: a*b + a (mul, add); min(a*c, a + b) and max(a - b, a*c)
    (the slower of mul and add, then min or max); a*b + b (mul, add); min
    and max with loop-invariant products."""
    m, a = lat["mul"], lat["add"]
    per_iter = 2 * m + 2 * a + 2 * max(m, a) + 2 * lat["min"] + 2 * lat["max"]
    return visits * per_iter / hz * 1e3


def empty_ms(device="cuda", reps: int = 100) -> float:
    """An empty kernel's time, timed as every kernel here is (cuda_ms)."""
    device = _cuda_device(device)
    lib = native.vpu_lib()
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        rc = lib.empty(stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")
    return cuda_ms(run, reps)


# --- entry point ---

def _runs(dev, seed):
    """(name, kind, make(lib) -> the call, plain) for the nine
    configurations on the reference's inputs (seed None) or seeded ones."""
    runs = []
    for name, dt, r in ALU_CONFIGS:
        ab = alu_inputs(dt, r, dev, seed=seed)
        runs.append((name, "alu", lambda lib, ab=ab: (lambda: alu(
            *ab, lib=lib)), lambda ab=ab: alu_plain(*ab)))
    for name, dt, fma_form, packed in SLAB_CONFIGS:
        rows, planes = slab_inputs(dt, dev, seed=seed)
        args = (rows, planes, fma_form, packed)
        runs.append((name, "slab", lambda lib, a=args: (lambda: slab(
            *a, lib=lib)), lambda a=args: slab_plain(*a)))
    return runs


def compare(checkouts) -> dict:
    """This checkout's kernels against each DIR's, alternated, on the
    reference's and seeded inputs; see the module's docstring."""
    dev = torch.device("cuda", 0)
    against = native.build_against(checkouts, ("vpu",))()["vpu"]
    libs = {"this": None, **against}
    labels = list(libs)
    result = {"device": torch.cuda.get_device_name(0), "labels": labels,
              "configs": [], "differs": []}
    for label in labels:
        print(f"{label}: " + native.ptxas_summary(
            (libs[label] or native.vpu_lib()).log))
    for seed in (None, SEED):
        inputs = "seeded" if seed is not None else "reference"
        for name, kind, make, plain in _runs(dev, seed):
            want = plain()
            fns = {label: make(libs[label]) for label in labels}
            for label in labels:
                got = fns[label]()
                same = (torch.equal(got, want) if kind == "alu"
                        else int(got) == int(want))
                if not same:
                    result["differs"].append([name, inputs, label])
            times = {label: [] for label in labels}
            for r in range(ROUNDS):
                for label in (labels if r % 2 == 0 else labels[::-1]):
                    times[label].append(cuda_ms(fns[label], REPS))
            ms = {label: sum(t) / len(t) for label, t in times.items()}
            result["configs"].append({"name": name, "inputs": inputs,
                                      "ms": ms, "rounds": times})
            print(f"{name:44s} {inputs:9s} " + "  ".join(
                f"{label} {ms[label]:.4f}" for label in labels), flush=True)
    # the slab wrapper's share: its output allocation and sum alone
    for packed in (False, True):
        n = VISITS * (1 if packed else CHILDREN)
        ms = cuda_ms(lambda: torch.zeros(n, dtype=torch.int32, device=dev)
                     .sum(dtype=torch.int32), REPS)
        result[f"wrapper_ms_{'packed' if packed else 'per_child'}"] = ms
        print(f"slab wrapper alone ({'packed' if packed else 'per-child'}, "
              f"{n} ints zeroed and summed): {ms:.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    """Times the reference's nine configurations at VISITS visits on the
    card (CUDA events, mean of 5 launches after a warm-up); prints one line
    each and returns {name: ms}. With --against, runs `compare` instead and
    returns its result."""
    ap = argparse.ArgumentParser(prog="profile_vpu")
    ap.add_argument("--against", action="extend", nargs="+", default=[],
                    metavar="DIR")
    args = ap.parse_args([] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_vpu needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    if args.against:
        return compare(args.against)
    dev = torch.device("cuda", 0)
    out = {}
    for name, _, make, _ in _runs(dev, None):
        ms = cuda_ms(make(None), 5)
        print(f"{name:44s} {ms:8.4f} ms  ({ms / VISITS * 1e3:6.4f} "
              f"us/visit)", flush=True)
        out[name] = ms
    return out


if __name__ == "__main__":
    result = main(sys.argv[1:])
    sys.exit(1 if result.get("differs") else 0)
