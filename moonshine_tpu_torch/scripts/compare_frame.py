"""The accumulation (csrc/frame.cu) and the loop's counts (csrc/shade.cu
`count_into`, folded into the surface and scatter kernels) at the main
path's launches, beside their plain versions, the one PyTorch call that
computes each, their bounds and other forms of each:

    python -m moonshine_tpu_torch.scripts.compare_frame [--rounds N]
        [--against DIR ...] [--accumulate-forms] [--count-forms]

The accumulation: the accumulate call of one eager room_1080p sample
(room_scene(grid=6, subdivisions=4) at 1920x1080, one env and one
mesh-light sample a bounce: 2,073,600 lanes, one sample a batch, the pix
of its last resort) is recorded (`record_accumulate`), and run on its
own radiance with its own pix and with a seeded permutation of as many
lanes through: the kernel as the wrapper launches it at one sample a
batch (each lane added at its pixel, one 16-byte access each way), the
two-pass form of the same entry point (the radiance scattered into
pixel order, then a coalesced pass: `two_pass`), the plain version,
`index_add_` over each lane's composed pixel index into a [bh, W, 3]
accumulator (`library_call`, the index made outside the timing) and
each `--against DIR`'s kernel (an earlier checkout whose accumulation
takes a [bh, W, 3] acc and no tally). Every output is held bit for bit
against the plain version's (one add a pixel: any order gives the same
bits). Each is timed with a cold L2 (compare_shade.time_inplace: 256 MiB
written before each launch), in rounds that alternate the order, beside
the byte bound (`accumulate_bytes`).

The counts: room_1080p's first full surface launch and first scatter
(compare_shade.record_sample) and offline_720p's at segment
compare_shade.OFFLINE_SEGMENT (compare_sort.offline_cell, the looped
form: its live prefix launched, few live), each kernel timed with its counter
and without (cold L2), the count held against the plain version's and
the torch sum of the kernel's own mask, and against 0 with every lane
dead. With `--count-forms`, each form of COUNT_FORMS whose body differs
from this checkout's `count_into` is spliced into a copy of shade.cu
under build/variants/ and built beside it, swapped in as the shading
library in turn, and timed the same way (the `block_nobarrier` form
reads its warps' sums without waiting for them: its time splits off the
barrier's cost, its count is not held).

Prints one line per measurement, then one JSON line; exits 1 if an
output or a count differs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

from moonshine_tpu_torch.accel import native
from moonshine_tpu_torch.scripts import compare_shade as CS

HD = (1080, 1920)
REPS = 10

# count_into's body in each form measured (`--count-forms`); each adds the
# block's values of v into *total, every thread of the block calling it
COUNT_FORMS = {
    # the earlier form: a warp sum, the warps' sums through shared
    # memory, one atomic a block
    "block": """
__device__ __forceinline__ void count_into(long long* total, int v) {
  __shared__ int warp_sums[kBlock / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kBlock / 32; ++w) sum += warp_sums[w];
    if (sum != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(total),
                (unsigned long long)sum);
  }
}
""",
    # the same without the barrier: wrong counts, the barrier's cost
    "block_nobarrier": """
__device__ __forceinline__ void count_into(long long* total, int v) {
  __shared__ int warp_sums[kBlock / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kBlock / 32; ++w) sum += warp_sums[w];
    if (sum != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(total),
                (unsigned long long)sum);
  }
}
""",
    # a warp sum and one atomic a warp, skipped where it is 0; no barrier
    "warp": """
__device__ __forceinline__ void count_into(long long* total, int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(total),
              (unsigned long long)v);
}
""",
    # per-block partials, an atomic ticket a block, and the last block
    # sums the partials and writes the one scalar
    "ticket": """
__device__ int msn_count_partials[1 << 16];
__device__ unsigned msn_count_ticket;

__device__ __forceinline__ void count_into(long long* total, int v) {
  __shared__ int warp_sums[kBlock / 32];
  __shared__ long long block_sums[kBlock / 32];
  __shared__ bool last;
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (gridDim.x > (1u << 16)) {  // more blocks than partials: atomics
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kBlock / 32; ++w) sum += warp_sums[w];
      if (sum != 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(total),
                  (unsigned long long)sum);
    }
    return;
  }
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kBlock / 32; ++w) sum += warp_sums[w];
    msn_count_partials[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(&msn_count_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  long long s = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kBlock)
    s += ((volatile int*)msn_count_partials)[b];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) block_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < kBlock / 32; ++w) sum += block_sums[w];
    *total += sum;
    msn_count_ticket = 0;
  }
}
""",
}
# the accumulation's reads and its add in each form measured
# (`--accumulate-forms`): each replaces the functions of frame.cu it
# defines (lane_pix, the 3-float lane_row, add_at: acc's pixel *a += s,
# one add a pixel)
ADD_FORMS = {
    # plain loads of pix and the radiance; a 16-byte load and a 16-byte
    # store of acc
    "load_store": """
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return pix[t];
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  return load3(src + 3 * (long long)i);
}
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  float4 v = *a;
  v.x = v.x + s.x;
  v.y = v.y + s.y;
  v.z = v.z + s.z;
  *a = v;
}
""",
    # pix and the radiance read evict-first (ld.global.cs), so that they
    # pass through the L2 without evicting acc's sectors
    "stream_in": """
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return __ldcs(pix + t);
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  const float* p = src + 3 * (long long)i;
  return v3(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2));
}
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  float4 v = *a;
  v.x = v.x + s.x;
  v.y = v.y + s.y;
  v.z = v.z + s.z;
  *a = v;
}
""",
    # stream_in, and acc's load and store under an L2 evict-last policy
    "stream_keep": """
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return __ldcs(pix + t);
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  const float* p = src + 3 * (long long)i;
  return v3(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2));
}
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  unsigned long long keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  float4 v;
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(a), "l"(keep));
  v.x = v.x + s.x;
  v.y = v.y + s.y;
  v.z = v.z + s.z;
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(keep)
               : "memory");
}
""",
    # acc's first 3 / 4 held 3 floats a pixel (a [bh, W, 3] layout), pix
    # and radiance as stream_in: an 8-byte and a 4-byte access each way
    # (a pixel's 12 bytes start 8-byte aligned at even pixels)
    "wide3_split": """
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return __ldcs(pix + t);
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  const float* p = src + 3 * (long long)i;
  return v3(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2));
}
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float* f = reinterpret_cast<float*>(acc) + 3 * (long long)p;
  if (p & 1) {
    float2* yz = reinterpret_cast<float2*>(f + 1);
    const float x = f[0];
    const float2 v = *yz;
    f[0] = x + s.x;
    *yz = make_float2(v.x + s.y, v.y + s.z);
  } else {
    float2* xy = reinterpret_cast<float2*>(f);
    const float2 v = *xy;
    const float z = f[2];
    *xy = make_float2(v.x + s.x, v.y + s.y);
    f[2] = z + s.z;
  }
}
""",
    # the same 3-float layout, three 4-byte accesses each way
    "wide3_scalar": """
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return __ldcs(pix + t);
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  const float* p = src + 3 * (long long)i;
  return v3(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2));
}
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float* f = reinterpret_cast<float*>(acc) + 3 * (long long)p;
  f[0] = f[0] + s.x;
  f[1] = f[1] + s.y;
  f[2] = f[2] + s.z;
}
""",
    # one 16-byte atomic add (sm_90), 0 added to the 4th float
    "red_v4": """
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  atomicAdd(acc + p, make_float4(s.x, s.y, s.z, 0.0f));
}
""",
    # an 8-byte and a 4-byte atomic add, the 4th float untouched
    "red_v2_1": """
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  atomicAdd(reinterpret_cast<float2*>(a), make_float2(s.x, s.y));
  atomicAdd(&a->z, s.z);
}
""",
    # three 4-byte atomic adds (index_add_'s, on the 4-float layout)
    "red3": """
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  atomicAdd(&a->x, s.x);
  atomicAdd(&a->y, s.y);
  atomicAdd(&a->z, s.z);
}
""",
}
FN_NAME = re.compile(r"__device__ __forceinline__ [^(\n]*?\b(\w+)\(")


def function(name: str, first: str = ""):
    """A regex for the definition of device function NAME (whose first
    parameter's text starts with `first`), up to its closing brace at the
    start of a line."""
    return re.compile(r"__device__ __forceinline__ [^(\n]*?\b" + name
                      + r"\(" + re.escape(first) + r".*?\n}\n", re.S)


def splice(src: str, fragment: str) -> str:
    """src with each device function that `fragment` defines replaced by
    the fragment's (matched by name and first parameter's type), and any
    other text of the fragment (declarations) put before the first."""
    out, rest, first_at = src, fragment.strip() + "\n", None
    for m in FN_NAME.finditer(fragment):
        name = m.group(1)
        params = fragment[m.end():].split(",")[0].split(")")[0]
        own = function(name, params.split("*")[0]
                       + ("*" if "*" in params else ""))
        body = own.search(fragment).group(0)
        rest = rest.replace(body, "")
        hit = own.search(out)
        if hit is None:
            raise ValueError(f"{name}({params}...) is not in the source")
        first_at = hit.start() if first_at is None else min(first_at,
                                                            hit.start())
        out = out[:hit.start()] + body + out[hit.end():]
    if rest.strip():
        out = out[:first_at] + rest.strip() + "\n\n" + out[first_at:]
    return out


def accumulate_bytes(n: int, bh: int, width: int, pix: bool) -> int:
    """The accumulation's least bytes: each lane's radiance (and pix) read
    once, each pixel's three floats of acc read and written once."""
    return n * 12 + (n * 8 if pix else 0) + bh * width * 24


def record_accumulate(scene, lens, cfg, sample: int = 7):
    """(acc shape, radiance, pix, nbatch) of the accumulate call of one
    eager 1080p sample, cloned at the call."""
    import torch

    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.render import frame_kernels as FK
    from moonshine_tpu_torch.render.renderer import render_spp

    rec, real = [], FK.accumulate

    def spy(acc, radiance, pix, nbatch, tally=None):
        if not rec:
            rec.append((tuple(acc.shape), radiance.clone(),
                        None if pix is None else pix.clone(), nbatch))
        return real(acc, radiance, pix, nbatch, tally)

    FK.accumulate = spy
    try:
        with graphs.eager():
            render_spp(scene, lens, HD[0], HD[1], sample, 1, cfg)
    finally:
        FK.accumulate = real
    torch.cuda.synchronize()
    return rec[0]


def pixel_index(bh: int, width: int, pix, device):
    """Each lane's row-major pixel in [bh, W]: its pixel lane (pix, or the
    lane itself) composed with the lane order's pixel."""
    from moonshine_tpu_torch.render import frame_kernels as FK

    py, px, _ = FK._pixel_coords(bh, width, device)
    flat = py * width + px
    return flat if pix is None else flat[pix]


def library_call(acc3, radiance, index):
    """One `index_add_` of the radiance at each lane's pixel into acc3
    [bh, W, 3] (one sample a batch)."""
    flat = acc3.view(-1, 3)
    return lambda: flat.index_add_(0, index, radiance)


def two_pass(acc, radiance, pix):
    """The accumulation's two-pass form at one sample a batch: the
    radiance scattered into pixel order, then the coalesced pass."""
    import torch

    from moonshine_tpu_torch.render import frame_kernels as FK

    scratch = torch.empty((radiance.shape[0], 4), dtype=torch.float32,
                          device=radiance.device)
    return lambda: FK._accumulate_launch(acc, radiance, pix, 1, scratch,
                                         None)


def earlier_accumulate(lib, acc3, radiance, pix):
    """An earlier checkout's accumulation (acc [bh, W, 3], no tally) at
    one sample a batch."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    fn = lib._lib.msn_frame_accumulate
    fn.argtypes, fn.restype = [_P, _P, _I, _I, _I, _P, _P, _P], _I
    bh, width = acc3.shape[0], acc3.shape[1]

    def run():
        rc = CS.native_call(fn, acc3.device, radiance.data_ptr(),
                            None if pix is None else pix.data_ptr(), 1, bh,
                            width, None, acc3.data_ptr())
        if rc != 0:
            raise RuntimeError(f"earlier accumulate: cudaError {rc}")
    return run


def held_as(form: str, acc, bh: int, width: int):
    """acc's pixels as [bh, W, 3] in the form's layout: the first 3 / 4 of
    the buffer for the wide3 forms, the first three floats of each pixel
    for the others."""
    if form.startswith("wide3"):
        return acc.view(-1)[:bh * width * 3].view(bh, width, 3)
    return acc[..., :3]


def bits_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def accumulate_cases(rec, seed: int = 5):
    """{label: (radiance, pix)}: the recorded call's own pix and a seeded
    permutation of as many lanes."""
    import torch

    shape, rad, pix, nb = rec
    gen = torch.Generator(device=rad.device)
    gen.manual_seed(seed)
    return {"own pix": (rad, pix),
            "seeded pix": (rad, torch.randperm(rad.shape[0], generator=gen,
                                               device=rad.device))}


def with_lib(name: str, lib, fn):
    """fn, called with `lib` loaded as library NAME (as its wrappers find
    it: accel/native.py `_lib`)."""
    def run():
        native._LOADED[name] = lib
        return fn()
    return run


def subnormal_case(dev, n: int = 8192, width: int = 128):
    """(acc [n / width, width, 4], radiance [n, 3], pix): seeded values
    with every fourth subnormal (float32's smallest normal is 1.2e-38),
    signs mixed, under a seeded permutation; scanline."""
    import numpy as np
    import torch

    rs = np.random.RandomState(17)
    sign = lambda *shape: np.where(rs.rand(*shape) < 0.5, -1.0, 1.0)
    acc = rs.rand(n // width, width, 4) * sign(n // width, width, 4)
    rad = rs.rand(n, 3) * sign(n, 3)
    acc[::4] *= 1e-39
    rad[::4] *= 1e-39
    put = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    return (put(acc), put(rad),
            torch.from_numpy(rs.permutation(n)).to(dev))


def compare_accumulate(rec, frame_libs, against, rounds, bad,
                       result) -> None:
    """The recorded accumulation (`accumulate_cases`) through each library
    of `frame_libs` ({label: FrameLib}, "this" first), this one's
    two-pass form, the plain version, `index_add_` and each earlier
    checkout's kernel of `against`: held bit for bit, timed with a cold
    L2 in rounds that alternate the order. Each library is also held on
    subnormal inputs (`subnormal_case`)."""
    import torch

    from moonshine_tpu_torch.render import frame_kernels as FK

    shape, _, _, nb = rec
    bh, width = shape[0], shape[1]
    dev = rec[1].device
    own = native._LOADED["frame"]
    acc, rad, pix = subnormal_case(dev)
    want = acc.clone()
    FK.accumulate_plain(want, rad, pix, 1)
    for label, lib in frame_libs.items():
        got = acc.clone()
        if label.startswith("wide3"):
            held_as(label, got, *acc.shape[:2]).copy_(acc[..., :3])
        with_lib("frame", lib, lambda: FK.accumulate(got, rad, pix, 1))()
        same = bits_equal(held_as(label, got, *acc.shape[:2]),
                          want[..., :3])
        print(f"accumulate {label} on subnormal inputs: bit for bit "
              f"{same}", flush=True)
        if not same:
            bad.append(f"accumulate {label}: subnormal inputs")
    native._LOADED["frame"] = own
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    acc0 = torch.rand((bh, width, 4), generator=gen, device=dev)
    for label, (rad, pix) in accumulate_cases(rec).items():
        n = rad.shape[0]
        want = acc0.clone()
        FK.accumulate_plain(want, rad, pix, nb)
        runs, diffs = {}, []
        for name, lib in frame_libs.items():
            got = acc0.clone()
            if name.startswith("wide3"):
                held_as(name, got, bh, width).copy_(acc0[..., :3])
            run = with_lib("frame", lib, lambda got=got: FK.accumulate(
                got, rad, pix, nb))
            run()
            if not bits_equal(held_as(name, got, bh, width),
                              want[..., :3]):
                diffs.append(name)
            runs[name] = run
        got = acc0.clone()
        runs["two_pass"] = with_lib("frame", own, two_pass(got, rad, pix))
        runs["two_pass"]()
        if not bits_equal(got, want):
            diffs.append("two_pass")
        lib3 = acc0[..., :3].contiguous()
        runs["index_add_"] = library_call(lib3, rad, pixel_index(
            bh, width, pix, dev))
        runs["index_add_"]()
        if not bits_equal(lib3, want[..., :3]):
            diffs.append("index_add_")
        plain = acc0.clone()
        runs["plain"] = lambda: FK.accumulate_plain(plain, rad, pix, nb)
        for name, lib in against.items():
            acc3 = acc0[..., :3].contiguous()
            runs[name] = earlier_accumulate(lib, acc3, rad, pix)
            runs[name]()
            if not bits_equal(acc3, want[..., :3]):
                diffs.append(name)
        ms = {k: [] for k in runs}
        for r in range(rounds):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for k in order:
                ms[k].append(CS.time_inplace(runs[k], [], [], REPS))
        native._LOADED["frame"] = own
        nbytes = accumulate_bytes(n, bh, width, pix is not None)
        bound = nbytes / CS.PEAK_BYTES * 1e3
        print(f"accumulate room_1080p {label} ({n} lanes, {nb} a batch): "
              + ", ".join(f"{k} {min(v):.4f} ms (rounds "
                          f"{', '.join(f'{x:.4f}' for x in v)})"
                          for k, v in ms.items())
              + f"; bound {bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB)"
              + ("; outputs held bit for bit" if not diffs else
                 "; DIFFER: " + ", ".join(diffs)), flush=True)
        if diffs:
            bad.append(f"accumulate {label}: " + ", ".join(diffs))
        result["accumulate"][label] = {"ms": ms, "n": n, "bound_ms": bound}


def variant_dirs(name: str, forms: dict) -> dict:
    """{form: a checkout directory under build/variants/ whose csrc/NAME.cu
    is this one's with the form's functions spliced in (`splice`)}, for
    each form of `forms` that changes this checkout's source."""
    src = native.SOURCES[name].read_text()
    out = {}
    for form, fragment in forms.items():
        text = splice(src, fragment)
        if text == src:
            continue
        root = native.BUILD_DIR / "variants" / f"{name}_{form}"
        csrc = root / "moonshine_tpu_torch" / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / native.SOURCES[name].name).write_text(text)
        out[form] = root
    return out


def count_launches(dev):
    """{label: {key: (name, args, kw)}}: room_1080p's first full surface
    launch and scatter, and offline_720p's at OFFLINE_SEGMENT."""
    import warnings

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts.compare_sort import offline_cell

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    world, lens = procedural.room_scene(grid=6, subdivisions=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene = world.build(dev)
    out = {"room_1080p": CS.record_sample(
        scene, LensArrays.from_lens(lens, dev), cfg)}
    with CS.recording(CS.OFFLINE_SEGMENT) as rec:
        offline_cell(dev)(0)
    if "scatter" not in rec:
        raise AssertionError(f"offline_720p's sample ran fewer than "
                             f"{CS.OFFLINE_SEGMENT + 1} segments")
    out[f"offline_720p segment {CS.OFFLINE_SEGMENT}"] = rec
    return out


# (recorded key, its counter, the mask it counts, the argument index of
# the lanes live on entry)
COUNTED = (("surface/full", "rays", lambda out: out.shadow.lane, 6),
           ("scatter", "live", lambda out: out["active"], 6))


def count_of(key, args, kw, dead: bool = False):
    """(the kernel's count, the plain version's, the torch sum of the
    kernel's own mask, the mask) of a recorded call, on fresh copies;
    `dead`: with every lane's mask cleared first."""
    import torch

    from moonshine_tpu_torch.integrator import shade

    name = key.split("/")[0]
    counter, mask_of, at = next((c, m, a) for k, c, m, a in COUNTED
                                if k == key)
    args = CS.fresh(name, args)
    if dead:
        args = args[:at] + (torch.zeros_like(args[at]),) + args[at + 1:]
    mine, ref = CS.clone(kw), CS.clone(kw)
    mine[counter].zero_()
    ref[counter].zero_()
    out = getattr(shade, name)(*CS.fresh(name, args), **mine)
    getattr(shade, f"{name}_plain")(*CS.fresh(name, args), **ref)
    mask = mask_of(out)
    return int(mine[counter]), int(ref[counter]), int(mask.sum()), mask


def time_counts(key, args, kw, rounds: int):
    """(min ms with the counter, min ms without) of a recorded launch
    (cold L2, its in-place inputs restored before each launch)."""
    from moonshine_tpu_torch.integrator import shade

    name = key.split("/")[0]
    counter = next(c for k, c, _, _ in COUNTED if k == key)
    kernel = getattr(shade, name)
    work = CS.fresh(name, args)
    bare = {k: v for k, v in kw.items() if k != counter}
    with_, without = [], []
    for _ in range(rounds):
        with_.append(CS.time_inplace(CS.call(kernel, work, CS.clone(kw)),
                                     work, args, REPS))
        without.append(CS.time_inplace(CS.call(kernel, work, bare), work,
                                       args, REPS))
    return min(with_), min(without)


def compare_counts(launches, libs, rounds, bad, result) -> None:
    """Each library of `libs` ({label: ShadeLib}) swapped in as the
    shading library: each recorded launch's count held (not for
    block_nobarrier) and timed with and without its counter."""
    own = native._LOADED.get("shade")
    try:
        for label, lib in libs.items():
            native._LOADED["shade"] = lib
            for cell, rec in launches.items():
                cost = 0.0
                for key, *_ in COUNTED:
                    name, args, kw = rec[key]
                    got, plain, summed, mask = count_of(key, args, kw)
                    size = mask.numel()
                    dead = count_of(key, args, kw, dead=True)[:3]
                    exact = got == plain == summed and dead == (0, 0, 0)
                    w, wo = time_counts(key, args, kw, rounds)
                    cost += w - wo
                    print(f"counts {label} {cell} {key} (a mask of {size}):"
                          f" kernel {got}, plain {plain}, torch sum "
                          f"{summed}, every lane dead {dead}; with its "
                          f"counter {w:.4f} ms, without {wo:.4f} ms",
                          flush=True)
                    if not exact and label != "block_nobarrier":
                        bad.append(f"counts {label} {cell} {key}")
                    result["counts"].setdefault(label, {})[
                        f"{cell} {key}"] = {"count": got, "plain": plain,
                                            "sum": summed, "dead": dead,
                                            "with_ms": w, "without_ms": wo}
                print(f"counts {label} {cell}: counted - uncounted "
                      f"{cost:.4f} ms a segment", flush=True)
                result["counts"][label][f"{cell} cost_ms"] = cost
    finally:
        if own is not None:
            native._LOADED["shade"] = own


def main(argv=None) -> int:
    import torch

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene import procedural

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", action="append", default=[],
                    help="an earlier checkout whose frame.cu runs beside")
    ap.add_argument("--accumulate-forms", action="store_true",
                    help="time the accumulation's other forms (ADD_FORMS)")
    ap.add_argument("--count-forms", action="store_true",
                    help="time count_into's other forms (COUNT_FORMS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_frame needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    add_dirs = (variant_dirs("frame", ADD_FORMS)
                if args.accumulate_forms else {})
    count_dirs = (variant_dirs("shade", COUNT_FORMS)
                  if args.count_forms else {})
    load_frame = native.build_against(
        [*args.against, *map(str, add_dirs.values())], ("frame",))
    load_shade = native.build_against([str(d) for d in count_dirs.values()],
                                      ("shade",))
    frames, shades = load_frame()["frame"], load_shade()["shade"]
    named = lambda d: pathlib.Path(d).resolve().name
    against = {named(d): frames[named(d)] for d in args.against
               if named(d) in frames}
    frame_libs = {"this": native.frame_lib(), **{
        form: frames[named(d)] for form, d in add_dirs.items()}}
    shade_libs = {"this": native.shade_lib(), **{
        form: shades[named(d)] for form, d in count_dirs.items()}}
    for kind, libs in (("frame", {**frame_libs, **against}),
                       ("shade", shade_libs)):
        for label, lib in libs.items():
            print(f"{kind} {label}: {lib.path.name}, built in "
                  f"{lib.build_seconds:.1f} s; ptxas: "
                  f"{native.ptxas_summary(lib.log)}", flush=True)
    dev = torch.device("cuda", 0)
    bad, result = [], {"card": smi, "accumulate": {}, "counts": {}}

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    world, lens = procedural.room_scene(grid=6, subdivisions=4)
    scene = world.build(dev)
    rec = record_accumulate(scene, LensArrays.from_lens(lens, dev), cfg)
    if rec[2] is None or rec[3] != 1:
        raise AssertionError("room_1080p's accumulation ran without pix or "
                             "with several samples a batch")
    compare_accumulate(rec, frame_libs, against, args.rounds, bad, result)
    del rec, scene
    compare_counts(count_launches(dev), shade_libs, args.rounds, bad,
                   result)
    result["mismatch"] = bad
    print(json.dumps(result), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
