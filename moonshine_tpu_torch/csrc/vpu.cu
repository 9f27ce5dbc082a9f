// Arithmetic microbenchmarks of the traversal's child test, for Hopper
// (sm_90a), in float32 and bfloat16, and the probes that give their floors.
//
// Replace the two Pallas TPU kernels of scripts/profile_vpu.py:
//   slab  (_mk_slab, pallas_call at :101): `visits` simulated 8-child
//         internal visits over 8192 lanes, each child's bounds read from
//         row v % 128 of a 128 x 128 float32 table (lo at column c*8 + j,
//         hi at 24 + c*8 + j), in sub-mul form `(b - o) * inv` or
//         FMA-shaped form `b * inv - o*inv`; per visit either one "any
//         lane hit" per child (per-child) or the max over lanes of one
//         8-bit packed hit word (packed). Returns the reference's int32
//         sum over visits.
//   alu   (_mk_alu, pallas_call at :137): `visits` iterations of the
//         reference's dependent mul/min/max/add chain per element.
//
// What bounds the slab test on this card: issue. Each lane does 25
// operations per child and visit, none of them a fused multiply-add (12
// sub/mul, 10 min/max, 3 compares), and the min/max and compares do not
// issue at the full float32 rate; the table (64 KB) and the lanes (6
// planes of 8192) are a few hundred KB. The visits are independent and
// the count is a sum over them, so the design spreads them over the card:
// block (x, y) holds a tile of kBlock * kSlots lane slots (a slot is one
// float32 lane, or two bfloat16 lanes as a __nv_bfloat162 that every
// mul/sub/min/max does at once) in registers, and walks chunk y of the
// visits; the host sizes the chunks so that one wave of blocks fills every
// SM, at most kMaxChunk visits each. The rows of its chunk sit in shared
// memory (bfloat16: each value rounded once and duplicated into both
// halves), read per visit as 12 float4 broadcasts. Each warp votes once
// per child (__any_sync, per-child form) or takes one __reduce_max_sync of
// its lanes' packed words (packed form); lane 0 folds the warp's result
// into a shared word per visit, and at the chunk's end the block writes
// each visit's result once to device memory (a 1 per hit child, or an
// atomicMax of the word). The wrapper sums that array.
//
// The ALU chain is one dependent chain per element, 10 operations deep
// per iteration: its least time is that chain's latency (the probe below
// measures each operation's), not the card's issue rate. So one thread an
// element, blocks of kAluBlock, and the loop unrolled kAluUnroll times,
// which keeps the loop's own instructions off the chain. On an H100 the
// kernel took the same time on one warp as on 8192 elements; two
// bfloat16 elements a thread as a __nv_bfloat162 ran slower.
//
// Numerics: in bfloat16 every min/max/mul/add/sub rounds to bfloat16
// (cuda_bf16.h intrinsics, round to nearest even, each half of a
// __nv_bfloat162 as the scalar op rounds it; a float32 operation rounded
// to bfloat16 gives the same value, as torch's bfloat16 ops compute it)
// and the slab's compares are float32, as the reference does them. Built
// with -fmad=false: no multiply-add is contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChildren = 8;
constexpr int kRowWords = 48;     // columns 0..47 of a row are read
constexpr int kRowQuads = kRowWords / 4;
// slab kernel: threads a block, lane slots a thread, minimum resident
// blocks an SM, most visits a block walks (one shared word each)
constexpr int kBlock = 256;
constexpr int kSlots = 4;
constexpr int kMinBlocks = 2;
constexpr int kMaxChunk = 256;
// ALU kernel: threads a block, loop unrolling
constexpr int kAluBlock = 128;
constexpr int kAluUnroll = 16;

// one lane slot as float32
struct F32 {
  using T = float;  // what a slot holds
  using S = float;  // an element of a plane
  static constexpr int kWidth = 1;
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T mn(T a, T b) { return fminf(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ T from(float x) { return x; }
  static __device__ __forceinline__ uint4 stage(float4 q) {
    return make_uint4(__float_as_uint(q.x), __float_as_uint(q.y),
                      __float_as_uint(q.z), __float_as_uint(q.w));
  }
  static __device__ __forceinline__ T pick(unsigned w) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ T load(const S* p, int i, int n) {
    return i < n ? p[i] : 0.0f;
  }
  static __device__ __forceinline__ unsigned live(int i, int n) {
    return i < n ? 1u : 0u;
  }
  // bit w: lane w of the slot passes the float32 compares
  static __device__ __forceinline__ unsigned hits(T tn, T tf) {
    return (tn <= tf && tf >= 0.0f && tn <= FLT_MAX) ? 1u : 0u;
  }
};

__device__ __forceinline__ __nv_bfloat16 bf16_max_value() {
  return __ushort_as_bfloat16((unsigned short)0x7F7F);
}

// one element as a scalar bfloat16 (the ALU kernel's)
struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T mul(T a, T b) { return __hmul(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub(a, b); }
  static __device__ __forceinline__ T mn(T a, T b) { return __hmin(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __hmax(a, b); }
  static __device__ __forceinline__ T from(float x) {
    return __float2bfloat16_rn(x);
  }
};

// two lanes as one __nv_bfloat162
struct BF16x2 {
  using T = __nv_bfloat162;
  using S = __nv_bfloat16;
  static constexpr int kWidth = 2;
  static __device__ __forceinline__ T mul(T a, T b) { return __hmul2(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd2(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub2(a, b); }
  static __device__ __forceinline__ T mn(T a, T b) { return __hmin2(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __hmax2(a, b); }
  static __device__ __forceinline__ T from(float x) {
    return __float2bfloat162_rn(x);
  }
  static __device__ __forceinline__ unsigned bits(T x) {
    unsigned w;
    memcpy(&w, &x, sizeof w);
    return w;
  }
  static __device__ __forceinline__ uint4 stage(float4 q) {
    return make_uint4(bits(from(q.x)), bits(from(q.y)), bits(from(q.z)),
                      bits(from(q.w)));
  }
  static __device__ __forceinline__ T pick(unsigned w) {
    T x;
    memcpy(&x, &w, sizeof w);
    return x;
  }
  // slot i holds elements 2i and 2i + 1; read one at a time (a plane may
  // start on an odd element); missing ones are 0
  static __device__ __forceinline__ T load(const S* p, int i, int n) {
    const S zero = __float2bfloat16_rn(0.0f);
    return __halves2bfloat162(2 * i < n ? p[2 * i] : zero,
                              2 * i + 1 < n ? p[2 * i + 1] : zero);
  }
  static __device__ __forceinline__ unsigned live(int i, int n) {
    return (2 * i < n ? 1u : 0u) | (2 * i + 1 < n ? 2u : 0u);
  }
  static __device__ __forceinline__ unsigned hits(T tn, T tf) {
    const float prune = __bfloat162float(bf16_max_value());
    const float n0 = __low2float(tn), f0 = __low2float(tf);
    const float n1 = __high2float(tn), f1 = __high2float(tf);
    return ((n0 <= f0 && f0 >= 0.0f && n0 <= prune) ? 1u : 0u) |
           ((n1 <= f1 && f1 >= 0.0f && n1 <= prune) ? 2u : 0u);
  }
};

// One visit of one warp: the 8 children of `row` (12 quads in shared
// memory) against the thread's kSlots slots. a/b are (o, inv) in sub-mul
// form and (o * inv, inv) in FMA form. Returns the warp's result, the same
// in every lane: bit j set if any lane hit child j (per-child), or the max
// over lanes of the packed hit words (packed).
template <class Op, bool FmaForm, bool Packed>
__device__ __forceinline__ unsigned visit(
    const uint4* row, const typename Op::T (&a)[kSlots][3],
    const typename Op::T (&b)[kSlots][3], const unsigned (&live)[kSlots]) {
  using T = typename Op::T;
  constexpr int kW = Op::kWidth;
  unsigned anymask = 0;
  unsigned word[kSlots * kW];
#pragma unroll
  for (int k = 0; k < kSlots * kW; ++k) word[k] = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // quad c * 2 + h: columns c*8 + 4h .. c*8 + 4h + 3, children 4h..4h+3
    // of coordinate c (0-2 lo x y z, 3-5 hi x y z)
    uint4 q[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) q[c] = row[c * 2 + h];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = h * 4 + jj;
      T lo[3], hi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint4 l = q[c], u = q[3 + c];
        lo[c] = Op::pick(jj == 0 ? l.x : jj == 1 ? l.y : jj == 2 ? l.z : l.w);
        hi[c] = Op::pick(jj == 0 ? u.x : jj == 1 ? u.y : jj == 2 ? u.z : u.w);
      }
      unsigned any = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        T t0[3], t1[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (FmaForm) {
            t0[c] = Op::sub(Op::mul(lo[c], b[s][c]), a[s][c]);
            t1[c] = Op::sub(Op::mul(hi[c], b[s][c]), a[s][c]);
          } else {
            t0[c] = Op::mul(Op::sub(lo[c], a[s][c]), b[s][c]);
            t1[c] = Op::mul(Op::sub(hi[c], a[s][c]), b[s][c]);
          }
        }
        const T tnear =
            Op::mx(Op::mx(Op::mn(t0[0], t1[0]), Op::mn(t0[1], t1[1])),
                   Op::mn(t0[2], t1[2]));
        const T tfar =
            Op::mn(Op::mn(Op::mx(t0[0], t1[0]), Op::mx(t0[1], t1[1])),
                   Op::mx(t0[2], t1[2]));
        const unsigned hit = Op::hits(tnear, tfar) & live[s];
        if (Packed) {
#pragma unroll
          for (int w = 0; w < kW; ++w) word[s * kW + w] |= ((hit >> w) & 1u) << j;
        } else {
          any |= hit;
        }
      }
      if (!Packed) anymask |= (__any_sync(kFull, any != 0) ? 1u : 0u) << j;
    }
  }
  if (!Packed) return anymask;
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kSlots * kW; ++k) m = max(m, word[k]);
  return __reduce_max_sync(kFull, m);
}

template <class Op, bool FmaForm, bool Packed>
__global__ void __launch_bounds__(kBlock, kMinBlocks) slab_kernel(
    const float* __restrict__ rows, const typename Op::S* __restrict__ ox,
    const typename Op::S* __restrict__ oy,
    const typename Op::S* __restrict__ oz,
    const typename Op::S* __restrict__ ix,
    const typename Op::S* __restrict__ iy,
    const typename Op::S* __restrict__ iz, int lanes, int visits, int chunk,
    int* __restrict__ out) {
  using T = typename Op::T;
  __shared__ uint4 s_rows[128 * kRowQuads];
  __shared__ unsigned s_red[kMaxChunk];
  const int v0 = blockIdx.y * chunk;
  const int nv = min(visits - v0, chunk);  // chunk <= kMaxChunk

  // the rows this chunk reads (all 128 once it spans that many visits)
  const int nrows = min(nv, 128);
  for (int k = threadIdx.x; k < nrows * kRowQuads; k += kBlock) {
    const int r = (v0 + k / kRowQuads) & 127, c = k % kRowQuads;
    s_rows[r * kRowQuads + c] = Op::stage(
        __ldg(reinterpret_cast<const float4*>(rows + r * 128) + c));
  }
  for (int k = threadIdx.x; k < nv; k += kBlock) s_red[k] = 0;

  // slot s of thread t: slot index (blockIdx.x * kSlots + s) * kBlock + t;
  // padding lanes are 0 and never hit. Every thread takes part in the votes
  T a[kSlots][3], b[kSlots][3];
  unsigned live[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = (blockIdx.x * kSlots + s) * kBlock + threadIdx.x;
    const T o[3] = {Op::load(ox, i, lanes), Op::load(oy, i, lanes),
                    Op::load(oz, i, lanes)};
    const T inv[3] = {Op::load(ix, i, lanes), Op::load(iy, i, lanes),
                      Op::load(iz, i, lanes)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[s][c] = FmaForm ? Op::mul(o[c], inv[c]) : o[c];
      b[s][c] = inv[c];
    }
    live[s] = Op::live(i, lanes);
  }
  const bool lead = (threadIdx.x & 31) == 0;
  __syncthreads();  // the staged rows and zeroed words before their use

  for (int k = 0; k < nv; ++k) {
    const unsigned m = visit<Op, FmaForm, Packed>(
        s_rows + ((v0 + k) & 127) * kRowQuads, a, b, live);
    if (lead && m != 0) {
      if (Packed) {
        atomicMax(s_red + k, m);
      } else {
        atomicOr(s_red + k, m);
      }
    }
  }
  __syncthreads();
  if (Packed) {
    for (int k = threadIdx.x; k < nv; k += kBlock) {
      if (s_red[k] != 0) atomicMax(out + v0 + k, (int)s_red[k]);
    }
  } else {
    for (int k = threadIdx.x; k < nv * kChildren; k += kBlock) {
      if ((s_red[k / kChildren] >> (k % kChildren)) & 1u) {
        out[v0 * kChildren + k] = 1;  // every writer writes 1
      }
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kAluBlock) alu_kernel(
    const typename Op::T* __restrict__ a_in,
    const typename Op::T* __restrict__ b_in, typename Op::T* __restrict__ out,
    int n, int visits) {
  using T = typename Op::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T a = a_in[i];
  const T b = b_in[i];
  // constants round to the working type first, as JAX rounds its
  // weak-typed scalars (1.0000001 and 0.9999999 are 1.0 in bfloat16)
  const T c_up = Op::from(1.0000001f), c_down = Op::from(0.9999999f);
  const T c_hi = Op::from(1.5f), c_lo = Op::from(0.5f);
#pragma unroll kAluUnroll
  for (int v = 0; v < visits; ++v) {
    a = Op::add(Op::mul(a, b), a);
    a = Op::mn(Op::mul(a, c_up), Op::add(a, b));
    a = Op::mx(Op::sub(a, b), Op::mul(a, c_down));
    a = Op::add(Op::mul(a, b), b);
    a = Op::mn(a, Op::mul(b, c_hi));
    a = Op::mx(a, Op::mul(b, c_lo));
  }
  out[i] = a;
}

// the chunk of visits each block walks: one wave of blocks over the card,
// (lanes / lanes a block) tiles times as many chunks as fill it, and more
// chunks where that would put over kMaxChunk visits in one
template <class Op, bool FmaForm, bool Packed>
int launch_slab(const float* rows, const void* const* planes, int lanes,
                int visits, int* out, cudaStream_t stream) {
  using S = typename Op::S;
  auto kernel = slab_kernel<Op, FmaForm, Packed>;
  static int per_sm = 0, sms = 0;  // per instantiation, queried once
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const int tile = kBlock * kSlots * Op::kWidth;
  const int tiles = (lanes + tile - 1) / tile;
  // at most one wave: a block past it would run after the wave, alone
  const int fit = sms * per_sm / tiles;
  const int want = fit > 1 ? fit : 1;
  const int least = (visits + kMaxChunk - 1) / kMaxChunk;
  const int chunks0 = max(min(want, visits), least);
  const int chunk = (visits + chunks0 - 1) / chunks0;
  const int chunks = (visits + chunk - 1) / chunk;
  const S* p[6];
  for (int k = 0; k < 6; ++k) p[k] = static_cast<const S*>(planes[k]);
  kernel<<<dim3(tiles, chunks), kBlock, 0, stream>>>(
      rows, p[0], p[1], p[2], p[3], p[4], p[5], lanes, visits, chunk, out);
  return (int)cudaGetLastError();
}

template <class Op>
int launch_slab_forms(bool fma_form, bool packed, const float* rows,
                      const void* const* planes, int lanes, int visits,
                      int* out, cudaStream_t stream) {
  if (fma_form) {
    return packed ? launch_slab<Op, true, true>(rows, planes, lanes, visits,
                                                out, stream)
                  : launch_slab<Op, true, false>(rows, planes, lanes, visits,
                                                 out, stream);
  }
  return packed ? launch_slab<Op, false, true>(rows, planes, lanes, visits,
                                               out, stream)
                : launch_slab<Op, false, false>(rows, planes, lanes, visits,
                                                out, stream);
}

// --- the probes: one thread's dependent chain of one operation class ---

// op: 0 mul, 1 add, 2 min, 3 max

template <class Op, int kOp>
__device__ __forceinline__ typename Op::T step(typename Op::T x,
                                               typename Op::T y) {
  if (kOp == 0) return Op::mul(x, y);
  if (kOp == 1) return Op::add(x, y);
  if (kOp == 2) return Op::mn(x, y);
  return Op::mx(x, y);
}

template <class Op, int kOp>
__global__ void latency_kernel(const float* in, float* out,
                               long long* cycles, int iters) {
  using T = typename Op::T;
  // y keeps x where it is: 1 for mul, 0 for add, above x for min, below
  // it for max; both come from memory, so nothing folds
  T x = Op::from(in[0]);
  const T y = Op::from(in[1 + kOp]);
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < iters; ++k) {
    x = step<Op, kOp>(x, y);
  }
  const long long t1 = clock64();
  T keep[1] = {x};
  memcpy(out, keep, sizeof(T) < sizeof(float) ? sizeof(T) : sizeof(float));
  cycles[0] = t1 - t0;
}

template <class Op>
void launch_latency(int op, const float* in, float* out, long long* cycles,
                    int iters, cudaStream_t s) {
  switch (op) {
    case 0: latency_kernel<Op, 0><<<1, 1, 0, s>>>(in, out, cycles, iters); break;
    case 1: latency_kernel<Op, 1><<<1, 1, 0, s>>>(in, out, cycles, iters); break;
    case 2: latency_kernel<Op, 2><<<1, 1, 0, s>>>(in, out, cycles, iters); break;
    default: latency_kernel<Op, 3><<<1, 1, 0, s>>>(in, out, cycles, iters);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// out: [visits * 8] zeroed flags (per-child) or [visits] zeroed maxima
// (packed); the count is their sum. Returns cudaGetLastError().
int msn_vpu_slab(const float* rows, const void* ox, const void* oy,
                 const void* oz, const void* ix, const void* iy,
                 const void* iz, int lanes, int visits, int bf16,
                 int fma_form, int packed, int* out, void* stream) {
  if (lanes <= 0 || visits <= 0) return 0;
  const void* planes[6] = {ox, oy, oz, ix, iy, iz};
  const auto s = (cudaStream_t)stream;
  if (bf16) {
    return launch_slab_forms<BF16x2>(fma_form, packed, rows, planes, lanes,
                                     visits, out, s);
  }
  return launch_slab_forms<F32>(fma_form, packed, rows, planes, lanes, visits,
                                out, s);
}

int msn_vpu_alu(const void* a, const void* b, void* out, int n, int visits,
                int bf16, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int grid = (n + kAluBlock - 1) / kAluBlock;
  if (bf16) {
    using T = BF16::T;
    alu_kernel<BF16><<<grid, kAluBlock, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(out), n, visits);
  } else {
    alu_kernel<F32><<<grid, kAluBlock, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, visits);
  }
  return (int)cudaGetLastError();
}

// The latency probe: one thread runs `iters` dependent operations of one
// class and writes the clock64() cycles they took. kind: 0 float32, 1
// scalar bfloat16 (the ALU kernel's), 2 bfloat16x2 (the slab kernel's);
// op: 0 mul, 1 add (sub is the same instruction), 2 min, 3 max. in: the
// start value, then y for mul, add, min and max (float32, rounded to the
// kind's type); out: the chain's end (kept so the chain is not removed).
int msn_vpu_latency(int kind, int op, const float* in, float* out,
                    long long* cycles, int iters, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (kind == 0) {
    launch_latency<F32>(op, in, out, cycles, iters, s);
  } else if (kind == 1) {
    launch_latency<BF16>(op, in, out, cycles, iters, s);
  } else {
    launch_latency<BF16x2>(op, in, out, cycles, iters, s);
  }
  return (int)cudaGetLastError();
}

// An empty kernel: the launch floor beside the roofline bounds.
int msn_vpu_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
