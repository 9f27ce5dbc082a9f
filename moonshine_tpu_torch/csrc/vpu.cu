// Arithmetic microbenchmarks of the traversal's child test, for Hopper
// (sm_90a), in float32 and bfloat16.
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
// Design: one thread per lane. The TPU kernel reduces a visit's hits
// across the whole 8192-lane block in registers; blocks here run in no
// order, so a visit's cross-lane "any" and "max" go through a warp vote
// (__any_sync, __reduce_max_sync) and one store or atomicMax per warp into
// a [visits * 8] or [visits] array that the wrapper sums. The row table is
// read through __ldg: every thread of a visit reads the same 48 words, one
// broadcast per warp.
//
// What bounds it on this card: operations. Each lane does 25 per child
// test and visit; the table (64 KB) and the lanes (6 planes of 8192) stay
// in L1/L2. The ALU chain is one dependent chain per thread: with 64 or
// 256 warps on 132 SMs it is bound by instruction latency, not by the
// card's issue rate, as the reference's (1, 64|256, 128) block was on the
// TPU. Nothing is done about that: the kernel measures it.
//
// Numerics: in bfloat16 every min/max/mul/add/sub rounds to bfloat16
// (cuda_bf16.h intrinsics, round to nearest even; a float32 operation
// rounded to bfloat16 gives the same value, as torch's bfloat16 ops
// compute it) and the slab's compares are float32, as the reference does
// them. Built with -fmad=false: no multiply-add is contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChildren = 8;

struct F32 {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T mn(T a, T b) { return fminf(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return fmaxf(a, b); }
  static __device__ __forceinline__ T from(float x) { return x; }
  static __device__ __forceinline__ float f32(T x) { return x; }
  static __device__ __forceinline__ T max_value() { return FLT_MAX; }
};

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
  static __device__ __forceinline__ float f32(T x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ T max_value() {
    return __ushort_as_bfloat16((unsigned short)0x7F7F);
  }
};

template <class Op, bool FmaForm, bool Packed>
__global__ void __launch_bounds__(kBlock) slab_kernel(
    const float* __restrict__ rows, const typename Op::T* __restrict__ ox,
    const typename Op::T* __restrict__ oy,
    const typename Op::T* __restrict__ oz,
    const typename Op::T* __restrict__ ix,
    const typename Op::T* __restrict__ iy,
    const typename Op::T* __restrict__ iz, int lanes, int visits,
    int* __restrict__ out) {
  using T = typename Op::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of a warp takes part in its votes; padding lanes never hit
  const bool live = i < lanes;
  const int li = live ? i : 0;
  const T o[3] = {ox[li], oy[li], oz[li]};
  const T inv[3] = {ix[li], iy[li], iz[li]};
  T oinv[3];
  for (int c = 0; c < 3; ++c) oinv[c] = Op::mul(o[c], inv[c]);
  const float prune = Op::f32(Op::max_value());
  const bool lead = (threadIdx.x & 31) == 0;

  for (int v = 0; v < visits; ++v) {
    const float* row = rows + (v & 127) * 128;
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < kChildren; ++j) {
      T t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        const T lo = Op::from(__ldg(row + c * kChildren + j));
        const T hi = Op::from(__ldg(row + 24 + c * kChildren + j));
        if (FmaForm) {
          t0[c] = Op::sub(Op::mul(lo, inv[c]), oinv[c]);
          t1[c] = Op::sub(Op::mul(hi, inv[c]), oinv[c]);
        } else {
          t0[c] = Op::mul(Op::sub(lo, o[c]), inv[c]);
          t1[c] = Op::mul(Op::sub(hi, o[c]), inv[c]);
        }
      }
      const float tnear = Op::f32(
          Op::mx(Op::mx(Op::mn(t0[0], t1[0]), Op::mn(t0[1], t1[1])),
                 Op::mn(t0[2], t1[2])));
      const float tfar = Op::f32(
          Op::mn(Op::mn(Op::mx(t0[0], t1[0]), Op::mx(t0[1], t1[1])),
                 Op::mx(t0[2], t1[2])));
      const bool hit =
          live && tnear <= tfar && tfar >= 0.0f && tnear <= prune;
      if (Packed) {
        packed |= (unsigned)hit << j;
      } else if (__any_sync(kFull, hit) && lead) {
        out[v * kChildren + j] = 1;  // every writer writes 1
      }
    }
    if (Packed) {
      const unsigned m = __reduce_max_sync(kFull, packed);
      if (lead && m != 0) atomicMax(out + v, (int)m);
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kBlock) alu_kernel(
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

template <class Op, bool FmaForm, bool Packed>
void launch_slab(const float* rows, const void* const* planes, int lanes,
                 int visits, int* out, cudaStream_t stream) {
  using T = typename Op::T;
  const T* p[6];
  for (int k = 0; k < 6; ++k) p[k] = static_cast<const T*>(planes[k]);
  const int grid = (lanes + kBlock - 1) / kBlock;
  slab_kernel<Op, FmaForm, Packed><<<grid, kBlock, 0, stream>>>(
      rows, p[0], p[1], p[2], p[3], p[4], p[5], lanes, visits, out);
}

template <class Op>
void launch_slab_forms(bool fma_form, bool packed, const float* rows,
                       const void* const* planes, int lanes, int visits,
                       int* out, cudaStream_t stream) {
  if (fma_form) {
    if (packed) {
      launch_slab<Op, true, true>(rows, planes, lanes, visits, out, stream);
    } else {
      launch_slab<Op, true, false>(rows, planes, lanes, visits, out, stream);
    }
  } else if (packed) {
    launch_slab<Op, false, true>(rows, planes, lanes, visits, out, stream);
  } else {
    launch_slab<Op, false, false>(rows, planes, lanes, visits, out, stream);
  }
}

}  // namespace

extern "C" {

// out: [visits * 8] zeroed flags (per-child) or [visits] zeroed maxima
// (packed); the count is their sum. Returns cudaGetLastError().
int msn_vpu_slab(const float* rows, const void* ox, const void* oy,
                 const void* oz, const void* ix, const void* iy,
                 const void* iz, int lanes, int visits, int bf16,
                 int fma_form, int packed, int* out, void* stream) {
  const void* planes[6] = {ox, oy, oz, ix, iy, iz};
  const auto s = (cudaStream_t)stream;
  if (bf16) {
    launch_slab_forms<BF16>(fma_form, packed, rows, planes, lanes, visits,
                            out, s);
  } else {
    launch_slab_forms<F32>(fma_form, packed, rows, planes, lanes, visits,
                           out, s);
  }
  return (int)cudaGetLastError();
}

int msn_vpu_alu(const void* a, const void* b, void* out, int n, int visits,
                int bf16, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  const auto s = (cudaStream_t)stream;
  if (bf16) {
    using T = BF16::T;
    alu_kernel<BF16><<<grid, kBlock, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(out), n, visits);
  } else {
    alu_kernel<F32><<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, visits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
