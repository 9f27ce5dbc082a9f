// Quantised-row decode probe, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/probe_bitcast.py (`run`,
// pallas_call at :63; kernel `make_kernel` at :25), which checks the
// scalar decode a quantised traversal row needs: row 1 of an int32
// [4, rowlen] array is copied from device memory into on-chip memory
// (there: SMEM, by an async DMA and its semaphore), then
//   out[0, :] = f32(row[0]) * 2^-20                  fixed-point decode
//   out[1, :] = 2.5 + f32(row[1] & 0xFFFF) * 0.125   low u16 half
//   out[2, :] = 2.5 + f32((row[1] >> 16) & 0xFFFF) * 0.125   high half
//   out[3, :] = f32(row[rowlen - 1])                 i32 pass-through
// each value broadcast along its row of a float32 [4, 128] output.
//
// Design: one block of 128 threads, one output column each. The row goes
// from global into shared memory with cp.async (4 bytes a thread, any
// rowlen), completed by cp.async.wait_all and a barrier: the counterpart
// of pltpu.make_async_copy plus its semaphore wait. Every thread then
// reads the same three words (a shared-memory broadcast) and writes its
// column of the four rows.
//
// What bounds it on this card: nothing but the launch. It moves one row
// (4 * rowlen bytes) and writes 2 KB, about a nanosecond of HBM time; a
// launch costs microseconds. It is a probe, not a hot path: nothing is
// done about that.
//
// Numerics: int -> float by __int2float_rn (round to nearest even, as
// torch's int32 -> float32 cast), multiplies and adds by __fmul_rn /
// __fadd_rn, built with -fmad=false besides: the output equals the plain
// torch version (decode_rows_plain) bit for bit, also where |row[0]| or
// |row[rowlen - 1]| exceeds 2^24 and the conversion rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // output columns
constexpr float kFixScale = 1.0f / 1048576.0f;  // 2^-20
constexpr float kU16Base = 2.5f;
constexpr float kU16Step = 0.125f;

__device__ __forceinline__ void copy_word_async(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kBlock)
    bitcast_kernel(const int* __restrict__ rows, int rowlen,
                   float* __restrict__ out) {
  extern __shared__ int srow[];
  const int t = threadIdx.x;
  const int* row1 = rows + rowlen;
  for (int i = t; i < rowlen; i += kBlock) {
    copy_word_async(srow + i, row1 + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int w0 = srow[0];
  const int q = srow[1];
  const float fa = __fmul_rn(__int2float_rn(w0), kFixScale);
  const float v_lo =
      __fadd_rn(kU16Base, __fmul_rn(__int2float_rn(q & 0xFFFF), kU16Step));
  const float v_hi = __fadd_rn(
      kU16Base, __fmul_rn(__int2float_rn((q >> 16) & 0xFFFF), kU16Step));
  const float p = __int2float_rn(srow[rowlen - 1]);
  out[t] = fa;
  out[kBlock + t] = v_lo;
  out[2 * kBlock + t] = v_hi;
  out[3 * kBlock + t] = p;
}

}  // namespace

extern "C" {

// rows: int32 [4, rowlen] contiguous, rowlen in [2, 12288] (the row fits
// the default 48 KB of dynamic shared memory); out: float32 [4, 128].
// Returns cudaGetLastError().
int msn_bitcast_decode(const int* rows, int rowlen, float* out,
                       void* stream) {
  bitcast_kernel<<<1, kBlock, rowlen * sizeof(int), (cudaStream_t)stream>>>(
      rows, rowlen, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
