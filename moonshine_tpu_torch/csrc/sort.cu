// Stable lane sort, for Hopper (sm_90a): the permutation that orders a
// lane batch by a small int32 key, and one pass that moves every lane
// array of the batch by it.
//
// Replaces no pallas_call: on the TPU this is moonshine_tpu/core/
// sortutil.py:22 `sort_lanes`, one stable multi-operand lax.sort that
// carries every payload (a gather by a permutation ran at ~500 MB/s
// there). The port calls it at three sites: the per-bounce state resort
// (integrator/path.py `_resort_state`, the reference's path.py:626), the
// traversal dispatch's coherence sort and its inverse (accel/packet.py
// `_sorted`, the reference's packet.py:672 `_sorted_dispatch`) and the
// treelet dispatch's sort by nearest treelet (accel/treelet.py
// `_sort_lanes`).
//
// The keys have a range the host knows: every key is either in
// [0, 2^bits) or a dead lane's key (1 << 20 at the sites; any key past
// the range sorts as one value after it, which keeps a stable sort's
// order when the dead key is the only such value). So the permutation is
// a stable LSD radix sort of the mapped key (bits + 1 bits) in passes of
// at most 8-bit digits: 2 passes for the resort's 4096 cells x octants
// and the packet key's 512, 3 for a treelet key of (K + 1) x 512. A pass
// is three launches:
//
//   radix_hist_kernel  a block a tile of 4096 lanes: each warp counts the
//            digits of its 512 consecutive lanes (__match_any_sync: the
//            lowest lane of each group of equal digits adds the group's
//            size), the block writes its tile's count of each digit,
//            digit-major
//   radix_scan_kernel  a block a digit: the exclusive scan of that
//            digit's tile counts, and the digit's total
//   radix_rank_kernel  a block a tile again: the digit bases (an
//            exclusive scan of the totals) plus the tile's offsets, each
//            warp's share of the tile before it, and each lane's rank
//            among the equal digits before it in its warp (a ballot of
//            __match_any_sync); the lane's permutation entry (and, before
//            the last pass, its mapped key) written at that position.
//
// Lanes keep their order within a digit, so each pass is stable and the
// permutation equals torch.argsort(key, stable=True) bit for bit. Then
// one launch moves every lane array (lane_move_kernel): a thread a lane
// reads its permutation entry once and copies the lane's row of each
// array in the widest word its row length and alignment allow (16, 8, 4,
// 2 or 1 bytes), gathering (out[i] = in[perm[i]]) or, for the inverse,
// scattering (out[perm[i]] = in[i]). Each array has its own row count:
// rows before `rows_perm` go by the permutation, rows from there to
// `rows_total` are copied where they lie (the lanes past a sorted
// prefix).
//
// The sites' keys come from coherence_key_kernel: a lane's origin cell
// in the scene's box (4^3 or 8^3 cells) and its direction's octant, in
// one launch where the plain version takes a dozen torch operations.
//
// What bounds it on this card: bytes. The move reads and writes each row
// once (the resort's 70 bytes a lane each way); the passes read the key
// and write the permutation, a few bytes a lane per pass, and the
// counting is a few integer operations a lane. Nothing is held across
// launches but the counts; every launch goes on the caller's stream and
// the workspace comes from the caller (msn_sort_work_ints), so a CUDA
// graph captures the whole sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;  // 32-lane rounds a warp walks in a tile
constexpr int kWarpLanes = 32 * kRounds;  // 512 consecutive lanes a warp
constexpr int kTile = kWarps * kWarpLanes;  // 4096 lanes a block
constexpr int kMaxDigitBits = 8;
constexpr int kMaxBuckets = 1 << kMaxDigitBits;
constexpr int kScanThreads = 1024;
constexpr int kMaxCols = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Passes {
  int count;  // digit passes
  int bits;   // digit bits a pass
};

// The mapped key has bits + 1 bits (a dead key maps to 2^bits); passes of
// at most 8-bit digits, all of one width.
Passes passes_for(int bits) {
  const int nb = bits + 1;
  const int count = (nb + kMaxDigitBits - 1) / kMaxDigitBits;
  return {count, (nb + count - 1) / count};
}

__device__ __forceinline__ int mapped(int key, int live) {
  return static_cast<unsigned>(key) < static_cast<unsigned>(live) ? key
                                                                   : live;
}

// Each thread's mapped keys in its warp's 512 lanes of the tile (-1 past
// n): round r holds lane tile * kTile + warp * 512 + r * 32 + lane.
__device__ __forceinline__ void load_keys(const int* __restrict__ keys,
                                          int n, int live, int tile,
                                          int k[kRounds]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(tile) * kTile + warp * kWarpLanes + lane;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32;
    k[r] = i < n ? mapped(keys[i], live) : -1;
  }
}

__device__ __forceinline__ int digit_of(int k, int shift, int mask) {
  return k < 0 ? -1 : (k >> shift) & mask;
}

// Adds each digit's count in this warp's lanes to `row` (this warp's row
// of the block's counts): the lowest lane of each group of equal digits
// adds the group's size.
__device__ __forceinline__ void warp_count(const int k[kRounds], int shift,
                                           int mask, int* row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int dg = digit_of(k[r], shift, mask);
    const unsigned peers = __match_any_sync(kFull, dg);
    if (dg >= 0 && lane == __ffs(peers) - 1) row[dg] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_counts(int (*rows)[kMaxBuckets]) {
  for (int i = threadIdx.x; i < kWarps * kMaxBuckets; i += blockDim.x) {
    rows[i / kMaxBuckets][i % kMaxBuckets] = 0;
  }
}

// The block's inclusive scan of v (blockDim.x threads, a multiple of 32,
// at most 1024); `warp_sums` holds 32 ints. Ends with a barrier.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += u;
    }
    if (lane < warps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();  // warp_sums may be reused
  return v + before;
}

// counts[d * tiles + tile]: lanes of `tile` whose digit is d.
__global__ void __launch_bounds__(kThreads)
    radix_hist_kernel(const int* __restrict__ keys, int n, int live,
                      int shift, int digit_bits, int tiles,
                      int* __restrict__ counts) {
  __shared__ int rows[kWarps][kMaxBuckets];
  const int tile = blockIdx.x;
  const int mask = (1 << digit_bits) - 1;
  zero_counts(rows);
  int k[kRounds];
  load_keys(keys, n, live, tile, k);
  __syncthreads();
  warp_count(k, shift, mask, rows[threadIdx.x >> 5]);
  __syncthreads();
  for (int dg = threadIdx.x; dg <= mask; dg += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rows[w][dg];
    counts[static_cast<long long>(dg) * tiles + tile] = s;
  }
}

// Block d: counts[d * tiles + t] becomes the lanes of digit d in tiles
// before t; totals[d] the digit's lanes in all.
__global__ void __launch_bounds__(kScanThreads)
    radix_scan_kernel(int* __restrict__ counts, int tiles,
                      int* __restrict__ totals) {
  __shared__ int warp_sums[32];
  int* row = counts + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    const int incl = block_inclusive_scan(v, warp_sums);
    if (t < tiles) row[t] = carry + incl - v;
    // the last thread's inclusive sum is the round's total
    if (threadIdx.x == kScanThreads - 1) warp_sums[0] = incl;
    __syncthreads();
    carry += warp_sums[0];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One stable counting pass: each lane's permutation entry (its lane
// index on the first pass, perm_in's after) and, unless keys_out is
// null, its mapped key, written at its place in the digit order.
__global__ void __launch_bounds__(kThreads)
    radix_rank_kernel(const int* __restrict__ keys,
                      const int* __restrict__ perm_in, int n, int live,
                      int shift, int digit_bits, int tiles,
                      const int* __restrict__ counts,
                      const int* __restrict__ totals,
                      int* __restrict__ keys_out,
                      int* __restrict__ perm_out) {
  __shared__ int rows[kWarps][kMaxBuckets];
  __shared__ int warp_sums[32];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int buckets = 1 << digit_bits, mask = buckets - 1;
  zero_counts(rows);
  int k[kRounds];
  load_keys(keys, n, live, tile, k);
  // the digits' bases: an exclusive scan of their totals (buckets <=
  // kThreads), plus this tile's offset within each digit
  const int dg0 = threadIdx.x;
  const int total = dg0 < buckets ? totals[dg0] : 0;
  const int base = block_inclusive_scan(total, warp_sums) - total;
  __syncthreads();  // rows zeroed
  warp_count(k, shift, mask, rows[warp]);
  __syncthreads();
  if (dg0 < buckets) {
    int run = base + counts[static_cast<long long>(dg0) * tiles + tile];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = rows[w][dg0];
      rows[w][dg0] = run;  // where warp w's first lane of this digit goes
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const long long first =
      static_cast<long long>(tile) * kTile + warp * kWarpLanes + lane;
  int* row = rows[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int dg = digit_of(k[r], shift, mask);
    const unsigned peers = __match_any_sync(kFull, dg);
    const int pos = dg >= 0 ? row[dg] + __popc(peers & below) : 0;
    __syncwarp();
    if (dg >= 0 && lane == __ffs(peers) - 1) row[dg] += __popc(peers);
    __syncwarp();
    if (dg >= 0) {
      const int i = static_cast<int>(first + r * 32);
      perm_out[pos] = perm_in ? perm_in[i] : i;
      if (keys_out) keys_out[pos] = k[r];
    }
  }
}

struct Col {
  const char* src;
  char* dst;
  int word;        // bytes a word: 16, 8, 4, 2 or 1
  int words;       // words a row
  int rows_perm;   // rows moved by the permutation
  int rows_total;  // rows written (those past rows_perm where they lie)
};

struct Table {
  Col col[kMaxCols];
  int ncols;
};

template <typename W>
__device__ __forceinline__ void copy_row(const Col& c, long long from,
                                         long long to) {
  const W* s = reinterpret_cast<const W*>(c.src) + from * c.words;
  W* d = reinterpret_cast<W*>(c.dst) + to * c.words;
  for (int w = 0; w < c.words; ++w) d[w] = s[w];
}

// Thread i moves lane i of every array: gathering, row i of the output is
// row perm[i] of the input; scattering (the inverse), row perm[i] of the
// output is row i of the input.
__global__ void __launch_bounds__(kThreads)
    lane_move_kernel(const Table table, const int* __restrict__ perm,
                     int n, int rows, int scatter) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= rows) return;
  const long long p = i < n ? perm[i] : i;
  for (int j = 0; j < table.ncols; ++j) {
    const Col& c = table.col[j];
    if (i >= c.rows_total) continue;
    long long from = i, to = i;
    if (i < c.rows_perm) {
      if (scatter) {
        to = p;
      } else {
        from = p;
      }
    }
    switch (c.word) {
      case 16: copy_row<uint4>(c, from, to); break;
      case 8: copy_row<unsigned long long>(c, from, to); break;
      case 4: copy_row<unsigned>(c, from, to); break;
      case 2: copy_row<unsigned short>(c, from, to); break;
      default: copy_row<unsigned char>(c, from, to); break;
    }
  }
}

// The coherence key of lane i, as the plain version's torch ops form it
// (each operation rounded once: -fmad=false): C^3 origin cells, the
// origin's cell along each axis floor(((o - lo) * inv_ext) * C) clamped
// to [0, C) (the float-to-int conversion truncates and saturates, NaN to
// 0, as torch's cast on the card), times 8 direction octants; plus
// major[i] x C^3 x 8 where given; a lane whose mask is clear gets `dead`.
__global__ void __launch_bounds__(kThreads)
    coherence_key_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const bool* __restrict__ active,
                         const int* __restrict__ major,
                         const float* __restrict__ lo,
                         const float* __restrict__ inv_ext, int n, int cells,
                         int dead, int* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  if (active && !active[i]) {
    key[i] = dead;
    return;
  }
  const float scale = static_cast<float>(cells);
  int k = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x =
        __fmul_rn(__fmul_rn(__fsub_rn(o[3 * i + c], lo[c]), inv_ext[c]),
                  scale);
    const int cell = min(max(__float2int_rz(x), 0), cells - 1);
    k = k * cells + cell;
  }
  k = k * 8 + (d[3 * i] > 0.0f) * 4 + (d[3 * i + 1] > 0.0f) * 2 +
      (d[3 * i + 2] > 0.0f);
  if (major) k += major[i] * (cells * cells * cells * 8);
  key[i] = k;
}

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// The most columns a move takes.
int msn_sort_max_cols() { return kMaxCols; }

// Digit passes for keys of `bits` bits.
int msn_sort_passes(int bits) { return passes_for(bits).count; }

// int32 words of workspace msn_sort_lanes takes for n keys of `bits` bits.
long long msn_sort_work_ints(int n, int bits) {
  const Passes p = passes_for(bits);
  const long long tiles = tiles_for(n);
  const long long buckets = 1 << p.bits;
  const long long pingpong = p.count >= 3 ? 4 : p.count == 2 ? 2 : 0;
  return buckets * tiles + buckets + pingpong * n;
}

// perm[0..n): the stable order of key[0..n) (int32; keys in [0, 2^bits),
// any other key sorting as one value after them), bits in [0, 30], n > 0;
// `work` holds msn_sort_work_ints(n, bits) int32 words. Launches on
// `stream`, allocates nothing, reads nothing back; returns
// cudaGetLastError().
int msn_sort_lanes(const int* key, int n, int bits, int* work, int* perm,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Passes p = passes_for(bits);
  const int tiles = tiles_for(n);
  const int buckets = 1 << p.bits;
  const int live = 1 << bits;
  int* counts = work;
  int* totals = counts + static_cast<long long>(buckets) * tiles;
  int* keys_a = totals + buckets;
  int* perm_a = keys_a + n;
  int* keys_b = perm_a + n;
  int* perm_b = keys_b + n;
  const int* keys_in = key;
  const int* perm_in = nullptr;
  for (int pass = 0; pass < p.count; ++pass) {
    const bool last = pass == p.count - 1;
    int* keys_out = last ? nullptr : (pass % 2 ? keys_b : keys_a);
    int* perm_out = last ? perm : (pass % 2 ? perm_b : perm_a);
    const int shift = pass * p.bits;
    radix_hist_kernel<<<tiles, kThreads, 0, s>>>(keys_in, n, live, shift,
                                                 p.bits, tiles, counts);
    radix_scan_kernel<<<buckets, kScanThreads, 0, s>>>(counts, tiles,
                                                       totals);
    radix_rank_kernel<<<tiles, kThreads, 0, s>>>(
        keys_in, perm_in, n, live, shift, p.bits, tiles, counts, totals,
        keys_out, perm_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    keys_in = keys_out;
    perm_in = perm_out;
  }
  return static_cast<int>(cudaGetLastError());
}

// key[0..n): the coherence key of each lane (coherence_key_kernel) from
// o and d (float32 [n, 3]), the scene box's lower corner lo and inverse
// extent inv_ext (float32 [3]); active (bool [n]) and major (int32 [n])
// may be null. Returns cudaGetLastError().
int msn_coherence_key(const float* o, const float* d, const bool* active,
                      const int* major, const float* lo,
                      const float* inv_ext, int n, int cells, int dead,
                      int* key, void* stream) {
  if (n > 0) {
    coherence_key_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        o, d, active, major, lo, inv_ext, n, cells, dead, key);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch moving ncols (<= msn_sort_max_cols()) lane arrays by perm
// [0..n) (int32): column j's rows of word[j] bytes x words[j] from src[j]
// to dst[j], rows before rows_perm[j] (<= n) by the permutation (gathered,
// or scattered when `scatter`), rows up to rows_total[j] where they lie.
// src and dst must not overlap. Returns cudaGetLastError().
int msn_move_lanes(const long long* src, const long long* dst,
                   const int* word, const int* words, const int* rows_perm,
                   const int* rows_total, int ncols, const int* perm, int n,
                   int scatter, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  int rows = 0;
  for (int j = 0; j < ncols; ++j) {
    table.col[j] = Col{reinterpret_cast<const char*>(src[j]),
                       reinterpret_cast<char*>(dst[j]), word[j], words[j],
                       rows_perm[j], rows_total[j]};
    if (rows_total[j] > rows) rows = rows_total[j];
  }
  table.ncols = ncols;
  if (rows > 0) {
    const int blocks = (rows + kThreads - 1) / kThreads;
    lane_move_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(table, perm, n,
                                                            rows, scatter);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
