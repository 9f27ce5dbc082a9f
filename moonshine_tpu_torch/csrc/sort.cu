// Stable lane sort, for Hopper (sm_90a): the permutation that orders a
// lane batch by a small int32 key, and one launch that moves every lane
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
// [0, 2^bits) or a dead lane's key (1 << 20 at the sites); any key past
// the range, a negative one too, sorts as one value after it (`mapped`:
// 2^bits), which keeps a stable sort's order when the dead key is the
// only such value. So the permutation is a stable LSD radix sort of the
// mapped key over digits of at most 10 bits (`plan_for`): the low digits
// are bit fields, the top digit is what is left, 2^k + 1 values. The
// packet key (9 bits) is one pass of 513 buckets, the resort's (12 bits)
// two of 64 and 65, a treelet key of (K + 1) x 512 (18 bits at K = 379)
// two of 512 and 513. A sort is one memset (the histograms, tile counters
// and look-back states) and 1 + passes launches:
//
//   radix_upsweep_kernel  reads the keys once and counts every pass's
//            digits (a block's counts in shared memory, __match_any_sync
//            adding a group of equal digits at once), added into each
//            pass's global histogram.
//   radix_onesweep_kernel  a pass, a block of 512 threads a tile of 8192
//            lanes, the tile taken from an atomic counter in the order
//            blocks start, so a tile waits only on tiles already running.
//            Each warp ranks its 512 consecutive lanes among the equal
//            digits before them (__match_any_sync and a warp-private
//            count row); the block publishes its count of each digit and
//            then, in place of a scan launch, looks back two levels deep:
//            it sums the counts of the tiles before it in its group of 32
//            and the totals of the groups before it, each group's total
//            published by its last tile from its own group's counts
//            alone. So no tile waits on a chain of other tiles' look-backs
//            (a one-level look-back, in which a tile waits for the
//            inclusive prefix of a tile before it, ran the tiles of a pass
//            one after another here: they all start together). The tile is
//            sorted by digit in shared memory, then written out as
//            contiguous runs of each digit: the permutation entry and,
//            before the last pass, the mapped key at base[digit] + the
//            tiles before + the lane's rank in the tile.
//
// Lanes keep their order within a digit (warp order, lane order, tile
// order), so each pass is stable and the permutation equals
// torch.argsort of the mapped key (of the key itself at the sites) bit for
// bit. The move (lane_move_kernel, one launch for every array) walks the
// arrays one after another: the grid's blocks take (array, chunk) with
// the array as the slower index, so the running blocks move one or two
// arrays at a time and only their permuted side (the source when
// gathering, out[i] = in[perm[i]]; the destination when scattering, the
// inverse, out[perm[i]] = in[i]) is live in the 50 MB L2: the largest
// array at the sites, o or d at 2,073,600 x 12 bytes, is 24.9 MB. A
// thread moves whole rows, four (one of 16-byte words), in words of the
// block's array (16, 8, 4, 2 or 1 bytes, the widest its rows and pointers
// allow), the word and a row of 1 or 3 words template parameters; its
// permutation entries and loads are issued before its stores. Each array
// has its own row count: rows before `rows_perm` go by the permutation,
// rows from there to `rows_total` are copied where they lie (the lanes
// past a sorted prefix).
//
// The sites' keys come from coherence_key_kernel: a lane's origin cell
// in the scene's box (4^3 or 8^3 cells) and its direction's octant, in
// one launch where the plain version takes a dozen torch operations.
//
// What bounds it on this card: bytes, and for the move the L2's sectors.
// The move reads and writes each row once (the resort's 70 bytes a lane
// each way), but on its permuted side every row costs the 32-byte
// sectors it spans, read from (or merged into) L2. The passes read the
// key (twice: the upsweep and the first pass) and write the permutation,
// plus 8 bytes a lane between passes; the counting is a few integer
// operations a lane and pass. Nothing is held across launches but the
// counts and states, which the memset resets; every launch goes on the
// caller's stream and the workspace comes from the caller
// (msn_sort_work_ints), so a CUDA graph captures the whole sort and
// replays it on fresh keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block of the key and move kernels
constexpr int kSweepThreads = 512;  // a onesweep block: 16 warps
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kRounds = 16;  // 32-lane rounds a warp walks in a tile
constexpr int kWarpLanes = 32 * kRounds;  // 512 consecutive lanes a warp
constexpr int kTile = kSweepWarps * kWarpLanes;  // 8192 lanes a tile
constexpr int kMaxDigitBits = 10;
constexpr int kMaxBuckets = (1 << kMaxDigitBits) + 1;  // a top digit's
constexpr int kMaxPasses = 3;  // keys of up to 30 bits
// digits a onesweep thread counts for (thread t: t, t + 512, ...)
constexpr int kSlots = (kMaxBuckets + kSweepThreads - 1) / kSweepThreads;
constexpr int kGroup = 32;  // tiles whose counts one look-back sums
constexpr int kHistThreads = 512;
constexpr int kHistItems = 8;  // keys a thread loads at once
constexpr int kHistChunk = kHistThreads * kHistItems;
// rows a move thread moves: four, one of 16-byte words (a 48-byte row is
// three such words: more rows would spill)
__host__ __device__ constexpr int move_rows_for(int word) {
  return word == 16 ? 1 : 4;
}
constexpr int kMaxCols = 16;
constexpr unsigned kFull = 0xffffffffu;
// a tile's or group's look-back state: its counts are published (0: not
// yet)
constexpr unsigned kPublished = 1u;
// look-back reads a tile makes before it stops the launch with an error:
// seconds at the L2's latency, where a sort waits microseconds
constexpr int kMaxPolls = 1 << 24;
constexpr int kBackoffNs = 200;  // between reads that found no progress

// The digits of a key of `bits` bits: the mapped key has 2^bits + 1
// values; passes of equal low digits (at most 10 bits) and a top digit of
// what is left, 2^(bits - shift) + 1 buckets.
struct Plan {
  int passes;
  int shift[kMaxPasses];
  int mask[kMaxPasses];     // the top digit's keeps every bit
  int buckets[kMaxPasses];
  int offset[kMaxPasses];   // the pass's first bucket in the histogram
  int total;                // buckets of every pass
};

Plan plan_for(int bits) {
  Plan p{};
  p.passes = bits <= kMaxDigitBits
                 ? 1
                 : (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int width = (bits + p.passes - 1) / p.passes;
  for (int i = 0; i < p.passes; ++i) {
    const bool top = i == p.passes - 1;
    p.shift[i] = i * width;
    p.buckets[i] = top ? (1 << (bits - p.shift[i])) + 1 : 1 << width;
    p.mask[i] = top ? 0x7fffffff : (1 << width) - 1;
    p.offset[i] = p.total;
    p.total += p.buckets[i];
  }
  return p;
}

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

int groups_for(int n) { return (tiles_for(n) + kGroup - 1) / kGroup; }

// Where each part of the workspace starts (int32 words): the histograms,
// the tile counters and the tiles' and groups' look-back states, a pass
// after another (the memset's); each pass's tile counts (tiles x buckets)
// and group totals (groups x buckets); the keys and permutation between
// passes (two sets for three passes).
struct Layout {
  long long hist, counters, states, group_states, zeroed,
      counts[kMaxPasses], totals[kMaxPasses], keys[2], perms[2], ints;
};

Layout layout_for(int n, const Plan& p) {
  Layout l{};
  const long long tiles = tiles_for(n), groups = groups_for(n);
  l.hist = 0;
  l.counters = p.total;
  l.states = l.counters + kMaxPasses;
  l.group_states = l.states + p.passes * tiles;
  l.zeroed = l.group_states + p.passes * groups;
  long long at = l.zeroed;
  for (int i = 0; i < p.passes; ++i) {
    l.counts[i] = at;
    l.totals[i] = at + tiles * p.buckets[i];
    at += (tiles + groups) * p.buckets[i];
  }
  for (int j = 0; j < 2 && j < p.passes - 1; ++j) {
    l.keys[j] = at;
    l.perms[j] = at + n;
    at += 2LL * n;
  }
  l.ints = at;
  return l;
}

size_t onesweep_smem(int buckets) {
  const int rows = kSweepWarps * buckets;
  const int region = rows > 2 * kTile ? rows : 2 * kTile;
  return static_cast<size_t>(region + 3 * buckets) * sizeof(int);
}

__device__ __forceinline__ int mapped(int key, int live) {
  return static_cast<unsigned>(key) < static_cast<unsigned>(live) ? key
                                                                   : live;
}

__device__ __forceinline__ int digit_of(int k, int shift, int mask) {
  return k < 0 ? -1 : (k >> shift) & mask;
}

__device__ __forceinline__ unsigned load_state(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_state(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Another tile's published count, from L2, read where it stands: after the
// barrier that follows the wait for its state (__ldcg's asm is not
// volatile, so the compiler may move it above the barrier)
__device__ __forceinline__ int load_count(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
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

// out[d] = v[0] + ... + v[d - 1] for d < len (out may be v): each thread
// scans a run of consecutive entries. Ends with a barrier.
__device__ void block_exclusive_scan(const int* v, int* out, int len,
                                     int* warp_sums) {
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, len);
  const int hi = min(lo + per, len);
  int sum = 0;
  for (int d = lo; d < hi; ++d) sum += v[d];
  int run = block_inclusive_scan(sum, warp_sums) - sum;
  for (int d = lo; d < hi; ++d) {
    const int x = v[d];
    out[d] = run;
    run += x;
  }
  __syncthreads();
}

// Every pass's digit counts of the mapped keys, added into hist (zeroed
// before: the memset).
__global__ void __launch_bounds__(kHistThreads)
    radix_upsweep_kernel(const int* __restrict__ keys, int n, int live,
                         const Plan plan, int* __restrict__ hist) {
  __shared__ int counts[kMaxPasses * kMaxBuckets];
  for (int i = threadIdx.x; i < plan.total; i += kHistThreads) counts[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * kHistChunk;
       base < n; base += static_cast<long long>(gridDim.x) * kHistChunk) {
    int k[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const long long i = base + j * kHistThreads + threadIdx.x;
      k[j] = i < n ? mapped(keys[i], live) : -1;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p < plan.passes) {  // the same for every lane
          const int dg = digit_of(k[j], plan.shift[p], plan.mask[p]);
          const unsigned peers = __match_any_sync(kFull, dg);
          if (dg >= 0 && lane == __ffs(peers) - 1) {
            atomicAdd(&counts[plan.offset[p] + dg], __popc(peers));
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.total; i += kHistThreads) {
    if (counts[i]) atomicAdd(&hist[i], counts[i]);
  }
}

// One stable counting pass over the tile the block takes from `counter`:
// each lane's permutation entry (its lane index on the first pass,
// perm_in's after) and, unless keys_out is null, its mapped key, written
// at its place in the digit order. hist: this pass's digit totals;
// states, group_states: its tiles' and groups' look-back states, zero on
// entry; counts, totals: its tiles' digit counts (tiles x buckets) and
// its groups' (groups x buckets), written here.
__global__ void __launch_bounds__(kSweepThreads, 2)
    radix_onesweep_kernel(const int* __restrict__ keys_in,
                          const int* __restrict__ perm_in, int n, int live,
                          int shift, int mask, int buckets,
                          const int* __restrict__ hist,
                          int* __restrict__ counter, unsigned* states,
                          unsigned* group_states, int* counts, int* totals,
                          int* __restrict__ keys_out,
                          int* __restrict__ perm_out) {
  extern __shared__ int smem[];
  // warp count rows [kSweepWarps][buckets], then (the same words) the
  // tile sorted by digit: keys [kTile], permutation entries [kTile]
  const int region = max(kSweepWarps * buckets, 2 * kTile);
  int* rows = smem;
  int* staged_key = smem;
  int* staged_perm = smem + kTile;
  int* offset = smem + region;  // base[d]; then where run d goes, less start
  int* count = offset + buckets;  // the tile's lanes of digit d
  int* start = count + buckets;   // the tile's first sorted position of d
  __shared__ int warp_sums[32];
  __shared__ int tile_taken;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) tile_taken = atomicAdd(counter, 1);
  for (int i = threadIdx.x; i < kSweepWarps * buckets; i += kSweepThreads) {
    rows[i] = 0;
  }
  __syncthreads();
  const int tile = tile_taken;
  const long long first =
      static_cast<long long>(tile) * kTile + warp * kWarpLanes + lane;
  int k[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = first + r * 32;
    k[r] = i >= n ? -1 : perm_in ? keys_in[i] : mapped(keys_in[i], live);
  }
  // each lane's rank among the equal digits before it in its warp, and
  // the warp's count of each digit
  const unsigned below = (1u << lane) - 1u;
  int* row = rows + warp * buckets;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int dg = digit_of(k[r], shift, mask);
    const unsigned peers = __match_any_sync(kFull, dg);
    rank[r] = dg >= 0 ? row[dg] + __popc(peers & below) : 0;
    __syncwarp();
    if (dg >= 0 && lane == __ffs(peers) - 1) row[dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // a digit a thread: the warps' exclusive prefix in place and the tile's
  // count, published
  int* my_counts = counts + static_cast<long long>(tile) * buckets;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int d = threadIdx.x + j * kSweepThreads;
    if (d < buckets) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kSweepWarps; ++w) {
        const int c = rows[w * buckets + d];
        rows[w * buckets + d] = run;
        run += c;
      }
      count[d] = run;
      my_counts[d] = run;
    }
  }
  __threadfence();  // the counts reach L2 before the state says so
  __syncthreads();
  if (threadIdx.x == 0) store_state(states + tile, kPublished);
  // the look-back, two levels deep, with no chain: the tiles before this
  // one in its group of kGroup, then the groups before it, each group's
  // counts published by its last tile as soon as its own group's are in.
  // One warp waits for the states, then every digit sums the counts. A
  // tile waits only on tiles taken before it, which run.
  const int group = tile / kGroup, group_first = group * kGroup;
  if (warp == 0 && tile > group_first) {
    const int t = group_first + lane;
    for (int polls = 0; !__all_sync(kFull, t >= tile ||
                                               load_state(states + t) != 0);
         ++polls) {
      if (polls == kMaxPolls) __trap();  // no progress: fail, do not hang
      __nanosleep(kBackoffNs);
    }
    __threadfence();
  }
  __syncthreads();
  const bool last_of_group = tile % kGroup == kGroup - 1;
  int excl[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int d = threadIdx.x + j * kSweepThreads;
    int within = 0;
    if (d < buckets) {
      // four loads in flight at a time: the loop unrolled in full (31
      // predicated loads) gave wrong permutations on the card with 1024
      // and 1025 buckets, a cause not found; this form holds every plan
#pragma unroll 4
      for (int t = group_first; t < tile; ++t) {
        within += load_count(counts + static_cast<long long>(t) * buckets + d);
      }
      if (last_of_group) {
        totals[static_cast<long long>(group) * buckets + d] =
            within + count[d];
      }
    }
    excl[j] = within;
  }
  if (last_of_group) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_state(group_states + group, kPublished);
  }
  if (group > 0) {
    if (warp == 0) {
      for (int polls = 0;; ++polls) {
        if (polls == kMaxPolls) __trap();
        bool ready = true;
        for (int g = lane; g < group; g += 32) {
          ready = ready && load_state(group_states + g) != 0;
        }
        if (__all_sync(kFull, ready)) break;
        __nanosleep(kBackoffNs);
      }
      __threadfence();
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int d = threadIdx.x + j * kSweepThreads;
      if (d < buckets) {
        int before = 0;
#pragma unroll 8
        for (int g = 0; g < group; ++g) {
          before += load_count(totals + static_cast<long long>(g) * buckets +
                               d);
        }
        excl[j] += before;
      }
    }
  }
  // the digits' bases (an exclusive scan of their totals) and the tile's
  // first sorted position of each digit (one of its counts)
  block_exclusive_scan(hist, offset, buckets, warp_sums);
  block_exclusive_scan(count, start, buckets, warp_sums);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int d = threadIdx.x + j * kSweepThreads;
    if (d < buckets) offset[d] += excl[j] - start[d];
  }
  // each lane's place in the tile sorted by digit
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int dg = digit_of(k[r], shift, mask);
    if (dg >= 0) rank[r] += start[dg] + row[dg];
  }
  __syncthreads();  // the count rows are read: the words take the tile
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (k[r] >= 0) {
      const long long i = first + r * 32;
      staged_key[rank[r]] = k[r];
      staged_perm[rank[r]] = perm_in ? perm_in[i] : static_cast<int>(i);
    }
  }
  __syncthreads();
  const long long left = static_cast<long long>(n) -
                         static_cast<long long>(tile) * kTile;
  const int len = left < kTile ? static_cast<int>(left) : kTile;
  for (int i = threadIdx.x; i < len; i += kSweepThreads) {
    const int key = staged_key[i];
    const int to = offset[(key >> shift) & mask] + i;
    perm_out[to] = staged_perm[i];
    if (keys_out) keys_out[to] = key;
  }
}

struct Col {
  const char* src;
  char* dst;
  int word;        // bytes a word: 16, 8, 4, 2 or 1
  int words;       // words a row
  int rows_perm;   // rows moved by the permutation
  int rows_total;  // rows written (those past rows_perm where they lie)
  int first_block;  // the column's first block of the grid
};

struct Table {
  Col col[kMaxCols];
  int ncols;
};

// Chunk `chunk` of column c: kThreads x R consecutive rows of the rows it
// writes (gathering) or reads (scattering) in lane order, a thread's
// kThreads apart, rows below rows_perm by the permutation; NW words a row
// (0: c.words). Every permutation entry and word is loaded before the
// first store.
template <typename W, int NW>
__device__ __forceinline__ void move_rows(const Col& c,
                                          const int* __restrict__ perm,
                                          int scatter, int chunk) {
  constexpr int R = move_rows_for(sizeof(W));
  const W* __restrict__ src = reinterpret_cast<const W*>(c.src);
  W* __restrict__ dst = reinterpret_cast<W*>(c.dst);
  const unsigned nw = NW ? NW : c.words;
  const unsigned row0 =
      static_cast<unsigned>(chunk) * (kThreads * R) + threadIdx.x;
  unsigned from[R], to[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned row = row0 + r * kThreads;
    live[r] = row < static_cast<unsigned>(c.rows_total);
    const unsigned p =
        live[r] && row < static_cast<unsigned>(c.rows_perm) ? perm[row] : row;
    from[r] = (scatter ? row : p) * nw;
    to[r] = (scatter ? p : row) * nw;
  }
  if (NW) {
    W v[R][NW ? NW : 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (live[r]) v[r][w] = src[from[r] + w];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (live[r]) dst[to[r] + w] = v[r][w];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (unsigned w = 0; live[r] && w < nw; ++w) {
        dst[to[r] + w] = src[from[r] + w];
      }
    }
  }
}

template <typename W>
__device__ __forceinline__ void move_word(const Col& c,
                                          const int* __restrict__ perm,
                                          int scatter, int chunk) {
  if (c.words == 1) {
    move_rows<W, 1>(c, perm, scatter, chunk);
  } else if (c.words == 3) {  // a float3 row; a 48-byte row of uint4s
    move_rows<W, 3>(c, perm, scatter, chunk);
  } else {
    move_rows<W, 0>(c, perm, scatter, chunk);
  }
}

// Block b moves a chunk of the column whose blocks hold b, the columns'
// blocks in column order: gathering, row i of the output is row perm[i]
// of the input; scattering (the inverse), row perm[i] of the output is
// row i of the input.
__global__ void __launch_bounds__(kThreads)
    lane_move_kernel(const Table table, const int* __restrict__ perm,
                     int scatter) {
  __shared__ Col col;
  if (threadIdx.x == 0) {  // constant indices: the table stays a parameter
    const int b = blockIdx.x;
    int j = 0;
#pragma unroll
    for (int i = 1; i < kMaxCols; ++i) {
      if (i < table.ncols && b >= table.col[i].first_block) j = i;
    }
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      if (i == j) col = table.col[i];
    }
  }
  __syncthreads();
  const Col c = col;
  const int chunk = blockIdx.x - c.first_block;
  switch (c.word) {
    case 16: move_word<uint4>(c, perm, scatter, chunk); break;
    case 8: move_word<unsigned long long>(c, perm, scatter, chunk); break;
    case 4: move_word<unsigned>(c, perm, scatter, chunk); break;
    case 2: move_word<unsigned short>(c, perm, scatter, chunk); break;
    default: move_word<unsigned char>(c, perm, scatter, chunk); break;
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

}  // namespace

extern "C" {

// The most columns a move takes.
int msn_sort_max_cols() { return kMaxCols; }

// Digit passes for keys of `bits` bits.
int msn_sort_passes(int bits) { return plan_for(bits).passes; }

// int32 words of workspace msn_sort_lanes takes for n keys of `bits` bits.
long long msn_sort_work_ints(int n, int bits) {
  return layout_for(n, plan_for(bits)).ints;
}

// perm[0..n): the stable order of key[0..n) (int32; keys in [0, 2^bits),
// any other key sorting as one value after them), bits in [0, 30],
// n > 0; `work` holds msn_sort_work_ints(n, bits) int32 words. One
// memset, then radix_upsweep_kernel and a radix_onesweep_kernel a pass,
// on `stream`; allocates nothing, reads nothing back; returns
// cudaGetLastError().
int msn_sort_lanes(const int* key, int n, int bits, int* work, int* perm,
                   void* stream) {
  if (n <= 0 || bits < 0 || bits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan = plan_for(bits);
  const Layout l = layout_for(n, plan);
  const int tiles = tiles_for(n);
  const int live = 1 << bits;
  int* hist = work + l.hist;
  // the histograms, tile counters and tile states, which lie together
  cudaError_t err = cudaMemsetAsync(
      hist, 0, static_cast<size_t>(l.zeroed - l.hist) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long chunks = (n + kHistChunk - 1) / kHistChunk;
  const int hist_blocks =
      static_cast<int>(chunks < 2LL * sms ? chunks : 2LL * sms);
  radix_upsweep_kernel<<<hist_blocks, kHistThreads, 0, s>>>(key, n, live,
                                                            plan, hist);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int* keys_in = key;
  const int* perm_in = nullptr;
  for (int pass = 0; pass < plan.passes; ++pass) {
    const bool last = pass == plan.passes - 1;
    int* keys_out = last ? nullptr : work + l.keys[pass % 2];
    int* perm_out = last ? perm : work + l.perms[pass % 2];
    const int buckets = plan.buckets[pass];
    const size_t smem = onesweep_smem(buckets);
    if ((err = cudaFuncSetAttribute(
             radix_onesweep_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess) {
      return static_cast<int>(err);
    }
    radix_onesweep_kernel<<<tiles, kSweepThreads, smem, s>>>(
        keys_in, perm_in, n, live, plan.shift[pass], plan.mask[pass],
        buckets, hist + plan.offset[pass], work + l.counters + pass,
        reinterpret_cast<unsigned*>(work + l.states) +
            static_cast<long long>(pass) * tiles,
        reinterpret_cast<unsigned*>(work + l.group_states) +
            static_cast<long long>(pass) * groups_for(n),
        work + l.counts[pass], work + l.totals[pass], keys_out, perm_out);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
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
// or scattered when `scatter`), rows up to rows_total[j] where they lie
// (each column's rows_total[j] x words[j] below 2^31). The columns' blocks
// follow each other in column order. src and dst must not overlap.
// Returns cudaGetLastError().
int msn_move_lanes(const long long* src, const long long* dst,
                   const int* word, const int* words, const int* rows_perm,
                   const int* rows_total, int ncols, const int* perm, int n,
                   int scatter, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  long long blocks = 0;
  for (int j = 0; j < ncols; ++j) {
    const long long total = static_cast<long long>(rows_total[j]) * words[j];
    if (total >= (1LL << 31) || rows_perm[j] > n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    table.col[j] = Col{reinterpret_cast<const char*>(src[j]),
                       reinterpret_cast<char*>(dst[j]), word[j], words[j],
                       rows_perm[j], rows_total[j],
                       static_cast<int>(blocks)};
    const int chunk = kThreads * move_rows_for(word[j]);
    blocks += (rows_total[j] + chunk - 1) / chunk;
  }
  table.ncols = ncols;
  if (blocks > 0) {
    lane_move_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(table, perm,
                                                            scatter);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
