// Treelet-scheduled wide-BVH traversal for Hopper (sm_90a): phase 1 (every
// ray against every treelet box) and the walk, closest hit and any hit.
//
// The walk replaces the Pallas TPU kernel built by
// moonshine_tpu/accel/treelet.py::_make_kernel(any_hit, dma_rows, K) and
// launched by treelet.py::_dispatch (both variants). It computes what that
// kernel computes, with the contract of closest_hit_packet_hbm /
// any_hit_packet_hbm: for closest hit the nearest hit in the whole tree,
// reached only through the ray's own pending treelets (its nearest one
// first, then the others in ascending id, t_best pruning across them); for
// any hit an occluder in (0, tmax), the ray stopping at its first.
// Phase 1 replaces no TPU kernel: the reference computes it in jnp
// (treelet.py:372 _pending_masks), where XLA fuses it.
//
// Inputs come from the wrapper (moonshine_tpu_torch/accel/treelet.py):
// phase 1 takes the rays in lane order and writes each ray's pending bit
// words [N, k32] (uint32 held in int32) and its nearest pending treelet (K
// if none); the walk takes the rays sorted by (nearest treelet, origin
// cell, octant), their effective tmax (dead lanes <= 0), those words and
// nearest treelets, the ptr-encoded treelet roots [K] and boxes [K, 3].
//
// Both evaluate the plain versions' expressions in their order (-fmad=false,
// IEEE division): slabs as (b - o) * inv, a box or child hit as tnear <=
// tfar && tfar >= 0 && tnear <= prune. So the pending words, the nearest
// treelets and every hit are equal to the plain versions' bit for bit.
//
// Phase 1. Bound by operations: ~25 per (ray, treelet) pair against ~80
// bytes a ray. One thread per ray; a block stages the boxes of up to
// kTileWords * 32 treelets in shared memory (two float4s each, read by all
// threads at once) and makes each 32-treelet word's union box from them;
// keeps each 32-bit word in a register while it tests the word's
// treelets, parks the words in shared memory and writes the block's rows
// out together. Two cuts of the work, neither of which changes an output:
//  - a ray tests a word's union first and, where it misses it, none of
//    the word's 32 boxes (the word is 0). Treelet ids follow the plan's
//    depth-first order, so a word's treelets are neighbours in space and
//    a ray misses most words. Exact: the union is per axis the least and
//    greatest of the word's planes, and the rounding of (b - o) * inv is
//    monotone in b, so a ray that enters a box enters the union (the
//    argument of the walk's node-root skip below);
//  - the block's live rays are packed onto its first threads (a ballot a
//    warp and the warps' counts in order), so a warp holds live rays or
//    none, and warps with none test nothing; each writes its words and
//    nearest treelet into its own row, dead rows get 0 and K.
// The nearest treelet is a sequential strict-< scan over k = 0..K-1 from
// (3e37, K): the first minimum, as the plain version's per-word argmin
// and strict `better`; a skipped word holds no hit, so the scan is the
// same.
//
// The walk. Bound on this card, as traverse.cu, by dependent row loads,
// issue slots and warp divergence. One thread per ray (lane groups lost on
// 8-wide trees); each visit made cheap:
//  - the stack sits in shared memory, one column a thread, sized by the
//    deepest treelet subtree (WideBVH.treelet_stack), not the whole tree;
//    blocks shrink from 128 threads where a deep bound would not fit;
//  - node rows are read as float4s, four children a field (15 loads for
//    an 8-wide node, not 57), leaf rows four slots a field where the slot
//    count allows it;
//  - registers are capped at 64 (8 blocks of 128 threads an SM) at the
//    cost of a few spilled words: latency is hidden by more warps;
//  - each thread visits its rows in its own stack order, but a warp
//    visits, each round, the kind of row (node or leaf) most of its threads
//    wait on, while the rest wait: fewer rounds pay for both kinds;
//  - a closest-hit ray skips a pending node-root treelet whose box it
//    enters beyond its t_best: the box is the exact min/max of the root
//    row's child boxes (wide.py _treelet_boxes) and rounding of
//    (b - o) * inv is monotone in b, so every child would fail tnear <=
//    t_best and the root visit would push nothing. Leaf-root treelets are
//    walked as before (their box comes from vertices). The plain version
//    applies the same rule. The roots and boxes are read through L1: a
//    copy into each block's shared memory cost more than it saved.

#include <atomic>
#include <cmath>

#include "visit.cuh"

namespace {

using namespace msn;

constexpr int kPendBlock = 128;  // phase 1: rays a block
constexpr int kTileWords = 16;   // phase 1: 512 treelets of boxes a tile
constexpr int kWalkBlock = 128;  // the walk: threads a block, at most
constexpr int kSharedMax = 232448;  // a block's shared memory (227 KB)
constexpr float kFar = 3.0e37f;     // the plain version's "no entry"

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Entry and exit t of a ray into a box, the plain versions' expressions.
__device__ __forceinline__ void slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, const float o[3],
                                     const float inv[3], float& tn,
                                     float& tf) {
  const float a0 = (lx - o[0]) * inv[0];
  const float b0 = (hx - o[0]) * inv[0];
  const float a1 = (ly - o[1]) * inv[1];
  const float b1 = (hy - o[1]) * inv[1];
  const float a2 = (lz - o[2]) * inv[2];
  const float b2 = (hz - o[2]) * inv[2];
  tn = fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
  tf = fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
}

// The union box of each 32-treelet word of the tile: per axis the least
// of min(lo, hi) and the greatest of max(lo, hi) over the word's treelets
// (the slab test takes a box's two planes in either order, so an inverted
// box counts as the box between them). Warp w makes words w, w + 4, ...
__device__ __forceinline__ void word_unions(const float4* boxes, int nw,
                                            int nk, float4* unions) {
  const int lane = threadIdx.x & 31;
  for (int wl = threadIdx.x >> 5; wl < nw; wl += kPendBlock / 32) {
    const int j = 32 * wl + lane;
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    if (j < nk) {
      const float4 p = boxes[2 * j];
      const float4 q = boxes[2 * j + 1];
      const float a[3] = {p.x, p.y, p.z}, b[3] = {p.w, q.x, q.y};
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(a[c], b[c]);
        hi[c] = fmaxf(a[c], b[c]);
      }
    }
    for (int s = 16; s > 0; s >>= 1) {
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], s));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], s));
      }
    }
    if (lane == 0) {
      unions[2 * wl] = make_float4(lo[0], lo[1], lo[2], hi[0]);
      unions[2 * wl + 1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kPendBlock) pending_kernel(
    const float* __restrict__ t_lo, const float* __restrict__ t_hi, int k,
    int k32, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, const float* __restrict__ t_eff, int n,
    int32_t* __restrict__ pend, int32_t* __restrict__ nearest) {
  __shared__ float4 boxes[2 * 32 * kTileWords];
  __shared__ float4 unions[2 * kTileWords];
  __shared__ uint32_t words[kPendBlock * (kTileWords + 1)];
  __shared__ int packed[kPendBlock];  // the block's live rows, in order
  __shared__ int near_of[kPendBlock];
  __shared__ int warp_live[kPendBlock / 32];
  const int base = blockIdx.x * kPendBlock;
  const int rows = min(kPendBlock, n - base);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const bool live = t < rows && t_eff[base + t] > 0.0f;
  // pack the live rows onto the first threads: a ballot a warp, then the
  // warps' counts summed in order
  const unsigned vote = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[t >> 5] = __popc(vote);
  __syncthreads();
  int before = 0, n_live = 0;
  for (int w = 0; w < kPendBlock / 32; ++w) {
    before += w < (t >> 5) ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (live) packed[before + __popc(vote & ((1u << lane) - 1u))] = t;
  __syncthreads();
  // thread t < n_live tests the ray of row r; the other threads none
  const bool busy = t < n_live;
  const int r = busy ? packed[t] : t;
  float o[3] = {0.0f, 0.0f, 0.0f}, inv[3] = {0.0f, 0.0f, 0.0f};
  float tmax = 0.0f;
  if (busy) {
    const size_t i = base + r;
    tmax = t_eff[i];
    for (int c = 0; c < 3; ++c) {
      o[c] = ray_o[3 * i + c];
      inv[c] = safe_inv(ray_d[3 * i + c]);
    }
  }
  float best_t = kFar;
  int best_k = k;
  for (int w0 = 0; w0 < k32; w0 += kTileWords) {
    const int nw = min(kTileWords, k32 - w0);
    const int k0 = 32 * w0;
    const int nk = min(32 * nw, k - k0);
    if (n_live > 0) {
      for (int j = t; j < nk; j += kPendBlock) {
        const float* lo = t_lo + 3 * (size_t)(k0 + j);
        const float* hi = t_hi + 3 * (size_t)(k0 + j);
        boxes[2 * j] = make_float4(lo[0], lo[1], lo[2], hi[0]);
        boxes[2 * j + 1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
      }
      __syncthreads();
      word_unions(boxes, nw, nk, unions);
      __syncthreads();
    }
    for (int wl = 0; wl < nw; ++wl) {
      uint32_t bits = 0u;
      const int kb = 32 * wl;
      // treelet kb + b of the tile against the ray: bit b of the word
      auto test = [&](int b) {
        const float4 p = boxes[2 * (kb + b)];
        const float4 q = boxes[2 * (kb + b) + 1];
        float tn, tf;
        slab(p.x, p.y, p.z, p.w, q.x, q.y, o, inv, tn, tf);
        if (tn <= tf && tf >= 0.0f && tn <= tmax) {
          bits |= 1u << b;
          const float te = fmaxf(tn, 0.0f);
          if (te < best_t) {  // a miss's 3e37 never beats best_t
            best_t = te;
            best_k = k0 + kb + b;
          }
        }
      };
      bool enters = false;
      if (busy) {  // the word's union first: a ray that misses it misses
        // each of its boxes, as (b - o) * inv rounds monotonically in b
        const float4 p = unions[2 * wl];
        const float4 q = unions[2 * wl + 1];
        float tn, tf;
        slab(p.x, p.y, p.z, p.w, q.x, q.y, o, inv, tn, tf);
        enters = tn <= tf && tf >= 0.0f && tn <= tmax;
      }
      // unrolled, so that b and the box offsets are constants
      if (enters && kb + 32 <= nk) {
#pragma unroll
        for (int b = 0; b < 32; ++b) test(b);
      } else if (enters) {  // the last, partial word
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          if (kb + b < nk) test(b);
        }
      }
      // a packed thread fills its ray's row, a dead row's own thread 0
      if (busy) words[r * (kTileWords + 1) + wl] = bits;
      if (!live) words[t * (kTileWords + 1) + wl] = 0u;
    }
    __syncthreads();
    for (int e = t; e < rows * nw; e += kPendBlock) {
      const int rr = e / nw;
      const int c = e - rr * nw;
      pend[(size_t)(base + rr) * k32 + w0 + c] =
          (int32_t)words[rr * (kTileWords + 1) + c];
    }
    __syncthreads();
  }
  if (busy) near_of[r] = best_k;
  if (!live) near_of[t] = k;
  __syncthreads();
  if (t < rows) nearest[base + t] = near_of[t];
}

// A child slot's test: occupied, and the reference treelet kernel's hit.
__device__ __forceinline__ unsigned child_hit(float ptr, float lx, float ly,
                                              float lz, float hx, float hy,
                                              float hz, const float o[3],
                                              const float inv[3],
                                              float prune) {
  if (ptr == -1.0f) return 0u;
  float tn, tf;
  slab(lx, ly, lz, hx, hy, hz, o, inv, tn, tf);
  return (tn <= tf && tf >= 0.0f && tn <= prune) ? 1u : 0u;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// A leaf row four slots at a time (slots % 4 == 0): field f of slots
// q..q+3 is one float4 at row + f * slots + q. Slots in ascending order,
// as visit_leaf.
template <bool AnyHit>
__device__ __forceinline__ bool visit_leaf4(
    const float* row, int slots, const float o[3], const float d[3],
    float tmax, float& t_best, int& best_tri, float& best_u, float& best_v) {
  for (int q = 0; q < slots; q += 4) {
    const float4 id = ld4(row + 9 * slots + q);
    if (id.x < 0.0f && id.y < 0.0f && id.z < 0.0f && id.w < 0.0f) continue;
    float4 f[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) f[c] = ld4(row + c * slots + q);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float tid = lane(id, c);
      if (tid < 0.0f) continue;  // empty slot
      const float v0[3] = {lane(f[0], c), lane(f[1], c), lane(f[2], c)};
      const float e1[3] = {lane(f[3], c), lane(f[4], c), lane(f[5], c)};
      const float e2[3] = {lane(f[6], c), lane(f[7], c), lane(f[8], c)};
      if (AnyHit) {
        if (tri_any(v0, e1, e2, o, d, tmax)) return true;
      } else {
        float t, u, v;
        if (tri_closest(v0, e1, e2, o, d, t_best, t, u, v)) {
          t_best = t;
          best_tri = (int)tid;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  return false;
}

// Threads a walk block gets: its stacks (stack_depth rows of `threads`
// int32, column t for thread t) must fit a block's shared memory.
int walk_threads(int stack_depth) {
  for (int t = kWalkBlock; t >= 32; t /= 2) {
    if (4 * t * stack_depth <= kSharedMax) return t;
  }
  return 0;
}

constexpr int kDone = -1;  // a ray's next row when it has none (-1 is
                           // the empty child pointer, never pushed)

template <bool AnyHit, int W>
__global__ void __launch_bounds__(kWalkBlock, 8) treelet_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
    int node_stride, int leaf_stride, int slots,
    const int32_t* __restrict__ roots, const float* __restrict__ t_lo,
    const float* __restrict__ t_hi, int k, const int32_t* __restrict__ pend,
    int k32, const int32_t* __restrict__ first,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_eff, int n, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
  extern __shared__ int stacks[];
  int* stack = stacks + threadIdx.x;
  const int col = blockDim.x;  // a stack entry's stride
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;  // threads past n stay for the warp's votes

  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float inv[3] = {0.0f, 0.0f, 0.0f};
  float tmax = 0.0f;
  int f = k;
  if (in) {
    for (int c = 0; c < 3; ++c) {
      o[c] = ray_o[3 * (size_t)i + c];
      d[c] = ray_d[3 * (size_t)i + c];
      inv[c] = safe_inv(d[c]);
    }
    tmax = t_eff[i];
    f = first[i];
  }
  const bool vec_leaves = slots % 4 == 0;
  const int32_t* words = pend + (size_t)i * k32;

  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occluded = false;

  // The ray's treelets in its order: its nearest (f < k) first, then the
  // other pending ones in ascending id, a closest-hit ray skipping a
  // node-root treelet whose box it enters beyond its t_best (the box is
  // the min/max of the root row's child boxes: no child would pass).
  bool first_left = tmax > 0.0f && f < k;
  int w = tmax > 0.0f ? -1 : k32;
  unsigned int bits = 0u;
  auto next_root = [&]() -> int {
    if (first_left) {
      first_left = false;
      return __ldg(roots + f);
    }
    for (;;) {
      while (bits == 0u) {
        if (++w >= k32) return kDone;
        bits = (unsigned int)__ldg(words + w);
      }
      const int t = w * 32 + (__ffs(bits) - 1);
      bits &= bits - 1u;
      if (t == f) continue;
      const int root = __ldg(roots + t);
      if (!AnyHit && root >= 0) {
        float tn, tf;
        slab(ld(t_lo + 3 * t), ld(t_lo + 3 * t + 1), ld(t_lo + 3 * t + 2),
             ld(t_hi + 3 * t), ld(t_hi + 3 * t + 1), ld(t_hi + 3 * t + 2), o,
             inv, tn, tf);
        if (tn > t_best) continue;
      }
      return root;
    }
  };

  // Each thread visits its rows in exactly the order of a stack walk (pop
  // the last pushed; an empty stack takes the next treelet's root); a warp
  // visits, each round, the kind of row (node or leaf) that most of its
  // threads wait on, and the others wait.
  int top = 0;
  int item = in ? next_root() : kDone;
  for (;;) {
    const unsigned nodes_due = __ballot_sync(0xffffffffu, item >= 0);
    const unsigned leaves_due = __ballot_sync(0xffffffffu, item <= -2);
    if ((nodes_due | leaves_due) == 0u) break;
    const bool node_round = __popc(nodes_due) >= __popc(leaves_due);
    if (node_round ? item < 0 : item > -2) continue;
    if (item >= 0) {
      const float* row = nodes + (size_t)item * node_stride;
      const float axis = ld(row + 7 * W);
      const float dax = axis < 0.5f ? d[0] : (axis < 1.5f ? d[1] : d[2]);
      const float prune = AnyHit ? tmax : t_best;
      unsigned mask = 0u;
#pragma unroll
      for (int q = 0; q < W; q += 4) {
        const float4 p = ld4(row + 6 * W + q);
        const float4 lx = ld4(row + 0 * W + q);
        const float4 ly = ld4(row + 1 * W + q);
        const float4 lz = ld4(row + 2 * W + q);
        const float4 hx = ld4(row + 3 * W + q);
        const float4 hy = ld4(row + 4 * W + q);
        const float4 hz = ld4(row + 5 * W + q);
        mask |= child_hit(p.x, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, o, inv,
                          prune) << q;
        mask |= child_hit(p.y, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, o, inv,
                          prune) << (q + 1);
        mask |= child_hit(p.z, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, o, inv,
                          prune) << (q + 2);
        mask |= child_hit(p.w, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, o, inv,
                          prune) << (q + 3);
      }
      // push far first: near children sit at low slots, so a ray running
      // forward on the axis pushes the highest slot first
      if (dax >= 0.0f) {
        while (mask != 0u) {
          const int j = 31 - __clz(mask);
          mask ^= 1u << j;
          stack[col * top++] = (int)ld(row + 6 * W + j);
        }
      } else {
        while (mask != 0u) {
          const int j = __ffs(mask) - 1;
          mask &= mask - 1u;
          stack[col * top++] = (int)ld(row + 6 * W + j);
        }
      }
    } else {
      const float* row = leaves + (size_t)(-2 - item) * leaf_stride;
      const bool hit =
          vec_leaves ? visit_leaf4<AnyHit>(row, slots, o, d, tmax, t_best,
                                           best_tri, best_u, best_v)
                     : visit_leaf<AnyHit>(row, slots, o, d, tmax, t_best,
                                          best_tri, best_u, best_v);
      if (hit) {  // any hit: the first occluder ends the ray
        occluded = true;
        item = kDone;
        continue;
      }
    }
    item = top > 0 ? stack[col * --top] : next_root();
  }

  if (!in) return;
  if (AnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    t_out[i] = best_tri >= 0 ? t_best : tmax;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

template <bool AnyHit, int W>
int launch_walk(const float* nodes, const float* leaves, int node_stride,
                int leaf_stride, int slots, const int32_t* roots,
                const float* t_lo, const float* t_hi, int k, int stack_depth,
                const int32_t* pend, int k32, const int32_t* first,
                const float* ray_o, const float* ray_d, const float* t_eff,
                int n, float* t_out, int32_t* tri_out, float* u_out,
                float* v_out, uint8_t* occ_out, cudaStream_t stream) {
  // the >48 KB opt-in, once per kernel and device (a function attribute
  // is the current device's; a mesh's shards launch on several)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((raised.load() & bit) == 0) {
    e = cudaFuncSetAttribute(treelet_kernel<AnyHit, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedMax);
    if (e != cudaSuccess) return (int)e;
    raised.fetch_or(bit);
  }
  const int threads = walk_threads(stack_depth);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int shared = 4 * threads * stack_depth;
  treelet_kernel<AnyHit, W><<<(n + threads - 1) / threads, threads, shared,
                              stream>>>(
      nodes, leaves, node_stride, leaf_stride, slots, roots, t_lo, t_hi, k,
      pend, k32, first, ray_o, ray_d, t_eff, n, t_out, tri_out, u_out, v_out,
      occ_out);
  return (int)cudaGetLastError();
}

template <bool AnyHit>
int launch_width(int width, const float* nodes, const float* leaves,
                 int node_stride, int leaf_stride, int slots,
                 const int32_t* roots, const float* t_lo, const float* t_hi,
                 int k, int stack_depth, const int32_t* pend, int k32,
                 const int32_t* first, const float* ray_o, const float* ray_d,
                 const float* t_eff, int n, float* t_out, int32_t* tri_out,
                 float* u_out, float* v_out, uint8_t* occ_out, void* stream) {
#define MSN_WALK(W)                                                        \
  return launch_walk<AnyHit, W>(                                           \
      nodes, leaves, node_stride, leaf_stride, slots, roots, t_lo, t_hi, k, \
      stack_depth, pend, k32, first, ray_o, ray_d, t_eff, n, t_out,        \
      tri_out, u_out, v_out, occ_out, (cudaStream_t)stream)
  switch (width) {
    case 8: MSN_WALK(8);
    case 16: MSN_WALK(16);
    case 24: MSN_WALK(24);
    case 32: MSN_WALK(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSN_WALK
}

}  // namespace

extern "C" {

int msn_treelet_stack_capacity() { return kStackCap; }

// Threads a walk block gets for this stack bound (0: it cannot be
// launched).
int msn_treelet_block(int stack_depth) { return walk_threads(stack_depth); }

// Each entry point launches on `stream` and returns cudaGetLastError().
int msn_treelet_pending(const float* t_lo, const float* t_hi, int k,
                        const float* ray_o, const float* ray_d,
                        const float* t_eff, int n, int32_t* pend,
                        int32_t* nearest, void* stream) {
  const int grid = (n + kPendBlock - 1) / kPendBlock;
  pending_kernel<<<grid, kPendBlock, 0, (cudaStream_t)stream>>>(
      t_lo, t_hi, k, (k + 31) / 32, ray_o, ray_d, t_eff, n, pend, nearest);
  return (int)cudaGetLastError();
}

int msn_treelet_closest_hit(
    const float* nodes, const float* leaves, int node_stride,
    int leaf_stride, int width, int slots, const int32_t* roots,
    const float* t_lo, const float* t_hi, int k, int stack_depth,
    const int32_t* pend, int k32, const int32_t* first, const float* ray_o,
    const float* ray_d, const float* t_eff, int n, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, void* stream) {
  return launch_width<false>(width, nodes, leaves, node_stride, leaf_stride,
                             slots, roots, t_lo, t_hi, k, stack_depth, pend,
                             k32, first, ray_o, ray_d, t_eff, n, t_out,
                             tri_out, u_out, v_out, nullptr, stream);
}

int msn_treelet_any_hit(
    const float* nodes, const float* leaves, int node_stride,
    int leaf_stride, int width, int slots, const int32_t* roots,
    const float* t_lo, const float* t_hi, int k, int stack_depth,
    const int32_t* pend, int k32, const int32_t* first, const float* ray_o,
    const float* ray_d, const float* t_eff, int n, uint8_t* occ_out,
    void* stream) {
  return launch_width<true>(width, nodes, leaves, node_stride, leaf_stride,
                            slots, roots, t_lo, t_hi, k, stack_depth, pend,
                            k32, first, ray_o, ray_d, t_eff, n, nullptr,
                            nullptr, nullptr, nullptr, occ_out, stream);
}

}  // extern "C"
