// The group walk shared by the packet kernels (traverse.cu, over rows) and
// the format-V kernels (vpacket.cu, over tiles): everything but the reads
// of a record, which a format type F supplies.
//
//   F::lanes<W>()      lanes a ray on a tree of width W (a power of two)
//   F::node<W, G>(rec, k, gmask, ray, prune, stack, top)
//                      one internal visit by the group: lane k tests its
//                      children, the group pushes the hits where
//                      packet._walk puts them (push_slot) and returns the
//                      new top
//   F::leaf<AnyHit, G>(rec, slots, k, gmask, ray, t_far, tri, u, v)
//                      one leaf visit: lane k tests its slots, in rising
//                      slot order, and hands leaf_result its best (or its
//                      occlusion)
//
// A format must give lane k the children and slots j with j % G == k, so
// that the group's pushes and leaf choice are the ones below for every
// format.
//
// The walk (see traverse.cu's header for why each part is there):
//   - a group of G lanes traces one ray; 64 groups a block, each with a
//     stack of stack_depth entries in dynamic shared memory after the top
//     R records (node records 0..R-1, copied once a block; visits to them
//     read shared memory);
//   - blocks are persistent; a warp takes a batch of 32 neighbouring rays
//     from a global counter (zeroed on the stream by the launch), retires
//     the dead ones there, and hands the live ones to its groups; closest
//     hit takes one round's worth after a batch over a quarter live;
//   - the warp loops as one, each iteration making the kind of visit
//     (node or leaf) that more of its groups wait on; a group keeps its
//     own order of visits;
//   - registers are capped so that 1024 threads fit an SM (64 a thread).
//
// Numerics: every expression is visit.cuh's, in packet._walk's order, so
// with -fmad=false the results equal the plain torch versions bit for
// bit, equal-t ties included.

#pragma once

#include <algorithm>
#include <climits>
#include <mutex>

#include "visit.cuh"

namespace msn {

// groups per block: packet.GROUPS_PER_BLOCK counts the same
constexpr int kBlockGroups = 64;
// registers are capped so that kSmThreads threads fit an SM (64 a thread
// at 1024); uncapped, the visits' loads take ~100-120
constexpr int kSmThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

template <int G>
__host__ __device__ constexpr int block_threads() {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
                "a group is a power-of-two part of a warp");
  static_assert(kBlockGroups * G % 32 == 0 && kBlockGroups * G <= 1024,
                "whole warps, at most 1024 threads");
  return kBlockGroups * G;
}

struct Ray {
  float o[3], d[3], inv[3], oinv[3];
};

// The stack offset above top of hit child j among the group's hits `all`,
// as packet._walk pushes them: far child first, by the ray's sign on the
// node's axis.
__device__ __forceinline__ int push_slot(unsigned all, int j, bool fwd) {
  const int below = __popc(all & ((1u << j) - 1u));
  const int above = __popc(all) - below - 1;
  return fwd ? above : below;
}

// The end of a leaf visit. Closest hit: each lane brings (bt, bs), its
// first slot of least t below t_far (bs = INT_MAX for none), and the u, v
// and triangle of that slot; the group takes the lexicographic minimum of
// (t, slot) by xor shuffles, which is the slot that the sequential strict-<
// loop keeps, and lowers t_far to it. Any hit: true when a lane occludes.
template <bool AnyHit, int G>
__device__ __forceinline__ bool leaf_result(unsigned gmask, bool occ,
                                            float bt, int bs, float bu,
                                            float bv, int btri, float& t_far,
                                            int& best_tri, float& best_u,
                                            float& best_v) {
  if constexpr (AnyHit) {
    return __any_sync(gmask, occ);
  } else {
    for (int off = G / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(gmask, bt, off);
      const int os = __shfl_xor_sync(gmask, bs, off);
      if (ot < bt || (ot == bt && os < bs)) {
        bt = ot;
        bs = os;
      }
    }
    if (bs != INT_MAX) {  // the lane that owns slot bs holds its u, v, tri
      const int owner = bs % G;
      t_far = bt;
      best_u = __shfl_sync(gmask, bu, owner, G);
      best_v = __shfl_sync(gmask, bv, owner, G);
      best_tri = __shfl_sync(gmask, btri, owner, G);
    }
    return false;
  }
}

template <class F, bool AnyHit, int W, int G = F::template lanes<W>()>
__global__ void __launch_bounds__(block_threads<G>(),
                                  kSmThreads / block_threads<G>())
    traverse_kernel(const float* __restrict__ nodes,
                    const float* __restrict__ leaves, int node_stride,
                    int leaf_stride, int slots,
                    const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const float* __restrict__ t_max,
                    const uint8_t* __restrict__ active, int n, int top_rows,
                    int stack_depth, unsigned* __restrict__ next_ray,
                    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    uint8_t* __restrict__ occ_out) {
  constexpr unsigned kGroupsPerWarp = 32 / G;  // rays a warp traces at once
  // records 0..top_rows-1 into shared memory as whole float4s (records
  // are multiples of 4 floats, 16-byte aligned), then the groups' stacks
  extern __shared__ float4 smem[];
  const int top_floats = top_rows * node_stride;
  const float4* src = reinterpret_cast<const float4*>(nodes);
  for (int q = threadIdx.x; q < top_floats / 4; q += block_threads<G>()) {
    smem[q] = __ldg(src + q);
  }
  __syncthreads();
  const float* top_s = reinterpret_cast<const float*>(smem);

  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kAll : ((1u << (G & 31)) - 1u) << (lane & ~(G - 1));
  int* stack = reinterpret_cast<int*>(smem + top_floats / 4) +
               (threadIdx.x / G) * stack_depth;

  Ray r;
  // t_far: the ray's t_max for any hit; for closest hit the best t so far,
  // which stays t_max on a miss (so the miss writes the caller's t_max)
  float t_far = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, top = 0;
  // the warp's batch of rays base ..: bit p of waiting is live ray base + p
  // that no group took yet; i is the group's ray
  unsigned base = 0, waiting = 0, i = 0;
  bool dense = false;  // over a quarter of the warp's last batch was live
  bool live = false, occluded = false;
  for (;;) {
    bool start = false;  // the group starts ray i in this iteration
    if (__all_sync(kAll, !live)) {  // every group is done: the next rays
      while (waiting == 0) {  // a new batch; each lane retires a dead ray
        // 32 rays, but closest hit takes one round's worth after a dense
        // batch: measured faster there (PERF.md), any hit slower
        const unsigned take = !AnyHit && dense ? kGroupsPerWarp : 32u;
        if (lane == 0) base = atomicAdd(next_ray, take);
        base = __shfl_sync(kAll, base, 0);
        if (base >= (unsigned)n) break;
        const unsigned j = base + lane;
        bool alive = false;
        if (lane < take && j < (unsigned)n) {
          const float tj = __ldg(t_max + j);
          alive = (active == nullptr || active[j]) && tj > 0.0f;
          if (!alive) {  // inactive or tmax <= 0: never traversed
            if (AnyHit) {
              occ_out[j] = 0;
            } else {
              t_out[j] = tj;
              tri_out[j] = -1;
              u_out[j] = v_out[j] = 0.0f;
            }
          }
        }
        waiting = __ballot_sync(kAll, alive);
        dense = 4u * __popc(waiting) > take;
      }
      if (waiting == 0) break;  // the counter ran past n
      unsigned mine = waiting;  // group g takes the g-th waiting ray
      for (int g = 0; g < lane / G; ++g) mine &= mine - 1;
      start = mine != 0;
      i = base + __ffs(mine) - 1;
      for (unsigned g = 0; g < kGroupsPerWarp; ++g) waiting &= waiting - 1;
    }
    if (start) {  // only live rays start: t_max is above 0
      for (int c = 0; c < 3; ++c) {
        r.o[c] = __ldg(ray_o + 3 * (size_t)i + c);
        r.d[c] = __ldg(ray_d + 3 * (size_t)i + c);
        r.inv[c] = safe_inv(r.d[c]);
        r.oinv[c] = r.o[c] * r.inv[c];
      }
      t_far = __ldg(t_max + i);
      best_u = best_v = 0.0f;
      best_tri = -1;
      occluded = false;
      if (k == 0) stack[0] = 0;
      top = 1;
      live = true;
    }
    __syncwarp();

    // the entry each group would pop next; the warp visits the kind more
    // groups wait on
    const int node = live && top > 0 ? stack[top - 1] : 0;
    const bool at_node = live && top > 0 && node >= 0;
    const bool at_leaf = live && top > 0 && node < 0;
    const int nodes_waiting = __popc(__ballot_sync(kAll, at_node));
    const int leaves_waiting = __popc(__ballot_sync(kAll, at_leaf));
    if (nodes_waiting >= leaves_waiting ? at_node : at_leaf) {
      --top;
      if (node >= 0) {
        const float* rec = node < top_rows
                               ? top_s + node * node_stride
                               : nodes + (size_t)node * node_stride;
        top = F::template node<W, G>(rec, k, gmask, r, t_far, stack, top);
      } else if (F::template leaf<AnyHit, G>(
                     leaves + (size_t)(-2 - node) * leaf_stride, slots, k,
                     gmask, r, t_far, best_tri, best_u, best_v)) {
        occluded = true;
        top = 0;
      }
    }
    __syncwarp();

    if (live && top == 0) {  // the ray is done
      if (k == 0) {
        if (AnyHit) {
          occ_out[i] = occluded ? 1 : 0;
        } else {
          t_out[i] = t_far;
          tri_out[i] = best_tri;
          u_out[i] = best_u;
          v_out[i] = best_v;
        }
      }
      live = false;
    }
  }
}

// Dynamic shared memory of one block: the top records, then one stack of
// stack_depth entries per group.
inline size_t shared_bytes(int top_rows, int node_stride, int stack_depth) {
  return sizeof(float) * (size_t)top_rows * node_stride +
         sizeof(int) * (size_t)kBlockGroups * stack_depth;
}

// Launch the kernel for width W on as many blocks as the SMs hold at this
// shared-memory size (no more than the rays need). Returns a cudaError_t.
template <class F, bool AnyHit, int W>
int launch(const float* nodes, const float* leaves, int node_stride,
           int leaf_stride, int slots, const float* ray_o,
           const float* ray_d, const float* t_max, const uint8_t* active,
           int n, int top_rows, int stack_depth, unsigned* next_ray,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           uint8_t* occ_out, cudaStream_t stream) {
  constexpr int kThreads = block_threads<F::template lanes<W>()>();
  const auto kernel = traverse_kernel<F, AnyHit, W>;
  if (top_rows < 0 || stack_depth < 1 || stack_depth > kStackCap ||
      slots > 32 || node_stride % 4 != 0 || ((uintptr_t)nodes & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = shared_bytes(top_rows, node_stride, stack_depth);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the blocks the card holds at this size, asked once per device and size
  // (the offline path launches ~160 times a sample on one tree)
  static std::mutex mu;
  static int opted_dev = -1, cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> hold(mu);
    if (dev == cached_dev && smem == cached_smem) blocks = cached_blocks;
  }
  if (blocks == 0) {
    int sms = 0, max_smem = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {  // all that a block may hold
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess && dev != opted_dev) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    std::lock_guard<std::mutex> hold(mu);
    opted_dev = cached_dev = dev;
    cached_smem = smem;
    cached_blocks = blocks;
  }
  const long long need = (n + kThreads - 1) / kThreads;  // 32 rays a warp
  const int grid = (int)std::min((long long)blocks, need);
  err = cudaMemsetAsync(next_ray, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(
      nodes, leaves, node_stride, leaf_stride, slots, ray_o, ray_d, t_max,
      active, n, top_rows, stack_depth, next_ray, t_out, tri_out, u_out,
      v_out, occ_out);
  return (int)cudaGetLastError();
}

// The kernel for the tree's width: 8, 16, 24 or 32 (accel/wide.py).
template <class F, bool AnyHit, class... Args>
int launch_width(int width, Args... args) {
  switch (width) {
    case 8: return launch<F, AnyHit, 8>(args...);
    case 16: return launch<F, AnyHit, 16>(args...);
    case 24: return launch<F, AnyHit, 24>(args...);
    case 32: return launch<F, AnyHit, 32>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Lanes per ray on a tree of this width (0 for a width the kernel lacks).
template <class F>
int width_lanes(int width) {
  switch (width) {
    case 8: return F::template lanes<8>();
    case 16: return F::template lanes<16>();
    case 24: return F::template lanes<24>();
    case 32: return F::template lanes<32>();
    default: return 0;
  }
}

}  // namespace msn
