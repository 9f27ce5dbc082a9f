// Wide-BVH ray traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the two Pallas TPU kernels built by
// moonshine_tpu/accel/packet.py::_make_kernel (any_hit=False reached via
// _closest_impl / closest_hit_packet[_hbm]; any_hit=True via _anyhit_impl /
// any_hit_packet[_hbm]). One template on AnyHit serves both, and one kernel
// serves both residencies: the card has no VMEM/HBM split to choose.
//
// What bounds it. The work per ray is a chain of dependent visits (pop ->
// row -> child tests -> pushes), about 4 node and 1.5 leaf visits per
// camera ray on the 24/24 room tree, each a row of 113..256 floats laid
// out SoA across the children: ~25 flops per child slot and 54-55 per
// triangle slot, an operations bound (67 TFLOP/s, which assumes fused
// multiply-adds; with -fmad=false every multiply and add is its own
// instruction, so the realistic ceiling is about twice the bound). The
// first kernel, one thread per ray, ran 15-20x above it: each visit serial
// in one lane, seven scalar loads per child, lanes idle where rays
// diverged, the stack in local memory.
//
// Design:
//   - A group of G lanes traces one ray. Lane k takes children k, k + G,
//     ... of a node and slots k, k + G, ... of a leaf, so for each field
//     the group reads neighbouring floats of the SoA row.
//   - The node's hit mask (widths 8..32 fit one word) is the OR over the
//     group (__reduce_or_sync on the group's mask, never the full warp's:
//     the groups of a warp diverge). Each lane writes its hit children to
//     the stack where packet._walk pushes them: far first by the ray's sign
//     on the node's axis, i.e. position top + popc(hits above j) when the
//     ray runs forward, top + popc(hits below j) otherwise.
//   - A closest-hit leaf is a reduction: each lane keeps its first slot of
//     least t that beats the group's best t from before the leaf, and the
//     group takes the lexicographic minimum of (t, slot) by xor shuffles.
//     That is exactly what the sequential strict-< loop of visit.cuh keeps.
//     An any-hit leaf is __any_sync over the group's triangle tests.
//   - Each group's stack lives in dynamic shared memory, max_stack entries
//     (93 on the room tree; at most kStackCap = 512); a block holds 64
//     groups, so the stacks take at most 128 KB.
//   - The tree is breadth-first (accel/wide.py), so rows 0..R-1 with
//     R = 1 + (internal children of the root) are the root and level 1.
//     Each block copies them into shared memory once (at most 33 rows of
//     1 KB); visits to node ids below R read them there. R comes from the
//     host (packet.kernel_layout). Node rows are read through generic
//     loads, so that groups at either kind of row share one instruction
//     stream.
//   - Blocks are persistent (as many as the SMs hold). A warp takes a
//     batch of neighbouring rays from a global counter (an int32 the
//     wrapper allocates and the launch zeroes on the stream); each lane
//     retires its ray there if it is dead, and the groups take the live
//     ones 32 / G at a time, a round. A batch is 32 rays, so that a batch
//     of dead lanes (the offline path's late segments: 921,600 lanes, few
//     live) costs one atomic and one coalesced pass; closest hit takes one
//     round's worth after a batch that was over a quarter live, which
//     measured faster on dense camera rays (any hit measured slower so).
//   - The warp loops as one: each iteration every group with a ray makes
//     at most one visit, and the warp makes the kind of visit (node or
//     leaf) more of its groups wait on, so that the two bodies do not run
//     one after the other in one iteration. A group that waits keeps its
//     own order of visits.
//   - The kernel is built for each tree width W (8, 16, 24, 32), so that a
//     lane's child loop and the row's field offsets are constants, and G
//     follows W: 2 lanes a ray up to 16-wide, 4 above (4-8 children a
//     lane).
//
// The shape (G per width, 64 groups a block, registers for 1024 threads
// an SM, rounds of 32 / G rays in lockstep, the plain copy of the top
// rows) is the fastest of the alternatives measured on an H100
// (PERF.md): other group sizes, 32 or 128 groups a block, more registers,
// groups that run ahead of their warp's round, the bulk async copy, a
// second copy of the visit reading global rows through __ldg, and node
// and leaf visits in one iteration. They are not options:
// scripts/compare_traverse.py times this kernel against the format-V
// kernel, R = 0 and an earlier checkout's kernel on the same rays.
//
// Numerics: the expressions and their order are visit.cuh's and the old
// kernel's, built with -fmad=false and IEEE division, and the visits, push
// order and leaf choice are packet._walk's, so t, tri, u, v and the
// occlusion byte equal the plain torch versions (accel/packet.py) bit for
// bit, equal-t ties included.
//
// Contract (as the JAX wrappers have it): a lane with active == 0 has its
// tmax replaced by -1e30 and is never traversed; tmax <= 0 marks a dead
// lane. Closest hit writes t = the caller's tmax, tri = -1, u = v = 0 on a
// miss or dead lane. Any hit writes 1 for occluded in (0, tmax), else 0.

#include <algorithm>
#include <climits>
#include <mutex>

#include "visit.cuh"

namespace {

using namespace msn;

// lanes per ray for a tree of width W
template <int W>
__host__ __device__ constexpr int group_lanes() {
  return W <= 16 ? 2 : 4;
}

// groups per block: packet.GROUPS_PER_BLOCK counts the same
constexpr int kBlockGroups = 64;
// registers are capped so that kSmThreads threads fit an SM (64 a thread
// at 1024); uncapped, the visits' loads take ~100-120
constexpr int kSmThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

template <int G>
__host__ __device__ constexpr int block_threads() {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16 || G == 32,
                "a group is a power-of-two part of a warp");
  static_assert(kBlockGroups * G % 32 == 0 && kBlockGroups * G <= 1024,
                "whole warps, at most 1024 threads");
  return kBlockGroups * G;
}

struct Ray {
  float o[3], d[3], inv[3], oinv[3];
};

// One internal visit by the group: lane k tests children k, k + G, ...
// with the old kernel's expressions, and the group pushes the hits in
// packet._walk's order above `top`. Returns the new top. `row` is in shared
// memory (a top row) or in global memory.
template <int W, int G>
__device__ __forceinline__ int visit_node(const float* row, int k,
                                          unsigned gmask, const Ray& r,
                                          float prune, int* stack, int top) {
  constexpr int kChildren = (W + G - 1) / G;  // per lane
  const float axis = row[7 * W];
  const int ax = axis < 0.5f ? 0 : (axis < 1.5f ? 1 : 2);
  const bool fwd = r.d[ax] >= 0.0f;  // near children sit at low slots
  unsigned hits = 0;
  int ptr[kChildren];
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const int j = k + c * G;
    ptr[c] = -1;
    if (W % G == 0 || j < W) {
      const float p = row[6 * W + j];
      if (p != -1.0f) {
        const float a0 = row[0 * W + j] * r.inv[0] - r.oinv[0];
        const float b0 = row[3 * W + j] * r.inv[0] - r.oinv[0];
        const float a1 = row[1 * W + j] * r.inv[1] - r.oinv[1];
        const float b1 = row[4 * W + j] * r.inv[1] - r.oinv[1];
        const float a2 = row[2 * W + j] * r.inv[2] - r.oinv[2];
        const float b2 = row[5 * W + j] * r.inv[2] - r.oinv[2];
        const float tnear =
            fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
        const float tfar =
            fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
        if (fmaxf(tnear, 0.0f) <= fminf(tfar, prune)) {
          hits |= 1u << j;
          ptr[c] = (int)p;
        }
      }
    }
  }
  const unsigned all = __reduce_or_sync(gmask, hits);
#pragma unroll
  for (int c = 0; c < kChildren; ++c) {
    const int j = k + c * G;
    if ((hits >> j) & 1u) {
      const int below = __popc(all & ((1u << j) - 1u));
      const int above = __popc(all) - below - 1;
      stack[top + (fwd ? above : below)] = ptr[c];  // far child first
    }
  }
  return top + __popc(all);
}

// One leaf visit by the group, field f of slot j at row[f * slots + j].
// Closest hit: the first slot of least t below t_far (the best t so far,
// lowered here), as the sequential strict-< loop keeps it. Any hit: true
// when a slot occludes in (0, t_far).
template <bool AnyHit, int G>
__device__ __forceinline__ bool visit_leaf_group(
    const float* row, int slots, int k, unsigned gmask, const Ray& r,
    float& t_far, int& best_tri, float& best_u, float& best_v) {
  float bt = __int_as_float(0x7f800000), bu = 0.0f, bv = 0.0f;  // +inf
  int bs = INT_MAX, btri = -1;
  bool occ = false;
#pragma unroll
  for (int c = 0; c < (32 + G - 1) / G; ++c) {  // slots <= 24 < 32
    const int j = k + c * G;
    if (j >= slots || (AnyHit && occ)) continue;
    const float tid = __ldg(row + 9 * slots + j);
    if (tid < 0.0f) continue;  // empty slot
    float v0[3], e1[3], e2[3];
    for (int f = 0; f < 3; ++f) {
      v0[f] = __ldg(row + f * slots + j);
      e1[f] = __ldg(row + (3 + f) * slots + j);
      e2[f] = __ldg(row + (6 + f) * slots + j);
    }
    if constexpr (AnyHit) {
      occ = tri_any(v0, e1, e2, r.o, r.d, t_far);
    } else {
      float t, u, v;
      if (tri_closest(v0, e1, e2, r.o, r.d, t_far, t, u, v) && t < bt) {
        bt = t;
        bs = j;
        bu = u;
        bv = v;
        btri = (int)tid;
      }
    }
  }
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

template <bool AnyHit, int W, int G = group_lanes<W>()>
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
  // rows 0..top_rows-1 into shared memory as whole float4s (rows are 128
  // or 256 floats, 16-byte aligned), then the groups' stacks
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
        const float* row = node < top_rows
                               ? top_s + node * node_stride
                               : nodes + (size_t)node * node_stride;
        top = visit_node<W, G>(row, k, gmask, r, t_far, stack, top);
      } else if (visit_leaf_group<AnyHit, G>(
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

size_t shared_bytes(int top_rows, int node_stride, int stack_depth) {
  return sizeof(float) * (size_t)top_rows * node_stride +
         sizeof(int) * (size_t)kBlockGroups * stack_depth;
}

// Launch the kernel for width W on as many blocks as the SMs hold at this
// shared-memory size (no more than the rays need). Returns a cudaError_t.
template <bool AnyHit, int W>
int launch(const float* nodes, const float* leaves, int node_stride,
           int leaf_stride, int slots, const float* ray_o,
           const float* ray_d, const float* t_max, const uint8_t* active,
           int n, int top_rows, int stack_depth, unsigned* next_ray,
           float* t_out, int32_t* tri_out, float* u_out, float* v_out,
           uint8_t* occ_out, cudaStream_t stream) {
  constexpr int kThreads = block_threads<group_lanes<W>()>();
  const auto kernel = traverse_kernel<AnyHit, W>;
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
template <bool AnyHit, class... Args>
int launch_width(int width, Args... args) {
  switch (width) {
    case 8: return launch<AnyHit, 8>(args...);
    case 16: return launch<AnyHit, 16>(args...);
    case 24: return launch<AnyHit, 24>(args...);
    case 32: return launch<AnyHit, 32>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int msn_stack_capacity() { return kStackCap; }

// Dynamic shared memory of one block: the top rows, then one stack of
// stack_depth entries per group (packet.kernel_layout counts the same).
int msn_shared_bytes(int top_rows, int node_stride, int stack_depth) {
  return (int)shared_bytes(top_rows, node_stride, stack_depth);
}

// Lanes per ray on a tree of this width (0 for a width the kernel lacks).
int msn_group_lanes(int width) {
  switch (width) {
    case 8: return group_lanes<8>();
    case 16: return group_lanes<16>();
    case 24: return group_lanes<24>();
    case 32: return group_lanes<32>();
    default: return 0;
  }
}

// Each entry point launches on `stream` and returns cudaGetLastError() or
// the error that kept it from launching: a launch the card refuses never
// runs, and only this code reports it. next_ray is 4 bytes of the
// caller's device memory, which the launch zeroes on the stream.
int msn_closest_hit(const float* nodes, const float* leaves, int node_stride,
                    int leaf_stride, int width, int slots, const float* ray_o,
                    const float* ray_d, const float* t_max,
                    const uint8_t* active, int n, int top_rows,
                    int stack_depth, unsigned* next_ray, float* t_out,
                    int32_t* tri_out, float* u_out, float* v_out,
                    void* stream) {
  return launch_width<false>(width, nodes, leaves, node_stride, leaf_stride,
                             slots, ray_o, ray_d, t_max, active, n, top_rows,
                             stack_depth, next_ray, t_out, tri_out, u_out,
                             v_out, (uint8_t*)nullptr, (cudaStream_t)stream);
}

int msn_any_hit(const float* nodes, const float* leaves, int node_stride,
                int leaf_stride, int width, int slots, const float* ray_o,
                const float* ray_d, const float* t_max, const uint8_t* active,
                int n, int top_rows, int stack_depth, unsigned* next_ray,
                uint8_t* occ_out, void* stream) {
  return launch_width<true>(width, nodes, leaves, node_stride, leaf_stride,
                            slots, ray_o, ray_d, t_max, active, n, top_rows,
                            stack_depth, next_ray, (float*)nullptr,
                            (int32_t*)nullptr, (float*)nullptr,
                            (float*)nullptr, occ_out, (cudaStream_t)stream);
}

}  // extern "C"
