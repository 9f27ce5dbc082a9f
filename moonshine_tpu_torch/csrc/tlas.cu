// Two-level (instanced) traversal for Hopper (sm_90a): closest hit and any
// hit.
//
// Replaces no Pallas kernel: the reference walks the two-level structure
// in jnp (moonshine_tpu/accel/tlas.py `closest_hit_tlas` :228 /
// `any_hit_tlas` :325, one lockstep lax.while_loop), and its torch twin
// (moonshine_tpu_torch/accel/tlas.py `_walk_plain`) launches a few dozen
// small kernels and a host read per iteration. This is that walk as one
// kernel.
//
// What bounds it. The work is a chain of dependent visits per ray: box
// tests (~25 flops each), instance entries (the object-space ray, ~42) and
// triangle tests (~60), an operations bound, as for the packet kernels.
// The first kernel ran ~40x above it: one thread a ray walked
// both levels by skip links, left child first, so the closest hit's t
// shrank late and pruned little (34.6 top and 41.3 BLAS visits a camera
// ray on instanced_1080p); each visit read five arrays in nine scalar
// loads; and lanes of a warp sat at different levels, so the warp issued
// both levels' code on most trips. This one makes ~13 visits a camera
// ray and is bound by issue: every visit costs the group's lanes the
// loop's own instructions besides the tests, and a warp runs as long as
// the longest of its rays.
//
// Design (each part measured against its alternatives on an H100, with
// scripts/compare_tlas.py; PERF.md):
//   - The records (accel/tlas.py `build_walk`, derived at device_tlas from
//     the reference's arrays): each BLAS and the top level collapsed into
//     8-wide nodes, a binary node's children replaced by theirs twice over,
//     in order, so that child j's leaves all come before child j+1's. A
//     child is two float4s (lo xyz and its code, hi xyz): the box is read
//     in two 16-byte loads. Code >= 0 is a node, -1 an empty child (a
//     hidden instance too), -2 - x a leaf: x the top-level leaf position
//     or, in a BLAS, slot * 4 + count - 1. A triangle is three float4s
//     (v0 and its id, e1, e2; the edges subtracted as the plain version
//     subtracts them).
//   - A group of 4 lanes traces one ray (2 and 8 lanes, and one thread a
//     ray, were slower); lane k tests children k and k + 4 of a node and
//     slot k of a leaf. 32 groups a block, each with a stack of (code,
//     tnear) in shared memory, `stack_depth` entries (the bound build_walk
//     counts over the two trees).
//   - Closest hit walks the nearest hit child first (the others below it
//     in key order; a full sort by tnear was slower) and drops a popped
//     entry whose tnear is past the best hit so far. Any hit pushes in key
//     order (sorting was slower there).
//   - Entering an instance (a top-level leaf popped in world space)
//     moves the ray into object space (r0 x + r1 y + r2 z + t, the plain
//     version's expression; d is not renormalised, so t stays world t),
//     marks the stack height and visits the BLAS root in the same step.
//     Entries above the mark are the BLAS's; when the stack falls to it
//     the walk is back at the top level.
//   - Blocks are persistent; a warp takes 32 neighbouring rays at a time
//     from a global counter and retires the dead ones there
//     (csrc/group_walk.cuh's scheme). Closest hit hands the live ones to
//     its groups when all of them are done, any hit as soon as one is.
//     The warp loops as one: each round a node phase (the groups at a
//     node, or at an entry and its root) and then a leaf phase (the groups
//     at a BLAS leaf, the one just pushed too), so that a leaf costs no
//     round of its own; three rounds between the checks for finished and
//     new rays.
//   - Not group_walk.cuh's loop with a format of its own: its stack holds
//     no tnear, its order is by the axis sign, its leaf result is keyed on
//     the slot alone, and it has no step that changes the ray.
//
// Ties. The plain version visits leaves in rising order of (top-level leaf
// position, BLAS slot), on the top level and in every BLAS (the premise
// tests/test_torch_tlas.py checks), accepts a triangle at t < t_best and
// prunes a box at tnear > t_best. Its closest hit is therefore the least
// (t, position, slot) among the hits whose boxes are entered no later than
// their t, whatever the order of the walk: this kernel carries the key of
// its best hit and takes a hit at equal t when its key is smaller (never
// at the lane's t_max: with no hit held nothing beats it). Children of
// equal tnear are walked in key order. Skipping the binary nodes inside a
// wide node changes nothing: a box contains its children's boxes, so a
// child's test passes only where its parent's would. Any hit is a boolean
// and does not depend on the order.
//
// Numerics: built with -fmad=false and IEEE division; the box test, the
// triangle test (accel/traverse.py `_aabb_hit`, `_tri_intersect`),
// `_safe_inv` and the object-space transform are the plain version's
// expressions in its order, and its min and max propagate NaN as torch's
// do (PTX min.NaN / max.NaN), so t, tri, u, v, inst and the occlusion
// equal the plain versions' bit for bit.
//
// Built with -DMSN_TLAS_COUNT the kernel also counts what it visits into a
// caller's array (accel/tlas.py `walk_visits`); that build is never the
// timed one.

#include <algorithm>
#include <climits>
#include <mutex>

#include "visit.cuh"

namespace {

using msn::safe_inv;
using msn::tri_closest;

constexpr int kW = 8;          // children a node (accel/tlas.py WIDE)
constexpr int kG = 4;          // lanes a ray
constexpr int kC = kW / kG;    // children a lane
constexpr int kLeaf = 4;       // triangles a BLAS leaf (tlas.BLAS_LEAF)
constexpr int kThreads = 128;  // a block: 32 groups
constexpr int kGroups = kThreads / kG;
constexpr unsigned kAll = 0xffffffffu;
#ifdef MSN_TLAS_COUNT
constexpr bool kCount = true;
#else
constexpr bool kCount = false;
#endif

// what the counting build counts (accel/tlas.py WalkVisits)
enum { kTopNodes, kBlasNodes, kBoxes, kEntries, kLeaves, kTris, kCounters };

struct Walk {
  const float4* nodes;     // [nodes, kW, 2]
  const float4* tris;      // [num_tris, 3]
  const float4* inst_inv;  // [num_instances, 3]: 3x3 row-major, then t
  const int* top_inst;     // [num_instances] leaf position -> instance
  const int* inst_root;    // [num_instances] BLAS root node, -1 hidden
  int num_instances;
  int num_tris;
  unsigned long long* counts;  // [kCounters] in the counting build
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The group's lane k == 0 adds x to counter c (counting build only).
__device__ __forceinline__ void tally(const Walk& T, int k, int c,
                                      unsigned long long x) {
  if constexpr (kCount) {
    if (k == 0) atomicAdd(T.counts + c, x);
  }
}

// min and max that return NaN when an operand is NaN, as torch.minimum /
// torch.amax do (fminf and fmaxf return the other operand)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// traverse.py _aabb_hit: slabs, the largest entry against the smallest
// exit, exit ahead of the origin, entry no later than prune; a NaN slab
// makes tnear or tfar NaN and fails every comparison, as in torch.
__device__ __forceinline__ bool box_hit(const float4& a, const float4& b,
                                        const float o[3], const float inv[3],
                                        float prune, float& tnear) {
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {b.x, b.y, b.z};
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = (lo[c] - o[c]) * inv[c];
    const float t1 = (hi[c] - o[c]) * inv[c];
    const float l = min_nan(t0, t1);
    const float h = max_nan(t0, t1);
    tn = c == 0 ? l : max_nan(tn, l);
    tf = c == 0 ? h : min_nan(tf, h);
  }
  tnear = tn;
  return (tn <= tf) && (tf >= 0.0f) && (tn <= prune);
}

// One node visit by the group: lane k tests children k and k + kG; the
// hits go onto the stack above `top`, sorted by (tnear, child) with the
// nearest on top. Returns the new top.
template <bool Sort>
__device__ __forceinline__ int visit_node(const Walk& T, const float4* rec,
                                          int k, unsigned gmask,
                                          const float o[3],
                                          const float inv[3], float prune,
                                          int2* stack, int top) {
  float tn[kC];
  int code[kC];
  unsigned hits = 0;
  int tested = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = k + c * kG;
    const float4 a = __ldg(rec + 2 * j);
    const float4 b = __ldg(rec + 2 * j + 1);
    code[c] = __float_as_int(a.w);
    tn[c] = inf_f();
    if (code[c] != -1) {
      ++tested;
      float t;
      if (box_hit(a, b, o, inv, prune, t)) {
        hits |= 1u << j;
        tn[c] = t;
      }
    }
  }
  if constexpr (kCount) {
    tally(T, k, kBoxes, __reduce_add_sync(gmask, tested));
  }
  const unsigned all = __reduce_or_sync(gmask, hits);
  int farther[kC];
  if (Sort) {  // the nearest hit child on top, the others in key order
    float bt = inf_f();
    int bj = 31;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = k + c * kG;
      if (((hits >> j) & 1u) && (tn[c] < bt || (tn[c] == bt && j < bj))) {
        bt = tn[c];
        bj = j;
      }
    }
#pragma unroll
    for (int off = kG / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(gmask, bt, off);
      const int oj = __shfl_xor_sync(gmask, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    const unsigned rest = all & ~(1u << bj);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = k + c * kG;
      farther[c] = j == bj ? __popc(all) - 1 : __popc(rest >> j >> 1);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      farther[c] = __popc(all >> (k + c * kG) >> 1);
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = k + c * kG;
    if ((hits >> j) & 1u) {
      stack[top + farther[c]] = make_int2(code[c], __float_as_int(tn[c]));
    }
  }
  return top + __popc(all);
}

// One BLAS leaf visit by the group (x = slot * 4 + count - 1): lane k
// tests slot k. Any hit: true when a lane occludes. Closest hit: each lane
// keeps its hit if it beats the held best (t smaller, or t equal and key
// smaller), the group takes the least (t, slot) of those by xor shuffles
// and it becomes the best.
template <bool AnyHit>
__device__ __forceinline__ bool visit_leaf(
    const Walk& T, int x, int k, unsigned gmask, const float o[3],
    const float d[3], float t_lane, float& t_far, int cur_p, int& best_p,
    int& best_s, int& best_tri, float& best_u, float& best_v) {
  const int s0 = x >> 2;
  const int cnt = (x & 3) + 1;
  float bt = inf_f(), bu = 0.0f, bv = 0.0f;
  int bj = INT_MAX, btri = -1;
  bool occ = false;
#pragma unroll
  for (int c = 0; c < (kLeaf + kG - 1) / kG; ++c) {
    const int j = k + c * kG;
    if (j >= cnt || (AnyHit && occ)) continue;
    const int s = min(max(s0 + j, 0), T.num_tris - 1);
    const float4 q0 = __ldg(T.tris + 3 * s);
    const float4 q1 = __ldg(T.tris + 3 * s + 1);
    const float4 q2 = __ldg(T.tris + 3 * s + 2);
    const float v0[3] = {q0.x, q0.y, q0.z};
    const float e1[3] = {q1.x, q1.y, q1.z};
    const float e2[3] = {q2.x, q2.y, q2.z};
    float t, u, v;
    if constexpr (AnyHit) {
      occ = tri_closest(v0, e1, e2, o, d, t_lane, t, u, v);
    } else {
      // t < bound: strictly below the best, or equal to it for a key
      // before the best's (best_p = -1 while nothing is held)
      const bool before = cur_p < best_p || (cur_p == best_p && s < best_s);
      const float bound = before ? nextafterf(t_far, inf_f()) : t_far;
      if (tri_closest(v0, e1, e2, o, d, bound, t, u, v) &&
          (t < bt || (t == bt && j < bj))) {
        bt = t;
        bj = j;
        bu = u;
        bv = v;
        btri = __float_as_int(q0.w);
      }
    }
  }
  if constexpr (kCount) {
    tally(T, k, kLeaves, 1);
    tally(T, k, kTris, cnt);
  }
  if constexpr (AnyHit) {
    return __any_sync(gmask, occ);
  } else {
#pragma unroll
    for (int off = kG / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(gmask, bt, off);
      const int oj = __shfl_xor_sync(gmask, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    if (bj != INT_MAX) {  // lane bj % kG tested slot bj and holds its hit
      const int owner = bj % kG;
      t_far = bt;
      best_p = cur_p;
      best_s = min(max(s0 + bj, 0), T.num_tris - 1);
      best_u = __shfl_sync(gmask, bu, owner, kG);
      best_v = __shfl_sync(gmask, bv, owner, kG);
      best_tri = __shfl_sync(gmask, btri, owner, kG);
    }
    return false;
  }
}

template <bool AnyHit>
__global__ void __launch_bounds__(kThreads, 8)
    tlas_kernel(Walk T, const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ t_max,
                const bool* __restrict__ active, int n, int stack_depth,
                unsigned* __restrict__ next_ray, float* __restrict__ t_out,
                int* __restrict__ tri_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ inst_out,
                bool* __restrict__ occ_out) {
  constexpr unsigned kGroupsPerWarp = 32 / kG;  // rays a warp traces at once
  extern __shared__ int2 stacks[];
  const int lane = threadIdx.x & 31;
  const int k = lane & (kG - 1);
  const unsigned gmask = ((1u << kG) - 1u) << (lane & ~(kG - 1));
  int2* stack = stacks + (threadIdx.x / kG) * stack_depth;

  // the world ray and, inside an instance, the object-space ray
  float o[3], d[3], inv[3], oo[3], dd[3], oinv[3];
  // t_far: closest hit's best t so far (t_max until a hit); key (best_p,
  // best_s) of that hit, best_p = -1 while none is held
  float t_lane = 0.0f, t_far = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, best_p = -1, best_s = -1;
  // the top-level leaf position of the instance being walked; the hit's
  // instance is top_inst[best_p], read when the ray is done
  int cur_p = 0;
  // stack height; entries at or above inst_base are the instance's
  int top = 0, inst_base = INT_MAX;
  // the warp's batch: bit p of waiting is live ray base + p no group took
  unsigned base = 0, waiting = 0, i = 0;
  // dense: over a quarter of the last batch was live; drained: the
  // counter ran past n
  bool dense = false, drained = false, live = false, occluded = false;
  for (;;) {
    bool start = false;  // the group starts ray i in this iteration
    // idle groups take new rays: for closest hit when every group of the
    // warp is done, for any hit as soon as one is (each measured faster)
    if (AnyHit ? __any_sync(kAll, !live) : __all_sync(kAll, !live)) {
      while (waiting == 0 && !drained) {  // a new batch; each lane
        // retires a dead ray. 32 rays, but closest hit takes one round's
        // worth after a dense batch (csrc/group_walk.cuh's rule)
        const unsigned take = !AnyHit && dense ? kGroupsPerWarp : 32u;
        if (lane == 0) base = atomicAdd(next_ray, take);
        base = __shfl_sync(kAll, base, 0);
        if (base >= (unsigned)n) {
          drained = true;
          break;
        }
        const unsigned j = base + lane;
        bool alive = false;
        if (lane < take && j < (unsigned)n) {
          const float tj = __ldg(t_max + j);
          alive = (active == nullptr || active[j]) && tj > 0.0f;
          if (!alive) {  // inactive or t_max <= 0: nothing can be hit
            if (AnyHit) {
              occ_out[j] = false;
            } else {
              t_out[j] = tj;
              tri_out[j] = -1;
              u_out[j] = v_out[j] = 0.0f;
              inst_out[j] = -1;
            }
          }
        }
        waiting = __ballot_sync(kAll, alive);
        dense = 4u * __popc(waiting) > take;
      }
      // the r-th idle group takes the r-th waiting ray
      const unsigned idle = __ballot_sync(kAll, !live && k == 0);
      const int rank = __popc(idle & ((1u << (lane & ~(kG - 1))) - 1u));
      unsigned mine = waiting;
      for (int g = 0; g < rank; ++g) mine &= mine - 1;
      start = !live && mine != 0;
      if (start) i = base + __ffs(mine) - 1;
      for (int g = __popc(idle); g > 0 && waiting != 0; --g) {
        waiting &= waiting - 1;
      }
      if (drained && __all_sync(kAll, !live && !start)) break;
    }
    if (start) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = __ldg(ray_o + 3 * (size_t)i + c);
        d[c] = __ldg(ray_d + 3 * (size_t)i + c);
        inv[c] = safe_inv(d[c]);
      }
      t_lane = t_far = __ldg(t_max + i);
      best_u = best_v = 0.0f;
      best_tri = best_p = best_s = -1;
      occluded = false;
      if (k == 0) stack[0] = make_int2(0, __float_as_int(-inf_f()));
      top = 1;
      inst_base = INT_MAX;
      live = true;
    }
    __syncwarp();

    // three rounds of visits between the checks for finished rays and
    // new ones (fewer checks measured faster)
#pragma unroll
    for (int round = 0; round < 3; ++round) {
      // the top entry; closest hit drops those its best hit has passed
      int2 ent = make_int2(0, 0);
      while (live && top > 0) {
        ent = stack[top - 1];
        if (AnyHit || __int_as_float(ent.y) <= t_far) break;
        --top;
      }
      // a node phase, then a leaf phase: a group at a node (or at a
      // top-level leaf: the instance's entry and its BLAS root) visits it;
      // then a group at a BLAS leaf, the one it just pushed too, visits that
      if (live && top > 0) {
        const bool in_blas = top - 1 >= inst_base;
        if (ent.x >= 0 || !in_blas) {
          --top;
          if (!in_blas) inst_base = INT_MAX;  // back at the top level
          int node = ent.x;
          bool obj = in_blas;
          if (node < 0) {  // enter the instance at top-level leaf position p
            const int p = min(max(-2 - node, 0), T.num_instances - 1);
            const int inst = __ldg(T.top_inst + p);
            node = __ldg(T.inst_root + inst);
            if (node >= 0) {
              const float4 q0 = __ldg(T.inst_inv + 3 * inst);
              const float4 q1 = __ldg(T.inst_inv + 3 * inst + 1);
              const float4 q2 = __ldg(T.inst_inv + 3 * inst + 2);
              const float r[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                                   q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
  #pragma unroll
              for (int c = 0; c < 3; ++c) {
                oo[c] = r[3 * c] * o[0] + r[3 * c + 1] * o[1] +
                        r[3 * c + 2] * o[2] + r[9 + c];
                dd[c] = r[3 * c] * d[0] + r[3 * c + 1] * d[1] +
                        r[3 * c + 2] * d[2];
              }
  #pragma unroll
              for (int c = 0; c < 3; ++c) oinv[c] = safe_inv(dd[c]);
              cur_p = p;
              inst_base = top;
              obj = true;
              tally(T, k, kEntries, 1);
            }
          }
          if (node >= 0) {
            float ro[3], ri[3];
  #pragma unroll
            for (int c = 0; c < 3; ++c) {
              ro[c] = obj ? oo[c] : o[c];
              ri[c] = obj ? oinv[c] : inv[c];
            }
            tally(T, k, obj ? kBlasNodes : kTopNodes, 1);
            top = visit_node<!AnyHit>(
                T, T.nodes + (size_t)node * (2 * kW), k, gmask, ro, ri,
                AnyHit ? t_lane : t_far, stack, top);
          }
        }
      }
      __syncwarp();
      if (live && top > 0 && top - 1 >= inst_base) {
        const int2 ent = stack[top - 1];
        if (ent.x < 0) {  // a BLAS leaf
          --top;
          if (visit_leaf<AnyHit>(T, -2 - ent.x, k, gmask, oo, dd, t_lane,
                                 t_far, cur_p, best_p, best_s, best_tri,
                                 best_u, best_v)) {
            occluded = true;
            top = 0;
          }
        }
      }
      __syncwarp();
    }

    if (live && top == 0) {  // the ray is done
      if (k == 0) {
        if (AnyHit) {
          occ_out[i] = occluded;
        } else {
          t_out[i] = t_far;
          tri_out[i] = best_tri;
          u_out[i] = best_u;
          v_out[i] = best_v;
          inst_out[i] = best_p < 0 ? -1 : __ldg(T.top_inst + best_p);
        }
      }
      live = false;
    }
  }
}

size_t shared_bytes(int stack_depth) {
  return sizeof(int2) * (size_t)kGroups * stack_depth;
}

// Launch on as many blocks as the SMs hold at this stack depth (no more
// than the rays need). Returns a cudaError_t code.
template <bool AnyHit>
int launch(const Walk& T, const float* ray_o, const float* ray_d,
           const float* t_max, const bool* active, int n, int stack_depth,
           unsigned* next_ray, float* t, int* tri, float* u, float* v,
           int* inst, bool* occ, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (stack_depth < 1 || T.num_instances < 1 || T.num_tris < 1 ||
      (kCount && T.counts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = tlas_kernel<AnyHit>;
  const size_t smem = shared_bytes(stack_depth);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the blocks the card holds at this size, asked once per device and size
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
    if (err == cudaSuccess) {
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
  kernel<<<grid, kThreads, smem, stream>>>(T, ray_o, ray_d, t_max, active, n,
                                           stack_depth, next_ray, t, tri, u,
                                           v, inst, occ);
  return (int)cudaGetLastError();
}

}  // namespace

#define MSN_TLAS_ARGS                                                     \
  const float *nodes, const float *tris, const float *inst_inv,           \
      const int *top_inst, const int *inst_root, int num_instances,       \
      int num_tris, unsigned long long *counts
#define MSN_TLAS_WALK                                                     \
  Walk{reinterpret_cast<const float4*>(nodes),                            \
       reinterpret_cast<const float4*>(tris),                             \
       reinterpret_cast<const float4*>(inst_inv), top_inst, inst_root,    \
       num_instances, num_tris, counts}

extern "C" {

// Dynamic shared memory of one block at this stack depth.
int msn_tlas_shared_bytes(int stack_depth) {
  return (int)shared_bytes(stack_depth);
}

// 1 in the counting build (-DMSN_TLAS_COUNT), else 0.
int msn_tlas_counting() { return kCount ? 1 : 0; }

// The walk's records (accel/tlas.py TlasWalk: nodes float32 [N, 8, 8],
// tris float32 [num_tris, 12], 16-byte aligned), the reference's inst_inv
// [I, 12] (16-byte aligned), top_inst and the records' inst_root (int32
// [I]), the instance and triangle counts, and the counters (int64 [6],
// zeroed by the caller; only the counting build reads it, NULL
// elsewhere); then the rays: ray_o, ray_d float32 [n, 3], t_max float32
// [n], active bool [n] or NULL; the stack depth; next_ray, 4 bytes of
// device memory the launch zeroes on the stream; the outputs; the stream.
// Returns a cudaError_t code (0 on success).
int msn_tlas_closest_hit(MSN_TLAS_ARGS, const float* ray_o,
                         const float* ray_d, const float* t_max,
                         const bool* active, int n, int stack_depth,
                         unsigned* next_ray, float* t, int* tri, float* u,
                         float* v, int* inst, cudaStream_t stream) {
  return launch<false>(MSN_TLAS_WALK, ray_o, ray_d, t_max, active, n,
                       stack_depth, next_ray, t, tri, u, v, inst, nullptr,
                       stream);
}

int msn_tlas_any_hit(MSN_TLAS_ARGS, const float* ray_o, const float* ray_d,
                     const float* t_max, const bool* active, int n,
                     int stack_depth, unsigned* next_ray, bool* occluded,
                     cudaStream_t stream) {
  return launch<true>(MSN_TLAS_WALK, ray_o, ray_d, t_max, active, n,
                      stack_depth, next_ray, nullptr, nullptr, nullptr,
                      nullptr, nullptr, occluded, stream);
}

}  // extern "C"
