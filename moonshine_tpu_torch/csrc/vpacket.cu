// Format-V wide-BVH traversal for Hopper (sm_90a): closest hit and any hit
// over (8, 128) float32 tiles.
//
// Replaces the two Pallas TPU kernels built by
// moonshine_tpu/accel/vpacket.py::_make_vkernel (any_hit=False reached via
// _closest_impl / closest_hit_vpacket[_hbm]; any_hit=True via _anyhit_impl /
// any_hit_vpacket[_hbm]), as one template on AnyHit.
//
// Tile layout (accel/vpacket.py): node child j = 8g + s has bound c (lo
// xyz, hi xyz) at tile[s][6g + c], its pointer at tile[0][64 + j] and the
// node's sort axis at tile[0][63]; leaf slot j = 8g + s has field f (v0
// xyz, e1 xyz, e2 xyz, tid) at tile[s][10g + f].
//
// What bounds it on this card: as the packet kernels (traverse.cu), a
// chain of dependent visits per ray, ~25 flops a child slot and 54-55 a
// triangle slot, an operations bound that divergence and load latency keep
// it far from. The tiles of a large tree are 4-8x its rows (room_184k at
// 24/24: 49.5 MB against 12.4 MB, about the size of L2); what they offer
// is locality: a child's six bounds are 24 contiguous bytes and a slot's
// ten fields 40, where a row spreads them over runs 4 * width bytes apart.
//
// Design: traverse.cu's group walk (csrc/group_walk.cuh: groups of G lanes
// a ray, stacks in shared memory, persistent warps fetching 32-ray
// batches, the warp's vote between node and leaf visits, 64 registers),
// with tile reads in place of row reads:
//   - lane k of a group owns sublanes k, k + G, ... (G divides 8), so it
//     owns children and slots j with j % G == k, as in the row kernel,
//     and the group's pushes and leaf choice are the row kernel's;
//   - a child's bounds are one float4 and one float2 load (their order
//     follows the column's 16-byte alignment: 6g floats is 16-aligned for
//     even g); its pointer is read only when its box is hit;
//   - a leaf slot's fields are three loads, two float4s and a float2
//     (10g floats is 16-byte aligned for even g, 8 for odd), the one
//     holding the triangle id first, so an empty slot costs one load;
//   - a lane walks its slots in rising j (column group outer, sublane
//     inner), so its first least t is the sequential loop's;
//   - G is 1 on 8-wide trees and 2 above; no top tiles sit in shared
//     memory (vpacket.kernel_layout gives R = 0).
// That shape is the fastest of the alternatives measured on an H100
// (PERF.md): G = 1, 2, 4 or 8 on each width (a lane a sublane, G = 8,
// lost on every tree), the tree's top tiles in shared memory (2-4x
// slower: 4 KB a tile leaves one or two blocks an SM), node tiles read
// through __ldg, a slot's fields as five float2s, two children's bounds
// as three float4s. They are not options: scripts/compare_traverse.py
// times this kernel with top tiles and, with --against, other
// checkouts' kernels on the same rays.
// Empty child slots (and the width padding of the last sublane group) are
// skipped by their pointer, -1, never entered: the reference enters them
// through their inverted boxes and revisits leaf 0 for each. Children are
// pushed far-to-near by the ray's own direction sign on the tile's axis
// (the TPU uses the live block's majority sign), which changes only the
// order of equal-t ties.
//
// Numerics: visit.cuh's expressions in packet._walk's order, built with
// -fmad=false and IEEE division, so the kernel equals its plain torch
// version (accel/vpacket.py) and traverse.cu's kernel on the same tree bit
// for bit, equal-t ties included. Contract (traverse.cu's): a lane with
// active == 0 has its tmax replaced by -1e30 and is never traversed; tmax
// <= 0 marks a dead lane. Closest hit writes t = the caller's tmax, tri =
// -1, u = v = 0 on a miss or dead lane. Any hit writes 1 for occluded in
// (0, tmax), else 0.

#include "group_walk.cuh"

namespace {

using namespace msn;

constexpr int kSublane = 128;  // floats a sublane
constexpr int kTile = 8 * kSublane;
constexpr int kAxisLane = 63;
constexpr int kPtrLane0 = 64;

// The six bounds (lo xyz, hi xyz) of a child at p = sublane + 6g.
__device__ __forceinline__ void child_bounds(const float* p, bool even_g,
                                             float b[6]) {
  if (even_g) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float2 y = *reinterpret_cast<const float2*>(p + 4);
    b[0] = x.x, b[1] = x.y, b[2] = x.z, b[3] = x.w, b[4] = y.x, b[5] = y.y;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 2);
    b[0] = x.x, b[1] = x.y, b[2] = y.x, b[3] = y.y, b[4] = y.z, b[5] = y.w;
  }
}

// The ten fields (v0 xyz, e1 xyz, e2 xyz, tid) of a slot at f = sublane +
// 10g, in three loads, the one holding tid first; false for an empty slot.
__device__ __forceinline__ bool slot_fields(const float* f, bool even_g,
                                            float x[10]) {
  if (even_g) {
    const float2 c = __ldg(reinterpret_cast<const float2*>(f + 8));
    if (c.y < 0.0f) return false;
    const float4 a = __ldg(reinterpret_cast<const float4*>(f));
    const float4 b = __ldg(reinterpret_cast<const float4*>(f + 4));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    x[8] = c.x, x[9] = c.y;
  } else {
    const float4 c = __ldg(reinterpret_cast<const float4*>(f + 6));
    if (c.w < 0.0f) return false;
    const float2 a = __ldg(reinterpret_cast<const float2*>(f));
    const float4 b = __ldg(reinterpret_cast<const float4*>(f + 2));
    x[0] = a.x, x[1] = a.y;
    x[2] = b.x, x[3] = b.y, x[4] = b.z, x[5] = b.w;
    x[6] = c.x, x[7] = c.y, x[8] = c.z, x[9] = c.w;
  }
  return true;
}

struct Tiles {
  // lanes per ray for a tree of width W: one on 8-wide trees, two above
  template <int W>
  static __host__ __device__ constexpr int lanes() {
    return W <= 8 ? 1 : 2;
  }

  // One internal visit by the group: lane k tests the children of its
  // sublanes, and the group pushes the hits in packet._walk's order above
  // `top`. Returns the new top. `tile` is in shared memory (a top tile) or
  // in global memory.
  template <int W, int G>
  static __device__ __forceinline__ int node(const float* tile, int k,
                                             unsigned gmask, const Ray& r,
                                             float prune, int* stack,
                                             int top) {
    static_assert(W % 8 == 0 && 8 % G == 0, "a lane owns whole sublanes");
    constexpr int kGroups = W / 8;  // children on a sublane
    constexpr int kSubs = 8 / G;    // sublanes a lane owns
    const float axis = tile[kAxisLane];
    const int ax = axis < 0.5f ? 0 : (axis < 1.5f ? 1 : 2);
    const bool fwd = r.d[ax] >= 0.0f;  // near children sit at low slots
    unsigned hits = 0;
    int ptr[kSubs * kGroups];
#pragma unroll
    for (int q = 0; q < kSubs; ++q) {
      const float* sub = tile + (k + q * G) * kSublane;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int c = q * kGroups + g;
        const int j = 8 * g + k + q * G;
        float b[6];
        child_bounds(sub + 6 * g, g % 2 == 0, b);
        const float a0 = b[0] * r.inv[0] - r.oinv[0];
        const float b0 = b[3] * r.inv[0] - r.oinv[0];
        const float a1 = b[1] * r.inv[1] - r.oinv[1];
        const float b1 = b[4] * r.inv[1] - r.oinv[1];
        const float a2 = b[2] * r.inv[2] - r.oinv[2];
        const float b2 = b[5] * r.inv[2] - r.oinv[2];
        const float tnear =
            fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
        const float tfar =
            fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
        ptr[c] = -1;
        if (fmaxf(tnear, 0.0f) <= fminf(tfar, prune)) {
          const float p = tile[kPtrLane0 + j];
          if (p != -1.0f) {  // an empty slot's inverted box is entered
            hits |= 1u << j;
            ptr[c] = (int)p;
          }
        }
      }
    }
    const unsigned all = __reduce_or_sync(gmask, hits);
#pragma unroll
    for (int q = 0; q < kSubs; ++q) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = 8 * g + k + q * G;
        if ((hits >> j) & 1u) {
          stack[top + push_slot(all, j, fwd)] = ptr[q * kGroups + g];
        }
      }
    }
    return top + __popc(all);
  }

  // One leaf visit by the group: lane k tests the slots of its sublanes,
  // column group by column group, so in rising slot order.
  template <bool AnyHit, int G>
  static __device__ __forceinline__ bool leaf(
      const float* tile, int slots, int k, unsigned gmask, const Ray& r,
      float& t_far, int& best_tri, float& best_u, float& best_v) {
    float bt = __int_as_float(0x7f800000), bu = 0.0f, bv = 0.0f;  // +inf
    int bs = INT_MAX, btri = -1;
    bool occ = false;
#pragma unroll
    for (int g = 0; g < 4; ++g) {  // slots <= 32: four column groups
      if (8 * g >= slots) break;
#pragma unroll
      for (int q = 0; q < 8 / G; ++q) {
        const int s = k + q * G;
        const int j = 8 * g + s;
        if (j >= slots || (AnyHit && occ)) continue;
        float x[10];
        if (!slot_fields(tile + s * kSublane + 10 * g, g % 2 == 0, x)) {
          continue;  // empty slot
        }
        const float v0[3] = {x[0], x[1], x[2]};
        const float e1[3] = {x[3], x[4], x[5]};
        const float e2[3] = {x[6], x[7], x[8]};
        if constexpr (AnyHit) {
          occ = tri_any(v0, e1, e2, r.o, r.d, t_far);
        } else {
          float t, u, v;
          if (tri_closest(v0, e1, e2, r.o, r.d, t_far, t, u, v) && t < bt) {
            bt = t;
            bs = j;
            bu = u;
            bv = v;
            btri = (int)x[9];
          }
        }
      }
    }
    return leaf_result<AnyHit, G>(gmask, occ, bt, bs, bu, bv, btri, t_far,
                                  best_tri, best_u, best_v);
  }
};

bool tiles_ok(const float* nodes, const float* leaves, int node_stride,
              int leaf_stride) {
  return node_stride == kTile && leaf_stride == kTile &&
         ((uintptr_t)nodes & 15) == 0 && ((uintptr_t)leaves & 15) == 0;
}

}  // namespace

extern "C" {

int msn_v_stack_capacity() { return kStackCap; }

// Dynamic shared memory of one block: the top tiles, then one stack of
// stack_depth entries per group (vpacket.kernel_layout counts the same).
int msn_v_shared_bytes(int top_tiles, int node_stride, int stack_depth) {
  return (int)shared_bytes(top_tiles, node_stride, stack_depth);
}

// Lanes per ray on a tree of this width (0 for a width the kernel lacks).
int msn_v_group_lanes(int width) { return width_lanes<Tiles>(width); }

// traverse.cu's entry points over tiles: node_stride and leaf_stride are
// the tile size (8 * 128 floats), top_tiles the tiles 0..R-1 copied into
// each block's shared memory. Each launches on `stream` and returns
// cudaGetLastError() or the error that kept it from launching. next_ray
// is 4 bytes of the caller's device memory, which the launch zeroes on
// the stream.
int msn_v_closest_hit(const float* nodes, const float* leaves,
                      int node_stride, int leaf_stride, int width, int slots,
                      const float* ray_o, const float* ray_d,
                      const float* t_max, const uint8_t* active, int n,
                      int top_tiles, int stack_depth, unsigned* next_ray,
                      float* t_out, int32_t* tri_out, float* u_out,
                      float* v_out, void* stream) {
  if (!tiles_ok(nodes, leaves, node_stride, leaf_stride)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_width<Tiles, false>(
      width, nodes, leaves, node_stride, leaf_stride, slots, ray_o, ray_d,
      t_max, active, n, top_tiles, stack_depth, next_ray, t_out, tri_out,
      u_out, v_out, (uint8_t*)nullptr, (cudaStream_t)stream);
}

int msn_v_any_hit(const float* nodes, const float* leaves, int node_stride,
                  int leaf_stride, int width, int slots, const float* ray_o,
                  const float* ray_d, const float* t_max,
                  const uint8_t* active, int n, int top_tiles,
                  int stack_depth, unsigned* next_ray, uint8_t* occ_out,
                  void* stream) {
  if (!tiles_ok(nodes, leaves, node_stride, leaf_stride)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_width<Tiles, true>(
      width, nodes, leaves, node_stride, leaf_stride, slots, ray_o, ray_d,
      t_max, active, n, top_tiles, stack_depth, next_ray, (float*)nullptr,
      (int32_t*)nullptr, (float*)nullptr, (float*)nullptr, occ_out,
      (cudaStream_t)stream);
}

}  // extern "C"
