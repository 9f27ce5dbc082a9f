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
// The walk (everything but the reads of a row) is csrc/group_walk.cuh,
// which the format-V kernels (vpacket.cu) share; this file gives it the
// row format. The shape (G per width, 64 groups a block, registers for
// 1024 threads an SM, rounds of 32 / G rays in lockstep, the plain copy of
// the top rows) is the fastest of the alternatives measured on an H100
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

#include "group_walk.cuh"

namespace {

using namespace msn;

// Node row: field c (lox loy loz hix hiy hiz, ptr) of child j at
// row[c * W + j], the node's axis at row[7 * W]. Leaf row: field f of slot
// j at row[f * slots + j].
struct Rows {
  // lanes per ray for a tree of width W
  template <int W>
  static __host__ __device__ constexpr int lanes() {
    return W <= 16 ? 2 : 4;
  }

  // One internal visit by the group: lane k tests children k, k + G, ...
  // with the old kernel's expressions, and the group pushes the hits in
  // packet._walk's order above `top`. Returns the new top. `row` is in
  // shared memory (a top row) or in global memory.
  template <int W, int G>
  static __device__ __forceinline__ int node(const float* row, int k,
                                             unsigned gmask, const Ray& r,
                                             float prune, int* stack,
                                             int top) {
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
        stack[top + push_slot(all, j, fwd)] = ptr[c];  // far child first
      }
    }
    return top + __popc(all);
  }

  // One leaf visit by the group: lane k tests slots k, k + G, ...
  template <bool AnyHit, int G>
  static __device__ __forceinline__ bool leaf(
      const float* row, int slots, int k, unsigned gmask, const Ray& r,
      float& t_far, int& best_tri, float& best_u, float& best_v) {
    float bt = __int_as_float(0x7f800000), bu = 0.0f, bv = 0.0f;  // +inf
    int bs = INT_MAX, btri = -1;
    bool occ = false;
#pragma unroll
    for (int c = 0; c < (32 + G - 1) / G; ++c) {  // slots <= 32
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
    return leaf_result<AnyHit, G>(gmask, occ, bt, bs, bu, bv, btri, t_far,
                                  best_tri, best_u, best_v);
  }
};

}  // namespace

extern "C" {

int msn_stack_capacity() { return kStackCap; }

// Dynamic shared memory of one block: the top rows, then one stack of
// stack_depth entries per group (packet.kernel_layout counts the same).
int msn_shared_bytes(int top_rows, int node_stride, int stack_depth) {
  return (int)shared_bytes(top_rows, node_stride, stack_depth);
}

// Lanes per ray on a tree of this width (0 for a width the kernel lacks).
int msn_group_lanes(int width) { return width_lanes<Rows>(width); }

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
  return launch_width<Rows, false>(
      width, nodes, leaves, node_stride, leaf_stride, slots, ray_o, ray_d,
      t_max, active, n, top_rows, stack_depth, next_ray, t_out, tri_out,
      u_out, v_out, (uint8_t*)nullptr, (cudaStream_t)stream);
}

int msn_any_hit(const float* nodes, const float* leaves, int node_stride,
                int leaf_stride, int width, int slots, const float* ray_o,
                const float* ray_d, const float* t_max, const uint8_t* active,
                int n, int top_rows, int stack_depth, unsigned* next_ray,
                uint8_t* occ_out, void* stream) {
  return launch_width<Rows, true>(
      width, nodes, leaves, node_stride, leaf_stride, slots, ray_o, ray_d,
      t_max, active, n, top_rows, stack_depth, next_ray, (float*)nullptr,
      (int32_t*)nullptr, (float*)nullptr, (float*)nullptr, occ_out,
      (cudaStream_t)stream);
}

}  // extern "C"
