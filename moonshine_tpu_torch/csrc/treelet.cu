// Treelet-scheduled wide-BVH traversal for Hopper (sm_90a): closest hit
// and any hit.
//
// Replaces the Pallas TPU kernel built by
// moonshine_tpu/accel/treelet.py::_make_kernel(any_hit, dma_rows, K) and
// launched by treelet.py::_dispatch (both variants). It computes what that
// kernel computes, with the contract of closest_hit_packet_hbm /
// any_hit_packet_hbm: for closest hit the nearest hit in the whole tree,
// reached only through the ray's own pending treelets (its nearest one
// first, then the others in ascending id, t_best pruning across them); for
// any hit an occluder in (0, tmax), the ray stopping at its first.
//
// Inputs come from the wrapper (moonshine_tpu_torch/accel/treelet.py): the
// rays sorted by (nearest treelet, origin cell, octant), their effective
// tmax (dead lanes <= 0), their pending bit words [N, k32] (uint32 held in
// int32) and their nearest pending treelet (K if none), and the
// ptr-encoded treelet roots [K].
//
// Design: one thread per sorted ray, each walking its own stack in local
// memory (the TPU kernel's block-shared SMEM stack, block-OR'd masks and
// DMA row ring are not carried over). Leaf visits are visit.cuh's, shared
// with traverse.cu. Rows are read by stride, so any width and slot count
// work; dispatch picks this kernel only for the reference's 8-wide /
// 8-slot trees (treelet.available).
//
// Child test: the reference treelet kernel's own form (treelet.py:217-229),
// slabs as (b - o) * inv and a hit as tnear <= tfar && tfar >= 0 &&
// tnear <= prune; the plain version (packet._walk, treelet_form=True)
// evaluates the same expressions in the same order.
//
// What bounds it on this card: as traverse.cu, dependent row loads served
// from L2 and warp divergence; on top, every pending treelet costs at least
// one root visit, even when t_best already prunes it. The sort by nearest
// treelet is what keeps a warp's rays in one subtree.

#include "visit.cuh"

namespace {

using namespace msn;

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) treelet_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
    int node_stride, int leaf_stride, int width, int slots,
    const int32_t* __restrict__ roots, int k, const int32_t* __restrict__ pend,
    int k32, const int32_t* __restrict__ first,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_eff, int n, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float o[3], d[3], inv[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = ray_o[3 * i + c];
    d[c] = ray_d[3 * i + c];
    inv[c] = safe_inv(d[c]);
  }
  const float tmax = t_eff[i];

  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occluded = false;
  int stack[kStackCap];

  // Walk the subtree under one treelet root (>= 0 node, <= -2 leaf).
  auto walk = [&](int root) {
    int top = 0;
    stack[top++] = root;
    while (top > 0) {
      const int node = stack[--top];
      if (node >= 0) {
        const float* row = nodes + (size_t)node * node_stride;
        const float axis = ld(row + 7 * width);
        const int ax = axis < 0.5f ? 0 : (axis < 1.5f ? 1 : 2);
        const bool fwd = d[ax] >= 0.0f;  // near children sit at low slots
        const float prune = AnyHit ? tmax : t_best;
        for (int kk = 0; kk < width; ++kk) {
          const int j = fwd ? width - 1 - kk : kk;  // push far first
          const float ptr = ld(row + 6 * width + j);
          if (ptr == -1.0f) continue;
          const float a0 = (ld(row + 0 * width + j) - o[0]) * inv[0];
          const float b0 = (ld(row + 3 * width + j) - o[0]) * inv[0];
          const float a1 = (ld(row + 1 * width + j) - o[1]) * inv[1];
          const float b1 = (ld(row + 4 * width + j) - o[1]) * inv[1];
          const float a2 = (ld(row + 2 * width + j) - o[2]) * inv[2];
          const float b2 = (ld(row + 5 * width + j) - o[2]) * inv[2];
          const float tnear =
              fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
          const float tfar =
              fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
          if (tnear <= tfar && tfar >= 0.0f && tnear <= prune) {
            stack[top++] = (int)ptr;
          }
        }
      } else {
        const float* row = leaves + (size_t)(-2 - node) * leaf_stride;
        if (visit_leaf<AnyHit>(row, slots, o, d, tmax, t_best, best_tri,
                               best_u, best_v)) {
          occluded = true;
          return;
        }
      }
    }
  };

  if (tmax > 0.0f) {
    const int f = first[i];
    if (f < k) walk(roots[f]);
    const int32_t* words = pend + (size_t)i * k32;
    for (int w = 0; w < k32 && !(AnyHit && occluded); ++w) {
      unsigned int bits = (unsigned int)words[w];
      while (bits != 0u) {
        const int tid = w * 32 + (__ffs(bits) - 1);
        bits &= bits - 1u;
        if (tid == f) continue;
        walk(roots[tid]);
        if (AnyHit && occluded) break;
      }
    }
  }

  if (AnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    t_out[i] = best_tri >= 0 ? t_best : tmax;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

extern "C" {

int msn_treelet_stack_capacity() { return kStackCap; }

// Each entry point launches on `stream` and returns cudaGetLastError().
int msn_treelet_closest_hit(
    const float* nodes, const float* leaves, int node_stride,
    int leaf_stride, int width, int slots, const int32_t* roots, int k,
    const int32_t* pend, int k32, const int32_t* first, const float* ray_o,
    const float* ray_d, const float* t_eff, int n, float* t_out,
    int32_t* tri_out, float* u_out, float* v_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  treelet_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, roots, k, pend,
      k32, first, ray_o, ray_d, t_eff, n, t_out, tri_out, u_out, v_out,
      nullptr);
  return (int)cudaGetLastError();
}

int msn_treelet_any_hit(
    const float* nodes, const float* leaves, int node_stride,
    int leaf_stride, int width, int slots, const int32_t* roots, int k,
    const int32_t* pend, int k32, const int32_t* first, const float* ray_o,
    const float* ray_d, const float* t_eff, int n, uint8_t* occ_out,
    void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  treelet_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, roots, k, pend,
      k32, first, ray_o, ray_d, t_eff, n, nullptr, nullptr, nullptr, nullptr,
      occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
