// Wide-BVH ray traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the two Pallas TPU kernels built by
// moonshine_tpu/accel/packet.py::_make_kernel (any_hit=False reached via
// _closest_impl / closest_hit_packet[_hbm]; any_hit=True via _anyhit_impl /
// any_hit_packet[_hbm]). One template on AnyHit serves both, and one kernel
// serves both residencies: the card has no VMEM/HBM split to choose.
//
// Design: one thread per ray. The TPU kernel shares one traversal stack
// across a block of 8192 rays (scalar-indexed rows, vector math over
// lanes); here each thread walks its own stack in local memory, so no
// thread visits a node its ray does not enter. Children are pushed
// far-to-near using the thread's own direction sign on the node's sort
// axis (the TPU uses the block's majority sign).
//
// What bounds it on this card: every visit is a chain of dependent loads
// (pop -> row address -> 113..256 floats of the row) with no reuse inside
// a warp once its rays diverge; rows of the scenes this renders (1-40 MB)
// stay resident in the 50 MB L2, so the visit cost is L2 latency times the
// visit count, and warp divergence (threads of a warp at different depths
// or in leaf vs internal visits) idles lanes. This first kernel does
// nothing about either beyond __ldg reads; packet or wavefront scheduling,
// ray sorting, wider loads and FMA are later work.
//
// Numerics: see visit.cuh (shared with treelet.cu). Closest hit keeps the
// reference's strict `t < t_best` rule within a leaf; any hit uses the
// division-free, sign-folded test. Equal-t ties may pick a different
// triangle than the TPU's traversal order does.
//
// Contract (as the JAX wrappers have it): a lane with active == 0 has its
// tmax replaced by -1e30 and is never traversed; tmax <= 0 marks a dead
// lane. Closest hit writes t = the caller's tmax, tri = -1, u = v = 0 on a
// miss or dead lane. Any hit writes 1 for occluded in (0, tmax), else 0.

#include "visit.cuh"

namespace {

using namespace msn;

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) traverse_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
    int node_stride, int leaf_stride, int width, int slots,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_max, const uint8_t* __restrict__ active,
    int n, float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float o[3], d[3], inv[3], oinv[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = ray_o[3 * i + c];
    d[c] = ray_d[3 * i + c];
    inv[c] = safe_inv(d[c]);
    oinv[c] = o[c] * inv[c];
  }
  const float t_caller = t_max[i];
  const float tmax = (active == nullptr || active[i]) ? t_caller : kDead;

  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  bool occluded = false;

  int stack[kStackCap];
  int top = 0;
  if (tmax > 0.0f) stack[top++] = 0;

  while (top > 0) {
    const int node = stack[--top];
    if (node >= 0) {
      const float* row = nodes + (size_t)node * node_stride;
      const float axis = ld(row + 7 * width);
      const int ax = axis < 0.5f ? 0 : (axis < 1.5f ? 1 : 2);
      const bool fwd = d[ax] >= 0.0f;  // near children sit at low slots
      const float prune = AnyHit ? tmax : t_best;
      for (int k = 0; k < width; ++k) {
        const int j = fwd ? width - 1 - k : k;  // push far first
        const float ptr = ld(row + 6 * width + j);
        if (ptr == -1.0f) continue;
        float tnear, tfar;
        {
          const float a0 = ld(row + 0 * width + j) * inv[0] - oinv[0];
          const float b0 = ld(row + 3 * width + j) * inv[0] - oinv[0];
          const float a1 = ld(row + 1 * width + j) * inv[1] - oinv[1];
          const float b1 = ld(row + 4 * width + j) * inv[1] - oinv[1];
          const float a2 = ld(row + 2 * width + j) * inv[2] - oinv[2];
          const float b2 = ld(row + 5 * width + j) * inv[2] - oinv[2];
          tnear = fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
          tfar = fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
        }
        if (fmaxf(tnear, 0.0f) <= fminf(tfar, prune)) {
          stack[top++] = (int)ptr;
        }
      }
    } else {
      const float* row = leaves + (size_t)(-2 - node) * leaf_stride;
      if (visit_leaf<AnyHit>(row, slots, o, d, tmax, t_best, best_tri,
                             best_u, best_v)) {
        occluded = true;
        break;
      }
    }
  }

  if (AnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    t_out[i] = best_tri >= 0 ? t_best : t_caller;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

extern "C" {

int msn_stack_capacity() { return kStackCap; }

// Each entry point launches on `stream` and returns cudaGetLastError():
// a launch the card refuses never runs, and only this code reports it.
int msn_closest_hit(const float* nodes, const float* leaves, int node_stride,
                    int leaf_stride, int width, int slots, const float* ray_o,
                    const float* ray_d, const float* t_max,
                    const uint8_t* active, int n, float* t_out,
                    int32_t* tri_out, float* u_out, float* v_out,
                    void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, ray_o, ray_d,
      t_max, active, n, t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

int msn_any_hit(const float* nodes, const float* leaves, int node_stride,
                int leaf_stride, int width, int slots, const float* ray_o,
                const float* ray_d, const float* t_max, const uint8_t* active,
                int n, uint8_t* occ_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, ray_o, ray_d,
      t_max, active, n, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
