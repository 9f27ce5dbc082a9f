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
// Design: one thread per ray, as traverse.cu, with its own stack; only the
// record reads differ. The TPU kernel decodes a tile vector-side for a
// block of 8192 rays at once and ORs their hits into one mask per visit;
// here each thread reads the words of the children it tests through
// __ldg. Empty child slots (and the width padding of the last sublane
// group) are skipped by their pointer, -1, never entered: the reference
// enters them through their inverted boxes and revisits leaf 0 for each.
// Children are pushed far-to-near by the thread's own direction sign on
// the tile's axis (the TPU uses the live block's majority sign), which
// changes only the order of equal-t ties.
//
// What bounds it on this card: as traverse.cu, dependent L2 loads per
// visit and divergence. A tile keeps one child's six bounds in 24
// contiguous bytes (a row spreads them over six runs 4 * width bytes
// apart), so a child test touches one or two 32-byte sectors instead of
// six, while the tiles of a large tree are 4-8x its rows (room_184k at
// 24/24: 49.5 MB against 12.4 MB, about the size of L2). This first kernel
// does nothing more: warp-cooperative tile decode, shared-memory staging
// of a node tile and TMA are later work.
//
// Numerics: visit.cuh's, in packet._walk's order and expressions, so with
// -fmad=false the kernel equals its plain torch version
// (accel/vpacket.py) and traverse.cu's kernel on the same tree bit for
// bit. Contract (traverse.cu's): a lane with active == 0 has its tmax
// replaced by -1e30 and is never traversed; tmax <= 0 marks a dead lane.
// Closest hit writes t = the caller's tmax, tri = -1, u = v = 0 on a miss
// or dead lane. Any hit writes 1 for occluded in (0, tmax), else 0.

#include "visit.cuh"

namespace {

using namespace msn;

constexpr int kLanes = 128;
constexpr int kAxisLane = 63;
constexpr int kPtrLane0 = 64;

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock) vpacket_kernel(
    const float* __restrict__ nodes, const float* __restrict__ leaves,
    int node_stride, int leaf_stride, int width, int slots,
    const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, const float* __restrict__ t_max,
    const uint8_t* __restrict__ active, int n, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
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
      const float* tile = nodes + (size_t)node * node_stride;
      const float axis = ld(tile + kAxisLane);
      const int ax = axis < 0.5f ? 0 : (axis < 1.5f ? 1 : 2);
      const bool fwd = d[ax] >= 0.0f;  // near children sit at low slots
      const float prune = AnyHit ? tmax : t_best;
      for (int k = 0; k < width; ++k) {
        const int j = fwd ? width - 1 - k : k;  // push far first
        const float ptr = ld(tile + kPtrLane0 + j);
        if (ptr == -1.0f) continue;
        const float* b = tile + (j & 7) * kLanes + 6 * (j >> 3);
        float tnear, tfar;
        {
          const float a0 = ld(b + 0) * inv[0] - oinv[0];
          const float b0 = ld(b + 3) * inv[0] - oinv[0];
          const float a1 = ld(b + 1) * inv[1] - oinv[1];
          const float b1 = ld(b + 4) * inv[1] - oinv[1];
          const float a2 = ld(b + 2) * inv[2] - oinv[2];
          const float b2 = ld(b + 5) * inv[2] - oinv[2];
          tnear = fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
          tfar = fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
        }
        if (fmaxf(tnear, 0.0f) <= fminf(tfar, prune)) {
          stack[top++] = (int)ptr;
        }
      }
    } else {
      const float* tile = leaves + (size_t)(-2 - node) * leaf_stride;
      const auto field = [=](int f, int j) {
        return tile + (j & 7) * kLanes + 10 * (j >> 3) + f;
      };
      if (visit_leaf_fields<AnyHit>(field, slots, o, d, tmax, t_best,
                                    best_tri, best_u, best_v)) {
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

int msn_v_stack_capacity() { return kStackCap; }

// traverse.cu's entry points over tiles: node_stride and leaf_stride are
// the tile size (8 * 128 floats). Each launches on `stream` and returns
// cudaGetLastError().
int msn_v_closest_hit(const float* nodes, const float* leaves,
                      int node_stride, int leaf_stride, int width, int slots,
                      const float* ray_o, const float* ray_d,
                      const float* t_max, const uint8_t* active, int n,
                      float* t_out, int32_t* tri_out, float* u_out,
                      float* v_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  vpacket_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, ray_o, ray_d,
      t_max, active, n, t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

int msn_v_any_hit(const float* nodes, const float* leaves, int node_stride,
                  int leaf_stride, int width, int slots, const float* ray_o,
                  const float* ray_d, const float* t_max,
                  const uint8_t* active, int n, uint8_t* occ_out,
                  void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  vpacket_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      nodes, leaves, node_stride, leaf_stride, width, slots, ray_o, ray_d,
      t_max, active, n, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
