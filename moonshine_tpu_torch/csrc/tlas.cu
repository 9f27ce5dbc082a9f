// Two-level (instanced) traversal, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference walks the two-level structure
// in jnp (moonshine_tpu/accel/tlas.py `closest_hit_tlas` /
// `any_hit_tlas`, one lockstep lax.while_loop, :223-411), and its torch
// twin (moonshine_tpu_torch/accel/tlas.py `_walk_plain`) launches a few
// dozen small kernels and a host read per iteration. This is that walk as
// one kernel.
//
// Design: one thread per ray, 128 a block, every array read through the
// read-only cache. A thread walks the top level by skip links; at an
// instance leaf it moves its ray into the instance's object space (the
// direction is not renormalised, so t stays world t) and walks that
// instance's BLAS from its root until the escape link is -1, then goes on
// at the top-level leaf's escape. Each trip round the loop is one step of
// one level, as each iteration of the reference's loop is for one lane.
// Any hit stops at the first occluder. A simple kernel; making it fast
// (packets, a stack, wide nodes) is later work.
//
// Numerics: built with -fmad=false and IEEE division, the box test, the
// triangle test (accel/traverse.py `_aabb_hit`, `_tri_intersect`),
// `_safe_inv` and the object-space transform (r0 x + r1 y + r2 z + t) are
// the plain version's expressions in its order, and a min or max with a
// NaN operand fails the box as torch's does, so the outputs equal the
// plain version's bit for bit.

#include <cuda_runtime.h>

#include "visit.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kBlasLeaf = 4;  // triangles a BLAS leaf (tlas.BLAS_LEAF)

struct Tlas {
  const float* top_min;
  const float* top_max;
  const int* top_left;
  const int* top_count;
  const int* top_escape;
  const int* top_inst;
  const float* blas_min;
  const float* blas_max;
  const int* blas_left;
  const int* blas_count;
  const int* blas_escape;
  const float* blas_tris;  // [Ts, 3, 3]
  const int* blas_tri_id;
  const int* inst_root;
  const float* inst_inv;  // [I, 12]
  int num_instances;
  int num_tris;
};

__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

// traverse.py _aabb_hit: slabs, the largest entry against the smallest
// exit, exit ahead of the origin, entry no later than t_best.
__device__ __forceinline__ bool aabb_hit(const float* mn, const float* mx,
                                        const float o[3], const float inv[3],
                                        float t_best) {
  float tnear = 0.0f, tfar = 0.0f;
  bool nan = false;
  for (int c = 0; c < 3; ++c) {
    const float t0 = (msn::ld(mn + c) - o[c]) * inv[c];
    const float t1 = (msn::ld(mx + c) - o[c]) * inv[c];
    nan |= isnan(t0) || isnan(t1);
    const float lo = fminf(t0, t1);
    const float hi = fmaxf(t0, t1);
    tnear = c == 0 ? lo : fmaxf(tnear, lo);
    tfar = c == 0 ? hi : fminf(tfar, hi);
  }
  return !nan && (tnear <= tfar) && (tfar >= 0.0f) && (tnear <= t_best);
}

// traverse.py _tri_intersect over the corners (Moller-Trumbore, exact
// division, t in (0, t_best)).
__device__ __forceinline__ bool tri_hit(const float* tv, const float o[3],
                                        const float d[3], float t_best,
                                        float& t, float& u, float& v) {
  float v0[3], e1[3], e2[3];
  for (int c = 0; c < 3; ++c) {
    v0[c] = msn::ld(tv + c);
    e1[c] = msn::ld(tv + 3 + c) - v0[c];
    e2[c] = msn::ld(tv + 6 + c) - v0[c];
  }
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  const float inv_det = 1.0f / (fabsf(det) < msn::kTiny ? msn::kTiny : det);
  const float tx = o[0] - v0[0];
  const float ty = o[1] - v0[1];
  const float tz = o[2] - v0[2];
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det;
  return (fabsf(det) > msn::kTiny) && (u >= 0.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t > 0.0f) && (t < t_best);
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock)
    tlas_kernel(Tlas T, const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ t_max,
                const bool* __restrict__ active, int n,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ inst_out, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv_dw[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = ray_o[3 * i + c];
    d[c] = ray_d[3 * i + c];
    inv_dw[c] = msn::safe_inv(d[c]);
  }
  const float t_lane = t_max[i];
  float t_best = t_lane, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, best_inst = -1;
  bool occluded = false;
  int tcur = (active == nullptr || active[i]) ? 0 : -1;
  int bcur = -1, inst = 0;
  float oo[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f};
  float inv_do[3] = {0.0f, 0.0f, 0.0f};

  while (tcur >= 0 || bcur >= 0) {
    const float prune = AnyHit ? t_lane : t_best;
    if (bcur < 0) {  // top level
      const int node = tcur;
      const bool box = aabb_hit(T.top_min + 3 * node, T.top_max + 3 * node,
                                o, inv_dw, prune);
      const bool leaf = ldi(T.top_count + node) > 0;
      const int left = ldi(T.top_left + node);
      tcur = (box && !leaf) ? left : ldi(T.top_escape + node);
      if (box && leaf) {  // enter the instance
        inst = ldi(T.top_inst + min(max(left, 0), T.num_instances - 1));
        const float* r = T.inst_inv + 12 * inst;
        for (int c = 0; c < 3; ++c) {
          const float r0 = msn::ld(r + 3 * c), r1 = msn::ld(r + 3 * c + 1);
          const float r2 = msn::ld(r + 3 * c + 2);
          oo[c] = r0 * o[0] + r1 * o[1] + r2 * o[2] + msn::ld(r + 9 + c);
          dd[c] = r0 * d[0] + r1 * d[1] + r2 * d[2];
        }
        for (int c = 0; c < 3; ++c) inv_do[c] = msn::safe_inv(dd[c]);
        bcur = ldi(T.inst_root + inst);
      }
    } else {  // inside a BLAS, in object space
      const int node = bcur;
      const bool box = aabb_hit(T.blas_min + 3 * node,
                                T.blas_max + 3 * node, oo, inv_do, prune);
      const int left = ldi(T.blas_left + node);
      const int cnt = ldi(T.blas_count + node);
      const bool leaf = cnt > 0;
      bool found = false;
      if (box && leaf) {
        for (int j = 0; j < kBlasLeaf; ++j) {
          if (j >= cnt) break;
          const int s = min(max(left + j, 0), T.num_tris - 1);
          float t, u, v;
          // closest hit: each triangle against the t_best the last one left
          if (tri_hit(T.blas_tris + 9 * s, oo, dd, AnyHit ? t_lane : t_best,
                      t, u, v)) {
            if (AnyHit) {
              found = true;
              break;
            }
            t_best = t;
            best_tri = ldi(T.blas_tri_id + s);
            best_u = u;
            best_v = v;
            best_inst = inst;
          }
        }
      }
      bcur = (box && !leaf) ? left : ldi(T.blas_escape + node);
      if (found) {  // any hit: the lane is done
        occluded = true;
        tcur = bcur = -1;
      }
    }
  }
  if (AnyHit) {
    occ_out[i] = occluded;
  } else {
    t_out[i] = t_best;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
    inst_out[i] = best_inst;
  }
}

template <bool AnyHit>
int launch(const Tlas& T, const float* ray_o, const float* ray_d,
           const float* t_max, const bool* active, int n, float* t,
           int* tri, float* u, float* v, int* inst, bool* occ,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  tlas_kernel<AnyHit><<<blocks, kBlock, 0, stream>>>(
      T, ray_o, ray_d, t_max, active, n, t, tri, u, v, inst, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MSN_TLAS_ARGS                                                      \
  const float *top_min, const float *top_max, const int *top_left,         \
      const int *top_count, const int *top_escape, const int *top_inst,    \
      const float *blas_min, const float *blas_max, const int *blas_left,  \
      const int *blas_count, const int *blas_escape,                       \
      const float *blas_tris, const int *blas_tri_id,                      \
      const int *inst_root, const float *inst_inv, int num_instances,      \
      int num_tris
#define MSN_TLAS_STRUCT                                                    \
  Tlas{top_min,    top_max,    top_left,    top_count, top_escape,         \
       top_inst,   blas_min,   blas_max,    blas_left, blas_count,         \
       blas_escape, blas_tris, blas_tri_id, inst_root, inst_inv,           \
       num_instances, num_tris}

extern "C" {

// The TLAS arrays (accel/tlas.py TLAS, contiguous: float32 boxes,
// triangles and inverse transforms, int32 links), then the rays: ray_o,
// ray_d float32 [n, 3], t_max float32 [n], active bool [n] or NULL; the
// outputs; the stream. Returns a cudaError_t code (0 on success).
int msn_tlas_closest_hit(MSN_TLAS_ARGS, const float* ray_o,
                         const float* ray_d, const float* t_max,
                         const bool* active, int n, float* t, int* tri,
                         float* u, float* v, int* inst,
                         cudaStream_t stream) {
  return launch<false>(MSN_TLAS_STRUCT, ray_o, ray_d, t_max, active, n, t,
                       tri, u, v, inst, nullptr, stream);
}

int msn_tlas_any_hit(MSN_TLAS_ARGS, const float* ray_o, const float* ray_d,
                     const float* t_max, const bool* active, int n,
                     bool* occluded, cudaStream_t stream) {
  return launch<true>(MSN_TLAS_STRUCT, ray_o, ray_d, t_max, active, n,
                      nullptr, nullptr, nullptr, nullptr, nullptr, occluded,
                      stream);
}

}  // extern "C"
