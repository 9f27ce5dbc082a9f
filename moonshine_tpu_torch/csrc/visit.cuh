// Visit code shared by the traversal kernels (traverse.cu, treelet.cu,
// vpacket.cu): the two triangle tests, the leaf visit over a row and the
// stack capacity.
//
// Numerics: the kernels are built with -fmad=false and IEEE division, so
// every expression here rounds like the plain torch versions beside their
// wrappers (moonshine_tpu_torch/accel/packet.py), which evaluate the same
// expressions in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msn {

// Traversal pushes at most (width-1)*depth+1 entries; the wrappers refuse
// trees whose bound exceeds this capacity (see msn_stack_capacity). 512 is
// the reference's VMEM-class limit (moonshine_tpu/accel/packet.py:55); its
// HBM-class limit of 256 is applied by dispatch, not here. Each kernel
// holds its stacks in shared memory, sized by the tree's own bound.
constexpr int kStackCap = 512;
constexpr float kTiny = 1e-12f;
constexpr float kDead = -1.0e30f;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// 1/d with |d| clamped away from 0 (the reference's _load_rays).
__device__ __forceinline__ float safe_inv(float d) {
  const float den = fabsf(d) < kTiny ? (d >= 0.0f ? kTiny : -kTiny) : d;
  return 1.0f / den;
}

// Moller-Trumbore with exact division (closest hit).
__device__ __forceinline__ bool tri_closest(
    const float v0[3], const float e1[3], const float e2[3],
    const float o[3], const float d[3], float t_best,
    float& t, float& u, float& v) {
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  const float det_c = fabsf(det) < kTiny ? kTiny : det;
  const float inv_det = 1.0f / det_c;
  const float tx = o[0] - v0[0];
  const float ty = o[1] - v0[1];
  const float tz = o[2] - v0[2];
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det;
  return (fabsf(det) > kTiny) && (u >= 0.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t > 0.0f) && (t < t_best);
}

// Division-free occlusion test: the numerators scaled by |det|.
__device__ __forceinline__ bool tri_any(
    const float v0[3], const float e1[3], const float e2[3],
    const float o[3], const float d[3], float t_max) {
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  const float s = det >= 0.0f ? 1.0f : -1.0f;
  const float tx = o[0] - v0[0];
  const float ty = o[1] - v0[1];
  const float tz = o[2] - v0[2];
  const float u_n = (tx * px + ty * py + tz * pz) * s;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  const float v_n = (d[0] * qx + d[1] * qy + d[2] * qz) * s;
  const float t_n = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * s;
  const float det_a = det * s;
  return (det_a > kTiny) && (u_n >= 0.0f) && (v_n >= 0.0f) &&
         (u_n + v_n <= det_a) && (t_n > 0.0f) && (t_n < t_max * det_a);
}

// One leaf visit: every occupied slot of a leaf row against the ray, field
// f (v0 xyz, e1 xyz, e2 xyz, tid) of slot j at row[f * slots + j]. Closest
// hit keeps the strict `t < t_best` rule; any hit returns true at the
// first occluder.
template <bool AnyHit>
__device__ __forceinline__ bool visit_leaf(
    const float* row, int slots, const float o[3], const float d[3],
    float tmax, float& t_best, int& best_tri, float& best_u, float& best_v) {
  for (int j = 0; j < slots; ++j) {
    const float tid = ld(row + 9 * slots + j);
    if (tid < 0.0f) continue;  // empty slot
    float v0[3], e1[3], e2[3];
    for (int c = 0; c < 3; ++c) {
      v0[c] = ld(row + c * slots + j);
      e1[c] = ld(row + (3 + c) * slots + j);
      e2[c] = ld(row + (6 + c) * slots + j);
    }
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
  return false;
}

}  // namespace msn
