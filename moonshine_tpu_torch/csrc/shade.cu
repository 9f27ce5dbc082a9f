// The bounce's shading, for Hopper (sm_90a): the surface decode with the
// bounce's light draw, the environment lookups and the BSDF scatter of one
// bounce segment.
//
// Replaces no pallas_call: on the TPU these are jnp, fused by XLA around
// the reference's one-hot gathers (moonshine_tpu/core/gather.py:61
// gather_rows, :78 shift_gather_rows, :126 weighted_gather_rows), which
// exist so that the per-hit table fetches (shading rows, material rows,
// atlas and env texels, emitter rows) run at the chip's speed next to the
// math that consumes them. Here each stage is one kernel, one thread a
// lane:
//
//   surface   moonshine_tpu/integrator/path.py:424-485 with :119-256 (the
//             tri_shade row fetch, the two-level instance transform, the
//             interpolation and frames, the material row or its 4-tap
//             atlas fetch, the normal-map frame, the shading-normal
//             selection and the emissive term with its MIS weight); in the
//             full form then :503-573 (the max-bounce cut, the roulette,
//             each env sample, lights/envmap.py:120-138's alias draw,
//             texel row, equal-area forward map and pdf, and each
//             mesh-light sample, lights/mesh_lights.py:29-71 with
//             core/gather.py:61's emitter-row fetch and _emissive_at, and
//             its shadow ray into the [S * N] batch the any-hit launch
//             takes); a thin form for the last segment; and the direct
//             integrator's form, moonshine_tpu/integrator/direct.py:46-86
//             with :103-124 (its decode and emission, then the same draws
//             without the cut, the roulette or the delta exclusion, each
//             mesh-light shadow ray one-ended: from the hit along the
//             light's direction, to the light's offset point's distance)
//   scatter   path.py:583-623 and bsdf/materials.py:278-370 (each light
//             sample's occlusion, frame change, eval+pdf and power
//             heuristic; the PCG draw, the BSDF sample and eval, the new
//             ray and throughput); a weight-only form, direct.py:89-100
//             (the light samples' weighting alone, at unit throughput)
//   env_miss  path.py:371-381 with lights/envmap.py:141-206 (equal-area
//             inverse, texel row, 4-tap bilinear, MIS weight) and the
//             mask that follows (path.py:402-421, active & is_hit), in
//             place: only a lane that missed reads more than its mask and
//             tri, or writes
//
// The bounce loop's counts ride on the kernels that write the masks
// (path.py:580 jnp.sum(lane), the shadow rays traced, and :687 the live
// count; :400's lanes traced are the last live count): the full and
// direct surface forms add the shadow rays they set to a device scalar,
// the path's scatter the lanes it leaves live, each warp once where its
// sum is not 0 (a warp sum, then one atomic; a block barrier cost three
// times as much).
//
// What bounds them on this card: bytes. Each live lane reads its state and
// one 192-byte shading row (plus atlas texels, instance transforms, env
// texels and emitter rows) and writes its outputs once; the arithmetic is
// a few hundred flops a lane, below the H100's 20 flops a byte. The design
// keeps every intermediate (corners, frames, BSDF terms, light samples,
// MIS weights) in registers, where the plain torch version writes and
// reads a whole [N] or [N, 3] tensor for each op. What it does about the
// bytes: a lane dead on entry reads its mask and leaves (the surface
// clears its shadow lanes, the scatter its mask; the miss writes nothing,
// and there a live lane that hit leaves after its tri); the lane state is
// updated in place, so a lane writes only what changes; a light sample's
// inputs are read only where its ray was traced and not occluded; an
// [N, 3] value moves as an 8-byte and a 4-byte access (`load3`), the
// material row as four float4s. The tagged union is a switch on the
// material type, not all four models and three selects.
//
// Numerics: each operation is the one the plain torch version runs on the
// card, in its order, built with -fmad=false so that no multiply and add
// fuse where torch's separate kernels round twice. Where one torch kernel
// does several operations, the order and fusion its CUDA kernel uses are
// reproduced: a 3-element sum over the last axis is ((a0 + a2) + a1) + 0
// (two lanes of its reduce split the axis), torch.linalg.cross is
// fma(a_i, b_j, -(a_j * b_i)), the instance transform's einsum (cuBLAS
// batched 3x3 products) is an fma chain over j from 0, and a division by
// a Python scalar is a product with the scalar's float32 reciprocal.
// Constants are the plain version's Python doubles cast to float32.
// sqrt, rsqrt, sin, cos, atan2, pow and floor are the CUDA math
// functions torch's kernels call. So the kernels equal the plain version
// bit for bit on every lane they write, which the tests and chip_smoke.py
// check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

// mathutil.PI and the products the plain version forms in Python doubles
constexpr float kPi = (float)3.14159265;
constexpr float kInvPi = 1.0f / kPi;  // x / PI: x * (1 / float(PI))
constexpr float kTwoPi = (float)(2.0 * 3.14159265);
constexpr float kPiOver4 = (float)(3.14159265 / 4.0);
constexpr float kPiOver2 = (float)(3.14159265 / 2.0);
constexpr float kTwoOverPi = (float)(2.0 / 3.14159265);
constexpr float kInv4PiDiv = 1.0f / (float)(4.0 * 3.14159265);  // x / (4 PI)
constexpr float kUniformPdf = (float)(1.0 / (4.0 * 3.14159265));  // full()
constexpr float kAirIor = (float)1.000277;

enum Mode { kFull = 0, kThin = 1, kDirect = 2 };
enum Material { kGlass = 0, kLambert = 1, kMirror = 2, kPbr = 3 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}

// A lane's [N, 3] value as two accesses, an 8-byte one where it is
// aligned: at an even lane the first two floats, at an odd one the last
// two (torch's allocations are aligned far beyond 8 bytes)
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  const float* q = p + 3 * i;
  if ((reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    const float2 a = *reinterpret_cast<const float2*>(q);
    return v3(a.x, a.y, q[2]);
  }
  const float2 b = *reinterpret_cast<const float2*>(q + 1);
  return v3(q[0], b.x, b.y);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  float* q = p + 3 * i;
  if ((reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    *reinterpret_cast<float2*>(q) = make_float2(v.x, v.y);
    q[2] = v.z;
  } else {
    q[0] = v.x;
    *reinterpret_cast<float2*>(q + 1) = make_float2(v.y, v.z);
  }
}

// torch.clamp_min / clamp on the card: NaN passes through
__device__ __forceinline__ float cmin(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float cclamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// torch.minimum / maximum
__device__ __forceinline__ float tminimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmaximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.sign
__device__ __forceinline__ float tsign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// torch.sum over a last axis of 3 (or 2) on the card
__device__ __forceinline__ float tsum3(float a, float b, float c) {
  return ((a + c) + b) + 0.0f;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return tsum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float norm(V3 v) { return sqrtf(dot(v, v)); }
__device__ __forceinline__ V3 normalize(V3 v) { return v / norm(v); }
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  return v / cmin(norm(v), 1e-20f);
}
// torch.linalg.cross on the card
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -(a.z * b.y)),
            __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}
__device__ __forceinline__ V3 face_forward(V3 n, V3 d) {
  return dot(n, d) > 0.0f ? n : -n;
}

// mathutil.offset_along_normal
__device__ __forceinline__ float offset1(float p, float n) {
  const unsigned of_i = (unsigned)(int)(n * 256.0f);  // int32 wraps
  const unsigned p_i = (unsigned)__float_as_int(p) + (p < 0.0f ? 0u - of_i
                                                               : of_i);
  return fabsf(p) < (1.0f / 32.0f) ? p + n * (1.0f / 65536.0f)
                                   : __int_as_float((int)p_i);
}
__device__ __forceinline__ V3 offset_along_normal(V3 p, V3 n) {
  return v3(offset1(p.x, n.x), offset1(p.y, n.y), offset1(p.z, n.z));
}

// power_heuristic(numf, f_pdf, numg, g_pdf); numf * f_pdf and numg * g_pdf
// are formed by the caller
__device__ __forceinline__ float power2(float f, float g) {
  const float f2 = f * f;
  return f2 / cmin(f2 + g * g, 1e-30f);
}

// ---- frames (core/frame.py)

struct Frame {
  V3 n, s, t;
};

__device__ __forceinline__ Frame reorthogonalize(V3 n, V3 s) {
  const V3 s2 = safe_normalize(s - n * dot(n, s));
  return Frame{n, s2, safe_normalize(cross(n, s2))};
}
__device__ __forceinline__ V3 to_frame(const Frame& f, V3 v) {
  return v3(dot(f.s, v), dot(f.t, v), dot(f.n, v));
}
__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  return (f.s * v.x + f.t * v.y) + f.n * v.z;
}
// Frame.from_normal (mathutil.coordinate_system): (s, t)
__device__ __forceinline__ void from_normal(V3 v1, V3* s, V3* t) {
  const float x = v1.x, y = v1.y, z = v1.z;
  const float inv_a = rsqrtf(cmin(x * x + z * z, 1e-30f));
  const float inv_b = rsqrtf(cmin(y * y + z * z, 1e-30f));
  const V3 v2 = fabsf(x) > fabsf(y) ? v3(-z * inv_a, 0.0f, x * inv_a)
                                    : v3(0.0f, z * inv_b, -y * inv_b);
  *t = v2;
  *s = cross(v2, v1);
}

// ---- mappings (core/mappings.py)

__device__ __forceinline__ V3 equal_area_sphere(float sx, float sy) {
  const float ux = 2.0f * sx - 1.0f, uy = 2.0f * sy - 1.0f;
  const float px = fabsf(ux), py = fabsf(uy);
  const float signed_distance = 1.0f - (px + py);
  const float d = fabsf(signed_distance);
  const float r = 1.0f - d;
  const bool r_zero = r == 0.0f;
  const float phi =
      (r_zero ? 1.0f : (py - px) / (r_zero ? 1.0f : r) + 1.0f) * kPiOver4;
  const float z_mag = 1.0f - r * r;
  const float planar = r * sqrtf(cmin(2.0f - r * r, 0.0f));
  return v3(tsign(ux) * (cosf(phi) * planar),
            tsign(uy) * (sinf(phi) * planar), tsign(signed_distance) * z_mag);
}

__device__ __forceinline__ void equal_area_sphere_inverse(V3 dir, float* ou,
                                                          float* ov) {
  const float x = fabsf(dir.x), y = fabsf(dir.y), z = fabsf(dir.z);
  const float r = sqrtf(cmin(1.0f - z, 0.0f));
  float phi = (x == 0.0f && y == 0.0f)
                  ? 0.0f
                  : atan2f(tminimum(x, y), cmin(tmaximum(x, y), 1e-38f)) *
                        kTwoOverPi;
  phi = x < y ? 1.0f - phi : phi;
  float u = r - phi * r;
  float v = phi * r;
  if (dir.z < 0.0f) {
    const float u0 = u;
    u = 1.0f - v;
    v = 1.0f - u0;
  }
  u = u * tsign(dir.x);
  v = v * tsign(dir.y);
  *ou = (u + 1.0f) * 0.5f;
  *ov = (v + 1.0f) * 0.5f;
}

__device__ __forceinline__ void disk_concentric(float sx, float sy, float* dx,
                                                float* dy) {
  const float ux = 2.0f * sx - 1.0f, uy = 2.0f * sy - 1.0f;
  const bool x_major = fabsf(ux) > fabsf(uy);
  float r = x_major ? ux : uy;
  const float theta =
      x_major ? kPiOver4 * (uy / (ux == 0.0f ? 1.0f : ux))
              : kPiOver2 - kPiOver4 * (ux / (uy == 0.0f ? 1.0f : uy));
  if (ux == 0.0f && uy == 0.0f) r = 0.0f;
  *dx = r * cosf(theta);
  *dy = r * sinf(theta);
}

// coin_flip_remap(p, rand): (take, remapped)
__device__ __forceinline__ bool coin_flip(float p, float rand, float* out) {
  const bool take = rand < p;
  const float denom_t = p == 0.0f ? 1.0f : p;
  const float denom_f = p == 1.0f ? 1.0f : 1.0f - p;
  *out = take ? rand / denom_t : (rand - p) / denom_f;
  return take;
}

// ---- the PCG stream (core/rng.py), uint32 state held in int64

__device__ __forceinline__ float next_float(unsigned* state) {
  const unsigned a = *state * 747796405u + 2891336453u;
  *state = a;
  unsigned b = ((a >> ((a >> 28) + 4u)) ^ a) * 277803737u;
  b = (b >> 22) ^ b;
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

// ---- BSDFs (bsdf/materials.py)

struct Mat {
  int type;
  V3 color;
  float metal, alpha, ior;
};

__device__ __forceinline__ float tan2_theta(V3 v) {
  const float c2 = v.z * v.z;
  return cmin(1.0f - c2, 0.0f) / cmin(c2, 1e-30f);
}
__device__ __forceinline__ bool same_hemisphere(V3 a, V3 b) {
  return a.z * b.z > 0.0f;
}
__device__ __forceinline__ float ggx_d(float alpha, V3 m) {
  const float a2 = alpha * alpha;
  const float c2 = m.z * m.z;
  const float q = c2 * (a2 - 1.0f) + 1.0f;
  return a2 / cmin(kPi * (q * q), 1e-20f);
}
__device__ __forceinline__ float ggx_lambda(float alpha, V3 v) {
  return (sqrtf(1.0f + alpha * alpha * tan2_theta(v)) - 1.0f) * 0.5f;
}
__device__ __forceinline__ float ggx_g(float alpha, V3 wi, V3 wo) {
  return 1.0f / ((1.0f + ggx_lambda(alpha, wi)) + ggx_lambda(alpha, wo));
}
__device__ __forceinline__ float ggx_pdf(float alpha, V3 m) {
  return ggx_d(alpha, m) * fabsf(m.z);
}
__device__ __forceinline__ V3 ggx_sample(float alpha, V3 wo, float sx,
                                         float sy) {
  const float tan2 = alpha * alpha * sx / cmin(1.0f - sx, 1e-8f);
  const float cos2 = 1.0f / (1.0f + tan2);
  const float sin_t = sqrtf(cmin(1.0f - cos2, 0.0f));
  const float cos_t = sqrtf(cos2);
  const float phi = kTwoPi * sy;
  const V3 h = v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
  return same_hemisphere(wo, h) ? h : -h;
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta_i,
                                                    float eta_t) {
  float c = cclamp(cos_i, -1.0f, 1.0f);
  const bool entering = c > 0.0f;
  const float ei = entering ? eta_i : eta_t;
  const float et = entering ? eta_t : eta_i;
  c = fabsf(c);
  const float sin_i = sqrtf(cmin(1.0f - c * c, 0.0f));
  const float sin_t = ei / et * sin_i;
  const float cos_t = sqrtf(cmin(1.0f - sin_t * sin_t, 0.0f));
  const float r_parl = (et * c - ei * cos_t) / cmin(et * c + ei * cos_t, 1e-12f);
  const float r_perp = (ei * c - et * cos_t) / cmin(ei * c + et * cos_t, 1e-12f);
  const float f = (r_parl * r_parl + r_perp * r_perp) * 0.5f;
  return sin_t >= 1.0f ? 1.0f : f;
}

__device__ __forceinline__ float lambert_pdf(V3 wi, V3 wo) {
  return same_hemisphere(wi, wo) ? fabsf(wi.z) * kInvPi : 0.0f;
}
__device__ __forceinline__ V3 lambert_eval(V3 color) { return color * kInvPi; }
__device__ __forceinline__ V3 lambert_sample(V3 wo, float sx, float sy,
                                             float* pdf) {
  float dx, dy;
  disk_concentric(sx, sy, &dx, &dy);
  const float z = sqrtf(cmin(1.0f - ((dx * dx + dy * dy) + 0.0f), 0.0f));
  const V3 wi = v3(dx, dy, wo.z < 0.0f ? -z : z);
  *pdf = lambert_pdf(wi, wo);
  return wi;
}
__device__ __forceinline__ float micro_pdf(float alpha, V3 wi, V3 wo) {
  const V3 h = safe_normalize(wi + wo);
  const float pdf = ggx_pdf(alpha, h) / cmin(dot(wo, h) * 4.0f, 1e-12f);
  return same_hemisphere(wo, wi) ? pdf : 0.0f;
}
__device__ __forceinline__ V3 micro_sample(float alpha, V3 wo, float sx,
                                           float sy, float* pdf) {
  const V3 h = ggx_sample(alpha, wo, sx, sy);
  const float dh = dot(wo, h);
  const V3 wi = h * (2.0f * dh) - wo;
  const float p = ggx_pdf(alpha, h) / cmin(dh * 4.0f, 1e-12f);
  *pdf = same_hemisphere(wo, wi) ? p : 0.0f;
  return wi;
}
__device__ __forceinline__ float pbr_p_specular(float metal) {
  return 1.0f / (2.0f - metal);
}
__device__ __forceinline__ V3 pbr_sample(const Mat& m, V3 wo, float sx,
                                         float sy, float* pdf) {
  const float p_spec = pbr_p_specular(m.metal);
  float rx;
  if (coin_flip(p_spec, sx, &rx)) {
    float spec_pdf;
    const V3 dir = micro_sample(m.alpha, wo, rx, sy, &spec_pdf);
    const float other = lambert_pdf(dir, wo);
    *pdf = other + (spec_pdf - other) * p_spec;
    return dir;
  }
  float diff_pdf;
  const V3 dir = lambert_sample(wo, rx, sy, &diff_pdf);
  const float other = micro_pdf(m.alpha, dir, wo);
  *pdf = diff_pdf + (other - diff_pdf) * p_spec;
  return dir;
}
__device__ __forceinline__ float glass_fresnel(const Mat& m, V3 wo) {
  return fresnel_dielectric(wo.z, kAirIor, m.ior);
}
__device__ __forceinline__ V3 glass_sample(const Mat& m, V3 wo, float sx,
                                           float* pdf) {
  const float f = glass_fresnel(m, wo);
  if (sx < f) {
    *pdf = f;
    return v3(-wo.x, -wo.y, wo.z);
  }
  const bool entering = wo.z > 0.0f;
  const float eta_i = entering ? kAirIor : m.ior;
  const float eta_t = entering ? m.ior : kAirIor;
  const V3 n = v3(0.0f, 0.0f, entering ? 1.0f : -1.0f);
  const float eta = eta_i / eta_t;  // _refract_dir(w_o, n, eta)
  const float cos_i = dot(n, wo);
  const float sin2_i = cmin(1.0f - cos_i * cos_i, 0.0f);
  const float sin2_t = eta * eta * sin2_i;
  const bool valid = sin2_t < 1.0f;
  const float cos_t = sqrtf(cmin(1.0f - sin2_t, 0.0f));
  const float k = eta * cos_i - cos_t;
  const V3 d = (-wo) * eta + n * k;
  *pdf = valid ? 1.0f - f : 0.0f;
  return valid ? d : v3(0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ V3 glass_eval(const Mat& m, V3 wi, V3 wo) {
  const float f = glass_fresnel(m, wo);
  const float mag = (same_hemisphere(wi, wo) ? f : 1.0f - f) /
                    cmin(fabsf(wi.z), 1e-12f);
  return v3(mag, mag, mag);
}
__device__ __forceinline__ V3 mirror_eval(V3 wi) {
  const float mag = 1.0f / cmin(fabsf(wi.z), 1e-12f);
  return v3(mag, mag, mag);
}
__device__ __forceinline__ V3 pbr_eval_terms(const Mat& m, V3 wi, V3 wo, V3 h,
                                             float d_ggx, bool same_h) {
  const float cos_ih = dot(wi, h);
  const float f_diel = fresnel_dielectric(cos_ih, kAirIor, m.ior);
  const float w = powf(1.0f - cos_ih, 5.0f);  // schlick_weight
  const V3 one_minus = v3(1.0f - m.color.x, 1.0f - m.color.y,
                          1.0f - m.color.z);
  const V3 f_metal = m.color + one_minus * w;
  const V3 fd = v3(f_diel, f_diel, f_diel);
  const V3 fr = fd + (f_metal - fd) * m.metal;
  const float g = ggx_g(m.alpha, wi, wo);
  const float denom = 4.0f * fabsf(wi.z) * fabsf(wo.z);
  V3 spec = fr * (g * d_ggx / cmin(denom, 1e-12f));
  if (!same_h) spec = v3(0.0f, 0.0f, 0.0f);
  return spec + lambert_eval(m.color) * (1.0f - m.metal);
}

// eval_bsdf
__device__ __forceinline__ V3 eval_bsdf(const Mat& m, V3 wi, V3 wo) {
  switch (m.type) {
    case kGlass:
      return glass_eval(m, wi, wo);
    case kMirror:
      return mirror_eval(wi);
    case kPbr: {
      const V3 h = safe_normalize(wi + wo);
      return pbr_eval_terms(m, wi, wo, h, ggx_d(m.alpha, h),
                            same_hemisphere(wo, wi));
    }
    default:
      return lambert_eval(m.color);
  }
}

// eval_pdf_bsdf: (f, pdf)
__device__ __forceinline__ V3 eval_pdf_bsdf(const Mat& m, V3 wi, V3 wo,
                                            float* pdf) {
  switch (m.type) {
    case kGlass:
      *pdf = 0.0f;
      return glass_eval(m, wi, wo);
    case kMirror:
      *pdf = 0.0f;
      return mirror_eval(wi);
    case kPbr: {
      const V3 h = safe_normalize(wi + wo);
      const bool same_h = same_hemisphere(wo, wi);
      const float d_ggx = ggx_d(m.alpha, h);
      const float lam = same_h ? fabsf(wi.z) * kInvPi : 0.0f;
      float mic = d_ggx * fabsf(h.z) / cmin(dot(wo, h) * 4.0f, 1e-12f);
      mic = same_h ? mic : 0.0f;
      *pdf = lam + (mic - lam) * pbr_p_specular(m.metal);
      return pbr_eval_terms(m, wi, wo, h, d_ggx, same_h);
    }
    default:
      *pdf = same_hemisphere(wo, wi) ? fabsf(wi.z) * kInvPi : 0.0f;
      return lambert_eval(m.color);
  }
}

// sample_bsdf: (w_i, pdf)
__device__ __forceinline__ V3 sample_bsdf(const Mat& m, V3 wo, float sx,
                                          float sy, float* pdf) {
  switch (m.type) {
    case kGlass:
      return glass_sample(m, wo, sx, pdf);
    case kMirror:
      *pdf = 1.0f;
      return v3(-wo.x, -wo.y, wo.z);
    case kPbr:
      return pbr_sample(m, wo, sx, sy, pdf);
    default:
      return lambert_sample(wo, sx, sy, pdf);
  }
}

// ---- the environment map (lights/envmap.py)

struct Env {
  const float* rgbl;  // [S*S, 4]
  const float* select;  // [S*S]
  const long long* alias;  // [S*S]
  int size;
  float inv_integral;  // 1 / float32(max(integral, 1e-30)), as torch forms it
};

__device__ __forceinline__ V3 rgb_at(const Env& e, long long i) {
  const float4 r = reinterpret_cast<const float4*>(e.rgbl)[i];
  return v3(r.x, r.y, r.z);
}

// _bilinear at equal-area coords (u, v)
__device__ __forceinline__ V3 env_bilinear(const Env& e, float u, float v) {
  const int S = e.size;
  const float x = u * (float)S - 0.5f;
  const float y = v * (float)S - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long xi0 = min(max((long long)x0, 0LL), (long long)(S - 1));
  const long long xi1 = min(max(xi0 + 1, 0LL), (long long)(S - 1));
  const long long yi0 = min(max((long long)y0, 0LL), (long long)(S - 1));
  const long long yi1 = min(max(yi0 + 1, 0LL), (long long)(S - 1));
  const float w0 = (1.0f - fx) * (1.0f - fy), w1 = fx * (1.0f - fy);
  const float w2 = (1.0f - fx) * fy, w3 = fx * fy;
  V3 out = v3(0.0f, 0.0f, 0.0f) + rgb_at(e, xi0 * S + yi0) * w0;
  out = out + rgb_at(e, xi1 * S + yi0) * w1;
  out = out + rgb_at(e, xi0 * S + yi1) * w2;
  return out + rgb_at(e, xi1 * S + yi1) * w3;
}

// ---- the material atlas (scene/textures.py)

struct Plane {
  const __nv_bfloat16* data;  // [rows, 8]
  long long width, rows;
};

struct Scene {
  const float* tri_shade;  // [T, 48]
  long long num_tris;
  const float* inst_tf;  // [I, 13]; two-level scenes
  const float* inst_inv;  // [I, 12]
  long long num_inst;
  Plane bsdf, emissive;
  int bsdf_constant, emissive_constant, normals_flat;
  int mesh_samples;
  float inv_weight_sum;  // 1 / float32(max(weight_sum, 1e-20))
};

// sample_material_block: the 4-tap repeat-wrap fetch of a block's 8
// channels (first `ch` of them)
template <int ch>
__device__ __forceinline__ void material_block(const Plane& p, const float* rect,
                                               float u_in, float v_in,
                                               float* out) {
  const long long x0 = (long long)rect[0];
  const long long y0 = (long long)rect[1];
  const float tw = rect[2], th = rect[3];
  const float u = u_in * tw - 0.5f;
  const float v = v_in * th - 0.5f;
  const float iu = floorf(u), iv = floorf(v);
  const float fu1 = u - iu, fv1 = v - iv;
  const int twi = (int)tw, thi = (int)th;
  int iu0 = (int)iu % twi;
  if (iu0 != 0 && ((iu0 < 0) != (twi < 0))) iu0 += twi;
  int iv0 = (int)iv % thi;
  if (iv0 != 0 && ((iv0 < 0) != (thi < 0))) iv0 += thi;
  const long long base = (y0 + iv0) * p.width + (x0 + iu0);
  const float w[4] = {(1.0f - fu1) * (1.0f - fv1), fu1 * (1.0f - fv1),
                      (1.0f - fu1) * fv1, fu1 * fv1};
  const long long shift[4] = {0, 1, p.width, p.width + 1};
#pragma unroll
  for (int c = 0; c < ch; ++c) out[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long r = base + shift[k];
    r = r < 0 ? 0 : (r >= p.rows ? p.rows - 1 : r);  // memory safety only
    const __nv_bfloat16* texel = p.data + 8 * r;
#pragma unroll
    for (int c = 0; c < ch; ++c)
      out[c] = out[c] + w[k] * __bfloat162float(texel[c]);
  }
}

// _inst_world's einsum row: sum_j m(i, j) * c[j], an fma chain from 0
__device__ __forceinline__ float fma_row(float m0, float m1, float m2, V3 c) {
  return __fmaf_rn(m2, c.z, __fmaf_rn(m1, c.y, __fmaf_rn(m0, c.x, 0.0f)));
}

__device__ __forceinline__ V3 interp(float u, float v, V3 a, V3 b, V3 c) {
  const float b0 = (1.0f - u) - v;
  return (a * b0 + b * u) + c * v;
}

// sample_envmap (lights/envmap.py:120-138): the alias draw, the texel
// row, the equal-area forward map and the pdf
__device__ __forceinline__ void env_sample(const Env& e, float r0, float r1,
                                           V3* dir, V3* rad, float* pdf) {
  if (e.size == 1) {
    *dir = equal_area_sphere(r0, r1);
    *rad = rgb_at(e, 0);
    *pdf = kUniformPdf;
    return;
  }
  const long long S = e.size, count = S * S;
  // alias_table.sample
  const float scaled = r0 * (float)count;
  long long idx = (long long)scaled;
  idx = idx > count - 1 ? count - 1 : idx;
  const float rr = scaled - floorf(scaled);
  float ru;
  const long long texel = coin_flip(e.select[idx], rr, &ru) ? idx
                                                             : e.alias[idx];
  const long long ix = texel / S;
  const long long iy = texel - ix * S;
  const float4 row = reinterpret_cast<const float4*>(e.rgbl)[texel];
  const float discrete_pdf = (row.w * (float)count) * e.inv_integral;
  const float inv_s = 1.0f / (float)S;
  *dir = equal_area_sphere(((float)ix + ru) * inv_s, ((float)iy + r1) * inv_s);
  *rad = v3(row.x, row.y, row.z);
  *pdf = discrete_pdf * kInv4PiDiv;
}

struct Emitters {  // the packed emitter rows and their alias table
  const float* rows;  // [R, 25]
  long long num_rows;
  const float* select;  // [count]
  const long long* alias;
  int count;  // max(emitters, 1)
  int empty;  // no emitter: every sample's pdf is 0
};

// sample_mesh_lights (lights/mesh_lights.py) with _emissive_at: the
// alias pick, the emitter row, the barycentrics, the light point and
// normal, the direction, the solid-angle pdf and the emission
__device__ __forceinline__ void mesh_sample(const Scene& sc, const Emitters& em,
                                            V3 position, float r0, float r1,
                                            V3* dir, V3* l_pos, V3* l_n,
                                            V3* rad, float* pdf) {
  const float scaled = r0 * (float)em.count;
  long long idx = (long long)scaled;
  idx = idx > em.count - 1 ? em.count - 1 : idx;
  const float rr = scaled - floorf(scaled);
  float rx;
  long long slot = coin_flip(em.select[idx], rr, &rx) ? idx : em.alias[idx];
  slot = slot < 0 ? 0 : (slot > em.num_rows - 1 ? em.num_rows - 1 : slot);
  const float* row = em.rows + 25 * slot;
  // square_to_triangle
  const float s = sqrtf(cmin(1.0f - rx, 0.0f));
  const float ba = 1.0f - s, bb = r1 * s;
  const V3 c0 = v3(row[0], row[1], row[2]);
  const V3 c1 = v3(row[3], row[4], row[5]);
  const V3 c2 = v3(row[6], row[7], row[8]);
  const float b0 = (1.0f - ba) - bb;
  *l_pos = (c0 * b0 + c1 * ba) + c2 * bb;
  *l_n = safe_normalize(cross(c0 - c2, c1 - c2));
  *dir = safe_normalize(*l_pos - position);
  // area_to_solid_angle(l_pos, position, dir, l_n) / max(weight_sum, 1e-20)
  const V3 diff = *l_pos - position;
  const float r2 = dot(diff, diff);
  const float light_cos = dot(-*dir, *l_n);
  const float a2s = light_cos > 0.0f ? r2 / cmin(light_cos, 1e-20f) : 0.0f;
  *pdf = em.empty ? 0.0f : a2s * sc.inv_weight_sum;
  if (sc.emissive_constant) {
    *rad = v3(row[15], row[16], row[17]);
  } else {  // the emissive atlas at the sample's uv
    const float uv_u = (row[9] * b0 + row[11] * ba) + row[13] * bb;
    const float uv_v = (row[10] * b0 + row[12] * ba) + row[14] * bb;
    float e[3];
    material_block<3>(sc.emissive, row + 18, uv_u, uv_v, e);
    *rad = v3(e[0], e[1], e[2]);
  }
}

struct Lanes {  // the surface kernel's per-lane inputs
  const int* tri;
  const float *u, *v;
  const int* inst;
  const float *o, *d;
  bool* active;  // in place: the thin form clears it, the full form's draw
                 // applies the cut and the roulette
  float* throughput;  // in place: the roulette's scale
  float* radiance;  // in place: the emission added
  const float* last_pdf;
  const bool* last_delta;
  const long long* bounce;
};

struct SurfaceOut {  // the decoded hit, on the lanes live at the hit
  float *position, *tri_n, *fn, *fs, *ft, *w_o_ss;
  int* type;
  float *color, *metal, *alpha, *ior;
};

struct Draw {  // the light draw of the full and direct forms
  int env_samples, mesh_samples;
  long long max_bounces;  // the full form's cut and roulette
  int roulette;  // bounce > 3, decided on the host
  long long* rng;  // in place
  Env env;
  Emitters em;
  // the light samples [S, n] in draw order (env samples first) and their
  // shadow rays [S * n], written where the ray is traced (lane)
  float *dir, *rad, *pdf;
  float *sh_o, *sh_d, *sh_t;
  bool* sh_lane;  // every lane
  long long* rays;  // the shadow rays traced are added here (or null)
};

// Adds the warp's values of v into *total: a warp sum, then one atomic a
// warp where the sum is not 0 (every thread of the warp calls it; no
// barrier, so a warp leaves as soon as its own lanes are done). Integer
// adds: the total does not depend on the order.
__device__ __forceinline__ void count_into(long long* total, int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(total),
              (unsigned long long)v);
}

// The PCG state k draws on (next_float's state update alone)
__device__ __forceinline__ unsigned skip_floats(unsigned state, int k) {
  for (int j = 0; j < k; ++j) state = state * 747796405u + 2891336453u;
  return state;
}

// The surface kernel's lane i: decode the hit, pick the shading frame and
// add the emission (integrator.hlsl:93-124); in the full form then the
// max-bounce cut, the roulette and every NEE light sample with its shadow
// ray (:126-151); in the direct form every light sample with its shadow
// ray as the direct integrator draws it (:199-247). A lane dead at the hit
// only clears its shadow lanes; in the direct form it also advances its
// PCG state past the draws, as the reference advances every lane's.
// Returns the shadow rays it sets.
template <int kMode, bool kTwoLevel>
__device__ __forceinline__ int surface_lane(const Scene& sc, const Lanes& in,
                                            const SurfaceOut& out,
                                            const Draw& dr, long long n,
                                            long long i) {
  const int n_samples = kMode == kThin ? 0 : dr.env_samples + dr.mesh_samples;
  if (!in.active[i]) {
    for (int k = 0; k < n_samples; ++k) dr.sh_lane[k * n + i] = false;
    if (kMode == kDirect && n_samples > 0)
      dr.rng[i] = (long long)skip_floats((unsigned)dr.rng[i], 2 * n_samples);
    return 0;
  }
  long long tri = in.tri[i];
  tri = tri < 0 ? 0 : (tri > sc.num_tris - 1 ? sc.num_tris - 1 : tri);
  const float* row = sc.tri_shade + 48 * tri;
  const float bu = in.u[i], bv = in.v[i];
  V3 c[3], nr[3];
  float uvs[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = v3(row[3 * k], row[3 * k + 1], row[3 * k + 2]);
    if (kMode != kThin) nr[k] = v3(row[9 + 3 * k], row[10 + 3 * k],
                                   row[11 + 3 * k]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) uvs[k] = row[18 + k];
  const bool sampled = row[25] > 0.5f;
  float mrow[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the material row: 16-byte aligned
    const float4 q = reinterpret_cast<const float4*>(row + 32)[k];
    mrow[4 * k] = q.x;
    mrow[4 * k + 1] = q.y;
    mrow[4 * k + 2] = q.z;
    mrow[4 * k + 3] = q.w;
  }

  float det_sign = 1.0f;
  if (kTwoLevel) {  // _inst_world
    long long k = in.inst[i];
    k = k < 0 ? 0 : (k > sc.num_inst - 1 ? sc.num_inst - 1 : k);
    const float* tf = sc.inst_tf + 13 * k;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V3 p = c[j];
      c[j] = v3(fma_row(tf[0], tf[1], tf[2], p) + tf[9],
                fma_row(tf[3], tf[4], tf[5], p) + tf[10],
                fma_row(tf[6], tf[7], tf[8], p) + tf[11]);
    }
    if (kMode != kThin) {
      const float* m = sc.inst_inv + 12 * k;  // used transposed
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const V3 q = nr[j];
        nr[j] = safe_normalize(v3(fma_row(m[0], m[3], m[6], q),
                                  fma_row(m[1], m[4], m[7], q),
                                  fma_row(m[2], m[5], m[8], q)));
      }
    }
    det_sign = tf[12];
  }

  const V3 position = interp(bu, bv, c[0], c[1], c[2]);
  const float b0 = (1.0f - bu) - bv;
  const float uv_u = (uvs[0] * b0 + uvs[2] * bu) + uvs[4] * bv;
  const float uv_v = (uvs[1] * b0 + uvs[3] * bu) + uvs[5] * bv;
  V3 tri_n = safe_normalize(cross(c[0] - c[2], c[1] - c[2]));
  if (kTwoLevel) tri_n = tri_n * det_sign;

  // _decode_emissive
  V3 emissive;
  if (sc.emissive_constant) {
    emissive = v3(mrow[7], mrow[8], mrow[9]);
  } else {
    float e[3];
    material_block<3>(sc.emissive, mrow + 12, uv_u, uv_v, e);
    emissive = v3(e[0], e[1], e[2]);
  }
  const V3 w_o = -load3(in.d, i);
  V3 rad = load3(in.radiance, i);

  int type = 0;
  if (kMode != kThin) {
    // _tangent_bitangent
    const float dt02u = uvs[0] - uvs[4], dt02v = uvs[1] - uvs[5];
    const float dt12u = uvs[2] - uvs[4], dt12v = uvs[3] - uvs[5];
    const V3 dp02 = c[0] - c[2], dp12 = c[1] - c[2];
    const float det = dt02u * dt12v - dt02v * dt12u;
    const bool bad = fabsf(det) < 1e-12f;
    // the bitangent is left out: reorthogonalize rebuilds t from n and s
    V3 tangent;
    if (bad) {
      V3 unused;
      from_normal(safe_normalize(cross(c[2] - c[0], c[1] - c[0])), &tangent,
                  &unused);
    } else {
      const float inv = (1.0f / det) * 1.0f;
      tangent = safe_normalize((dp02 * dt12v - dp12 * dt02v) * inv);
    }
    const Frame tri_f = reorthogonalize(tri_n, tangent);
    const V3 vtx_n = safe_normalize(interp(bu, bv, nr[0], nr[1], nr[2]));
    const Frame vtx_f = reorthogonalize(vtx_n, tri_f.s);

    // _decode_material
    V3 color;
    float metal, rough, nrg0, nrg1;
    if (sc.bsdf_constant) {
      color = v3(mrow[1], mrow[2], mrow[3]);
      metal = mrow[4];
      rough = mrow[6];
      nrg0 = mrow[10];
      nrg1 = mrow[11];
    } else {
      float blk[7];
      material_block<7>(sc.bsdf, mrow + 1, uv_u, uv_v, blk);
      color = v3(blk[0], blk[1], blk[2]);
      metal = blk[3];
      rough = blk[4];
      nrg0 = blk[5];
      nrg1 = blk[6];
    }
    type = (int)mrow[0];
    const float alpha = cmin(rough * rough, 1e-3f);

    // the shading-normal selection (integrator.hlsl:93-104)
    Frame tex_f = vtx_f;
    const bool textured = kMode == kDirect || !sc.normals_flat;
    if (textured) {  // _texture_frame
      const float rg0 = nrg0 * 2.0f - 1.0f, rg1 = nrg1 * 2.0f - 1.0f;
      const float z =
          sqrtf(cclamp(1.0f - ((rg0 * rg0 + rg1 * rg1) + 0.0f), 0.0f, 1.0f));
      const V3 n_ws = normalize(to_world(vtx_f, v3(rg0, rg1, z)));
      tex_f = reorthogonalize(n_ws, vtx_f.s);
    }
    float sgn = 1.0f;
    if (kMode != kDirect) sgn = dot(tri_f.n, w_o) > 0.0f ? 1.0f : -1.0f;
    const bool vtx_ok = sgn * dot(w_o, vtx_f.n) > 0.0f;
    const bool tex_ok = textured && sgn * dot(w_o, tex_f.n) > 0.0f;
    const Frame frame = tex_ok ? tex_f : (vtx_ok ? vtx_f : tri_f);
    store3(out.position, i, position);
    store3(out.tri_n, i, tri_n);
    store3(out.fn, i, frame.n);
    store3(out.fs, i, frame.s);
    store3(out.ft, i, frame.t);
    store3(out.w_o_ss, i, to_frame(frame, w_o));
    out.type[i] = type;
    store3(out.color, i, color);
    out.metal[i] = metal;
    out.alpha[i] = alpha;
    out.ior[i] = mrow[5];
  }

  unsigned state;
  if (kMode == kDirect) {
    store3(in.radiance, i, rad + emissive);
    state = (unsigned)dr.rng[i];
  } else {
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    // the emissive term (integrator.hlsl:109-124)
    V3 thr = load3(in.throughput, i);
    const long long bounce = *in.bounce;
    const bool emit_plain =
        !sampled || in.last_delta[i] || bounce == 0 || sc.mesh_samples == 0;
    const bool emit_front = dot(w_o, tri_n) > 0.0f;
    rad = rad + (emit_plain && emit_front ? thr * emissive : zero);
    if (sc.mesh_samples > 0) {
      // area_to_solid_angle(position, o, d, tri_n) / max(weight_sum, 1e-20)
      const V3 diff = position - load3(in.o, i);
      const float r2 = dot(diff, diff);
      const float light_cos = dot(w_o, tri_n);
      const float a2s =
          light_cos > 0.0f ? r2 / cmin(light_cos, 1e-20f) : 0.0f;
      const float light_pdf = a2s * sc.inv_weight_sum;
      const float w = power2(in.last_pdf[i] * 1.0f,
                             light_pdf * (float)sc.mesh_samples);
      rad = rad + (!emit_plain && light_pdf > 0.0f ? (thr * emissive) * w
                                                   : zero);
    }
    store3(in.radiance, i, rad);
    if (kMode == kThin) {  // the max-bounce cut kills every lane here
      in.active[i] = false;
      return 0;
    }

    // the termination (integrator.hlsl:126-135)
    bool alive = bounce < dr.max_bounces + 1;
    state = (unsigned)dr.rng[i];
    const float rr = next_float(&state);
    if (dr.roulette) {
      // luminance, then clamp_max(., 0.95): NaN passes
      const float lum = (0.2126f * thr.x + 0.7152f * thr.y) + 0.0722f * thr.z;
      const float p = isnan(lum) ? lum : fminf(lum, 0.95f);
      alive = alive && !(rr > p);
      if (alive) {
        thr = thr / cmin(p, 1e-20f);
        store3(in.throughput, i, thr);
      }
    }
    if (!alive) {
      in.active[i] = false;
      for (int k = 0; k < n_samples; ++k) dr.sh_lane[k * n + i] = false;
      return 0;
    }
  }

  // the NEE draws (integrator.hlsl:139-151): env samples, then mesh ones;
  // the direct integrator draws them on delta materials too
  const bool nee = kMode == kDirect || !(type == kMirror || type == kGlass);
  int traced = 0;
  for (int k = 0; k < n_samples; ++k) {
    const float r0 = next_float(&state);
    const float r1 = next_float(&state);
    const long long j = k * n + i;
    if (!nee) {
      dr.sh_lane[j] = false;
      continue;
    }
    V3 l_dir, l_rad, s_o, s_d;
    float l_pdf, s_t;
    if (k < dr.env_samples) {
      env_sample(dr.env, r0, r1, &l_dir, &l_rad, &l_pdf);
      s_o = offset_along_normal(position, face_forward(tri_n, l_dir));
      s_d = l_dir;
      s_t = 1.0e12f;  // INF_T
    } else {
      V3 l_pos, l_n;
      mesh_sample(sc, dr.em, position, r0, r1, &l_dir, &l_pos, &l_n, &l_rad,
                  &l_pdf);
      const V3 off_light = offset_along_normal(l_pos, l_n);
      s_o = offset_along_normal(position, face_forward(tri_n, l_dir));
      if (kMode == kDirect) {  // one-ended: along l_dir from the hit
        s_d = l_dir;
        s_t = norm(off_light - position);
      } else {  // the two-ended shadow segment (light.hlsl:149-154)
        const V3 seg = off_light - s_o;
        s_t = norm(seg);
        s_d = seg / cmin(s_t, 1e-20f);
      }
    }
    const bool lane = l_pdf > 0.0f;
    dr.sh_lane[j] = lane;
    if (!lane) continue;
    ++traced;
    store3(dr.dir, j, l_dir);
    store3(dr.rad, j, l_rad);
    dr.pdf[j] = l_pdf;
    store3(dr.sh_o, j, s_o);
    store3(dr.sh_d, j, s_d);
    dr.sh_t[j] = s_t;
  }
  dr.rng[i] = (long long)state;
  return traced;
}

// The surface kernel, one thread a lane (surface_lane); the full and
// direct forms add the shadow rays their lanes set into *dr.rays where that
// is given.
template <int kMode, bool kTwoLevel>
__global__ void __launch_bounds__(kBlock)
    surface_kernel(Scene sc, Lanes in, SurfaceOut out, Draw dr, long long n) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int traced =
      i < n ? surface_lane<kMode, kTwoLevel>(sc, in, out, dr, n, i) : 0;
  if (kMode != kThin && dr.rays != nullptr) count_into(dr.rays, traced);
}

struct Lights {  // a bounce's NEE samples [S, n] and their shadow answers
  const float *dir, *rad, *pdf;
  const bool *lane, *occluded;
  int env_samples, mesh_samples;
};

struct ScatterIn {
  const int* type;
  const float *color, *metal, *alpha, *ior;
  const float *fn, *fs, *ft, *w_o_ss, *position, *tri_n;
  const bool* active;  // the lanes live after the cut and the roulette
};

struct State {  // the lane state, updated in place (the weight-only form:
                // its radiance alone)
  bool* active;
  float *o, *d, *throughput, *radiance, *last_pdf;
  bool* last_delta;
  long long* rng;
  long long* live;  // the lanes left live are added here (or null)
};

// The scatter kernel's lane i: weight each traced, unoccluded light sample
// by the power heuristic and add it (integrator.hlsl:139-151), then draw
// the BSDF sample and continue the path (:153-163). A lane dead before it
// writes its mask alone; a lane whose path ends writes no ray or
// throughput. Returns whether the lane is left live. The weight-only form
// (kWeigh, the direct integrator's, :199-247) adds the weighted samples
// at unit throughput (x * 1 is x: the throughput is not read) and writes
// the radiance alone; a lane dead before it writes nothing.
template <bool kWeigh>
__device__ __forceinline__ bool scatter_lane(const ScatterIn& in,
                                             const Lights& L,
                                             const State& st, long long n,
                                             long long i) {
  if (!in.active[i]) {
    if (!kWeigh) st.active[i] = false;
    return false;
  }
  Mat m;
  m.type = in.type[i];
  m.color = load3(in.color, i);
  m.metal = in.metal[i];
  m.alpha = in.alpha[i];
  m.ior = in.ior[i];
  const Frame f{load3(in.fn, i), load3(in.fs, i), load3(in.ft, i)};
  const V3 wo = load3(in.w_o_ss, i);
  const V3 thr = kWeigh ? v3(1.0f, 1.0f, 1.0f) : load3(st.throughput, i);
  V3 rad = load3(st.radiance, i);
  const V3 zero = v3(0.0f, 0.0f, 0.0f);

  const int count = L.env_samples + L.mesh_samples;
  for (int k = 0; k < count; ++k) {
    const long long j = k * n + i;
    // a sample neither traced nor seen adds a zero (ok is false)
    bool ok = L.lane[j] && !L.occluded[j];
    const float l_pdf = ok ? L.pdf[j] : 0.0f;
    ok = ok && l_pdf > 0.0f;
    V3 add = zero;
    if (ok) {
      const float n_k = (float)(k < L.env_samples ? L.env_samples
                                                  : L.mesh_samples);
      const V3 wi = to_frame(f, load3(L.dir, j));
      float scatter_pdf;
      const V3 brdf = eval_pdf_bsdf(m, wi, wo, &scatter_pdf);
      const float mis = power2(l_pdf * n_k, scatter_pdf * 1.0f);
      const V3 contrib = (load3(L.rad, j) * brdf) *
                         (fabsf(wi.z) * mis / cmin(l_pdf, 1e-30f));
      // x / n_samples: x * float32(1 / n_samples)
      if (scatter_pdf > 0.0f)
        add = (kWeigh ? contrib : thr * contrib) * (1.0f / n_k);
    }
    rad = rad + add;
  }
  if (kWeigh) {
    store3(st.radiance, i, rad);
    return false;
  }

  // the scatter (integrator.hlsl:153-163)
  unsigned state = (unsigned)st.rng[i];
  const float sx = next_float(&state);
  const float sy = next_float(&state);
  float pdf;
  const V3 wi = sample_bsdf(m, wo, sx, sy, &pdf);
  const bool go_on = pdf > 0.0f;
  if (go_on) {
    const V3 new_d = normalize(to_world(f, wi));
    const V3 new_o = offset_along_normal(load3(in.position, i),
                                         face_forward(load3(in.tri_n, i),
                                                      new_d));
    const V3 fv = eval_bsdf(m, wi, wo);
    const V3 thr_mul = fv * (fabsf(wi.z) / cmin(pdf, 1e-30f));
    store3(st.o, i, new_o);
    store3(st.d, i, new_d);
    store3(st.throughput, i, thr * thr_mul);
  }
  st.active[i] = go_on;
  store3(st.radiance, i, rad);
  st.last_pdf[i] = pdf;
  st.last_delta[i] = m.type == kMirror || m.type == kGlass;
  st.rng[i] = (long long)state;
  return go_on;
}

// The scatter kernel, one thread a lane (scatter_lane); the path's form
// adds the lanes it leaves live into *st.live where that is given.
template <bool kWeigh>
__global__ void __launch_bounds__(kBlock)
    scatter_kernel(ScatterIn in, Lights L, State st, long long n) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n && scatter_lane<kWeigh>(in, L, st, n, i);
  if (!kWeigh && st.live != nullptr) count_into(st.live, live ? 1 : 0);
}

struct MissIn {
  const float* d;
  const int* tri;
  const float *throughput, *last_pdf;
  const bool* last_delta;
  const long long* bounce;
};

// The miss, in place on the lane state: a dead lane reads its mask and
// leaves, a live lane that hit reads its tri and leaves (its mask stays
// set); a lane that missed adds the environment's radiance (plain, or
// MIS-weighted against the env draw) into its radiance and clears its
// mask, the reference's `active = active & hit.is_hit`. A lane that did
// not miss writes nothing.
__global__ void __launch_bounds__(kBlock)
    env_miss_kernel(Env e, int env_samples, MissIn in, bool* active,
                    float* radiance, long long n) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n || !active[i] || in.tri[i] >= 0) return;
  const V3 d = load3(in.d, i);
  const bool env_plain =
      in.last_delta[i] || *in.bounce == 0 || env_samples == 0;
  const V3 thr = load3(in.throughput, i);
  V3 rad = load3(radiance, i);
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 env_rad;
  if (e.size == 1) {
    env_rad = rgb_at(e, 0);
  } else {
    float u, v;
    equal_area_sphere_inverse(d, &u, &v);
    env_rad = env_bilinear(e, u, v);
    if (env_samples > 0) {  // miss_radiance_and_pdf's texel and pdf
      const long long S = e.size;
      const long long ix = min(max((long long)(u * (float)S), 0LL), S - 1);
      const long long iy = min(max((long long)(v * (float)S), 0LL), S - 1);
      const float4 tx = reinterpret_cast<const float4*>(e.rgbl)[ix * S + iy];
      const float pdf_e =
          ((tx.w * (float)(S * S)) * e.inv_integral) * kInv4PiDiv;
      const float w = power2(in.last_pdf[i] * 1.0f, pdf_e * (float)env_samples);
      rad = rad + (!env_plain && pdf_e > 0.0f
                       ? (thr * v3(tx.x, tx.y, tx.z)) * w
                       : zero);
    }
  }
  if (e.size == 1 && env_samples > 0) {
    const float w = power2(in.last_pdf[i] * 1.0f,
                           kUniformPdf * (float)env_samples);
    rad = rad + (!env_plain && kUniformPdf > 0.0f ? (thr * env_rad) * w
                                                  : zero);
  }
  store3(radiance, i, rad + (env_plain ? thr * env_rad : zero));
  active[i] = false;
}

unsigned blocks(long long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

Env env_of(const float* rgbl, const float* select, const long long* alias,
           int size, float inv_integral) {
  return Env{rgbl, select, alias, size, inv_integral};
}

}  // namespace

extern "C" {

// The surface kernel. mode: 0 full, 1 thin (last segment), 2 direct;
// two_level: the hits carry instances (inst, inst_tf, inst_inv). Scene:
// tri_shade float32 [T, 48] (16-byte aligned); inst_tf [I, 13]; inst_inv
// [I, 12]; the two atlas planes bf16 [rows, 8] with their row stride;
// flags; the mesh-light sample count and 1 / max(weight_sum, 1e-20) in
// float32. Lanes: hit tri int32, u, v, inst int32; o, d [n, 3]; active
// bool; throughput, radiance [n, 3]; last_pdf; last_delta bool; bounce an
// int64 device scalar (the direct form reads none of o, throughput,
// last_pdf, last_delta, bounce). In place, on the lanes active at the
// hit: radiance (the emission added), active (the thin form clears it;
// the full form's cut and roulette), throughput (the roulette). Outputs
// as SurfaceOut, on the same lanes (none in the thin form). The draw (the
// full and direct forms'; the thin form ignores its arguments, the direct
// form max_bounces and roulette): env and mesh sample counts,
// max_bounces, roulette, rng int64 [n] (in place; the direct form
// advances every lane's); the env map (rgbl float32 [S*S, 4], 16-byte
// aligned, select, alias int64, S, 1 / max(integral, 1e-30)); the
// emitters (rows float32 [R, 25], select, alias int64, max(count, 1),
// whether there are none); outputs: the samples' dir, radiance [S, n, 3]
// and pdf [S, n], the shadow rays' origin, direction [S * n, 3] and t_max
// (written where the ray is traced), and their lanes bool [S * n]; rays an
// int64 device scalar the shadow rays set are added to (null: not
// counted).
int msn_shade_surface(int mode, int two_level, const float* tri_shade,
                      long long num_tris, const float* inst_tf,
                      const float* inst_inv, long long num_inst,
                      const void* bsdf_plane, long long bsdf_width,
                      long long bsdf_rows, const void* em_plane,
                      long long em_width, long long em_rows, int bsdf_constant,
                      int emissive_constant, int normals_flat,
                      int mesh_samples, float inv_weight_sum, const int* tri,
                      const float* u, const float* v, const int* inst,
                      const float* o, const float* d, bool* active,
                      float* throughput, float* radiance,
                      const float* last_pdf, const bool* last_delta,
                      const long long* bounce, long long n, float* position,
                      float* tri_n, float* fn, float* fs, float* ft,
                      float* w_o_ss, int* type, float* color, float* metal,
                      float* alpha, float* ior, int env_samples,
                      long long max_bounces, int roulette, long long* rng,
                      const float* env_rgbl, const float* env_select,
                      const long long* env_alias, int env_size,
                      float env_inv_integral, const float* emitter_rows,
                      long long emitter_rows_n, const float* emitter_select,
                      const long long* emitter_alias, int emitter_count,
                      int emitters_empty, float* l_dir, float* l_rad,
                      float* l_pdf, float* sh_o, float* sh_d, float* sh_t,
                      bool* sh_lane, long long* rays, void* stream) {
  if (n <= 0) return 0;
  Scene sc{tri_shade,
           num_tris,
           inst_tf,
           inst_inv,
           num_inst,
           Plane{static_cast<const __nv_bfloat16*>(bsdf_plane), bsdf_width,
                 bsdf_rows},
           Plane{static_cast<const __nv_bfloat16*>(em_plane), em_width,
                 em_rows},
           bsdf_constant,
           emissive_constant,
           normals_flat,
           mesh_samples,
           inv_weight_sum};
  Lanes in{tri, u, v, inst, o, d, active, throughput, radiance, last_pdf,
           last_delta, bounce};
  SurfaceOut out{position, tri_n, fn, fs, ft, w_o_ss, type, color, metal,
                 alpha, ior};
  Draw dr{};
  if (mode != kThin) {
    dr.env_samples = env_samples;
    dr.mesh_samples = mesh_samples;
    dr.max_bounces = max_bounces;
    dr.roulette = roulette;
    dr.rng = rng;
    dr.env = env_of(env_rgbl, env_select, env_alias, env_size,
                    env_inv_integral);
    dr.em = Emitters{emitter_rows, emitter_rows_n, emitter_select,
                     emitter_alias, emitter_count, emitters_empty};
    dr.dir = l_dir;
    dr.rad = l_rad;
    dr.pdf = l_pdf;
    dr.sh_o = sh_o;
    dr.sh_d = sh_d;
    dr.sh_t = sh_t;
    dr.sh_lane = sh_lane;
    dr.rays = rays;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks(n);
#define MSN_SURFACE(M, T) \
  surface_kernel<M, T><<<g, kBlock, 0, s>>>(sc, in, out, dr, n)
  if (two_level) {
    if (mode == kFull) MSN_SURFACE(kFull, true);
    else if (mode == kThin) MSN_SURFACE(kThin, true);
    else MSN_SURFACE(kDirect, true);
  } else {
    if (mode == kFull) MSN_SURFACE(kFull, false);
    else if (mode == kThin) MSN_SURFACE(kThin, false);
    else MSN_SURFACE(kDirect, false);
  }
#undef MSN_SURFACE
  return (int)cudaGetLastError();
}

// The scatter kernel. Lanes: the material (type int32, color [n, 3],
// metalness, alpha, ior), the shading frame's n, s, t and w_o_ss [n, 3],
// position and tri_n [n, 3], active bool (the lanes live after the cut
// and the roulette). The light samples: dir, radiance [S, n, 3], pdf [S,
// n], lane and occluded bool [S, n], S = env_samples + mesh_samples (env
// ones first; each weighed by its kind's count). The lane state, in
// place: active bool, o, d, throughput, radiance [n, 3], last_pdf,
// last_delta bool, rng int64 (a lane dead before the launch writes its
// active alone; a lane whose path ends writes no o, d or throughput); live
// an int64 device scalar the lanes left live are added to (null: not
// counted).
int msn_shade_scatter(const int* type, const float* color, const float* metal,
                      const float* alpha, const float* ior, const float* fn,
                      const float* fs, const float* ft, const float* w_o_ss,
                      const float* position, const float* tri_n,
                      const bool* active, const float* l_dir,
                      const float* l_rad, const float* l_pdf,
                      const bool* lane, const bool* occluded, int env_samples,
                      int mesh_samples, long long n, bool* st_active,
                      float* o, float* d, float* throughput, float* radiance,
                      float* last_pdf, bool* last_delta, long long* rng,
                      long long* live, void* stream) {
  if (env_samples < 0 || mesh_samples < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  ScatterIn in{type, color, metal, alpha, ior, fn, fs, ft, w_o_ss,
               position, tri_n, active};
  Lights L{l_dir, l_rad, l_pdf, lane, occluded, env_samples, mesh_samples};
  State st{st_active, o, d, throughput, radiance, last_pdf, last_delta, rng,
           live};
  scatter_kernel<false>
      <<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(in, L, st,
                                                                     n);
  return (int)cudaGetLastError();
}

// The scatter kernel's weight-only form (the direct integrator's): the
// material, frame and active as the scatter takes them, the light samples
// likewise; radiance [n, 3] in place, written on the lanes active on entry
// (the weighted samples added at unit throughput) and nowhere else.
int msn_shade_weigh(const int* type, const float* color, const float* metal,
                    const float* alpha, const float* ior, const float* fn,
                    const float* fs, const float* ft, const float* w_o_ss,
                    const bool* active, const float* l_dir,
                    const float* l_rad, const float* l_pdf, const bool* lane,
                    const bool* occluded, int env_samples, int mesh_samples,
                    long long n, float* radiance, void* stream) {
  if (env_samples < 0 || mesh_samples < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  ScatterIn in{type, color, metal, alpha, ior, fn, fs, ft, w_o_ss,
               nullptr, nullptr, active};
  Lights L{l_dir, l_rad, l_pdf, lane, occluded, env_samples, mesh_samples};
  State st{};
  st.radiance = radiance;
  scatter_kernel<true>
      <<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(in, L, st,
                                                                     n);
  return (int)cudaGetLastError();
}

// The miss, in place: env rgbl float32 [S*S, 4] (16-byte aligned), S,
// 1 / max(integral, 1e-30) in float32, the env sample count; lanes d
// [n, 3], hit tri int32, throughput [n, 3], last_pdf, last_delta bool,
// bounce an int64 device scalar; the state's active bool [n] and
// radiance [n, 3], which a lane that missed (live, tri < 0) updates (its
// env radiance added, its mask cleared) and no other lane writes.
int msn_shade_env_miss(const float* rgbl, int size, float inv_integral,
                       int env_samples, const float* d, const int* tri,
                       const float* throughput, const float* last_pdf,
                       const bool* last_delta, const long long* bounce,
                       long long n, bool* active, float* radiance,
                       void* stream) {
  if (n <= 0) return 0;
  MissIn in{d, tri, throughput, last_pdf, last_delta, bounce};
  env_miss_kernel<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      env_of(rgbl, nullptr, nullptr, size, inv_integral), env_samples, in,
      active, radiance, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
