// A sample's stages around the bounce loop, for Hopper (sm_90a): the
// camera rays with the fresh lane state, and the sample's accumulation.
//
// Replaces no pallas_call: on the TPU these are jnp, compiled by XLA into
// the sample's one program:
//
//   raygen      moonshine_tpu/render/renderer.py:126-155 _sample_rays /
//               _sample_rays_batched: the PCG seed and two next_float2
//               (core/rng.py:40-68), the Gaussian jitter and uv
//               (render/camera.py:43-53, core/mappings.py:23-46), the thin
//               lens (camera.py:56-82); with integrator/path.py:655-668
//               _init_state, the fresh lane state
//   accumulate  renderer.py:158-166 _staged_accum (the sample-batched sum
//               and the tile un-permute) with path.py:731-735
//               _staged_finish's scatter of the radiance by pix
//
// What bounds them on this card: bytes. raygen reads the lens (a few
// dozen bytes a block) and writes 70 bytes a lane (o, d, the PCG state,
// the mask, throughput, radiance, last_pdf, last_delta, pix); its
// arithmetic (two logf/sinf/cosf pairs, a sqrt, a division) is below the
// card's 20 flops a byte. The plain torch version runs ~150 elementwise
// launches over the lanes, each writing and reading a whole tensor; here
// one thread a lane keeps every intermediate in registers, and thread 0 of
// each block forms the lens constants once into shared memory. accumulate
// reads each lane's radiance (and pix) once and each pixel of acc once,
// and writes acc once. With the lanes moved by the resort its accesses to
// acc are scattered, so they, not the bytes, bound it: acc is held 4
// floats a pixel, so a lane reads and writes its pixel as one 16-byte
// access each (two transactions, where three floats took six). With
// several samples a batch it first scatters the radiance into pixel order
// (one more write and read of it), so that each pixel's sum runs in one
// thread in the batch's order. Its launch also adds the frame's ray and
// segment counts and steps its sample index (thread 0), which were three
// torch launches.
//
// Numerics: each operation is the one the plain torch version runs on the
// card, in its order, built with -fmad=false: a division by a Python
// scalar is a product with the scalar's float32 reciprocal, a 3-sum over
// the last axis ((a0 + a2) + a1) + 0, torch.linalg.cross fma(a_i, b_j,
// -(a_j * b_i)), sqrt, log, sin, cos and tan the CUDA math functions
// torch's kernels call, and the batch's sum left to right. So both equal
// the plain versions bit for bit, which the tests and chip_smoke.py check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTileH = 64, kTileW = 128;  // renderer.TILE_H, TILE_W
// the plain version's Python doubles cast to float32
constexpr float kTwoPi = (float)(2.0 * 3.14159265);
constexpr float kPiOver4 = (float)(3.14159265 / 4.0);
constexpr float kPiOver2 = (float)(3.14159265 / 2.0);

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
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ V3 load3(const float* p) {
  return v3(p[0], p[1], p[2]);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
// mathutil.normalize on the card: v / sqrt(sum(v * v, -1))
__device__ __forceinline__ V3 normalize(V3 v) {
  return v / sqrtf(((v.x * v.x + v.z * v.z) + v.y * v.y) + 0.0f);
}
// torch.linalg.cross on the card
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -(a.z * b.y)),
            __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}

// ---- the PCG stream (core/rng.py), uint32 state held in int64

__device__ __forceinline__ unsigned hash_pcg(unsigned a) {
  a = a * 747796405u + 2891336453u;
  const unsigned b = ((a >> ((a >> 28) + 4u)) ^ a) * 277803737u;
  return (b >> 22) ^ b;
}
__device__ __forceinline__ float next_float(unsigned* state) {
  const unsigned a = *state * 747796405u + 2891336453u;
  *state = a;
  unsigned b = ((a >> ((a >> 28) + 4u)) ^ a) * 277803737u;
  b = (b >> 22) ^ b;
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

// ---- the lens (render/camera.py generate_rays' per-frame constants)

struct LensIn {  // LensArrays on the device
  const float *origin, *forward, *up, *vfov, *aperture, *focus_distance;
};

struct LensConst {
  V3 origin, u_axis, v_axis, horizontal, vertical, lower_left;
  float aperture;
};

__device__ LensConst lens_constants(LensIn in, float aspect) {
  LensConst c;
  c.origin = load3(in.origin);
  const V3 w = -load3(in.forward);
  c.u_axis = normalize(cross(load3(in.up), w));
  c.v_axis = cross(w, c.u_axis);
  const float fd = *in.focus_distance;
  const float h = tanf(*in.vfov * 0.5f);
  const float viewport_h = (h * 2.0f) * fd;
  const float viewport_w = viewport_h * aspect;
  c.horizontal = c.u_axis * viewport_w;
  c.vertical = c.v_axis * viewport_h;
  c.lower_left = ((c.origin - c.horizontal * 0.5f) - c.vertical * 0.5f) -
                 w * fd;
  c.aperture = *in.aperture;
  return c;
}

// ---- raygen

struct Fresh {  // a trace's first set of buffers and its scalars; the
                // state pointers are null where only rays are asked for
  float *o, *d;
  long long* rng;
  bool* active;
  float *throughput, *radiance, *last_pdf;
  bool* last_delta;
  long long* pix;
  long long *rays, *bounce, *widx, *live;
};

struct Shape {
  long long n;     // lanes: nbatch * bh * width
  long long band;  // lanes a sample: bh * width
  int width;       // the frame's
  int y0;          // the band's first row
  int flip;
  float inv_width, inv_height;  // float32(1 / width), float32(1 / height) of
                                // the frame (uv divides by its sizes)
  float aspect;                 // float32(width) / float32(height)
};

// Lane i: sample slot s = i / band, the pixel of lane i - s * band in the
// band's order (renderer._pixel_coords: 64x128 tiles row-major, each tile
// scanline, when the band is a multiple of the tile; else scanline), row
// y0 + py; its PCG stream seeded from (sample + s, px, py).
template <bool kTiled, bool kState>
__global__ void __launch_bounds__(kBlock)
    raygen_kernel(LensIn lens_in, const long long* sample, Shape sh,
                  Fresh out) {
  __shared__ LensConst lens;
  if (threadIdx.x == 0) lens = lens_constants(lens_in, sh.aspect);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (kState && i == 0) {  // _Trace.reset's scalars
    *out.rays = 0;
    *out.bounce = 0;
    out.widx[0] = 2;
    out.widx[1] = 2;
    *out.live = sh.n;
  }
  if (i >= sh.n) return;
  const long long s = i / sh.band;
  const long long q = i - s * sh.band;
  long long px, py;
  if (kTiled) {
    const long long per_tile = (long long)kTileH * kTileW;
    const long long t = q / per_tile, r = q - t * per_tile;
    const long long tiles_x = sh.width / kTileW;
    const long long ty = t / tiles_x;
    px = (t - ty * tiles_x) * kTileW + r % kTileW;
    py = ty * kTileH + r / kTileW;
  } else {
    py = q / sh.width;
    px = q - py * sh.width;
  }
  py += sh.y0;

  // rng.seed, then the jitter's and the aperture's next_float2
  unsigned state = hash_pcg((unsigned)(*sample + s) +
                            hash_pcg((unsigned)px + hash_pcg((unsigned)py)));
  const float j0 = next_float(&state), j1 = next_float(&state);
  const float a0 = next_float(&state), a1 = next_float(&state);

  // pixel_uv with square_to_gaussian
  const float u1 = 1.0f - j0;
  const float r = sqrtf(logf(isnan(u1) ? u1 : fmaxf(u1, 1e-38f)) * -2.0f);
  const float theta = kTwoPi * j1;
  const float cx = r * cosf(theta) * 0.5f + 0.5f;
  const float cy = r * sinf(theta) * 0.5f + 0.5f;
  const float u = ((float)px + cx) * sh.inv_width;
  float v = ((float)py + cy) * sh.inv_height;
  if (sh.flip) v = 1.0f - v;

  // generate_rays with square_to_uniform_disk_concentric
  const float ux = a0 * 2.0f - 1.0f, uy = a1 * 2.0f - 1.0f;
  const bool x_major = fabsf(ux) > fabsf(uy);
  const float tx = kPiOver4 * (uy / (ux == 0.0f ? 1.0f : ux));
  const float ty = kPiOver2 - kPiOver4 * (ux / (uy == 0.0f ? 1.0f : uy));
  const float phi = x_major ? tx : ty;
  const float rr = (ux == 0.0f && uy == 0.0f) ? 0.0f : (x_major ? ux : uy);
  const float rd0 = lens.aperture * (rr * cosf(phi)) * 0.5f;
  const float rd1 = lens.aperture * (rr * sinf(phi)) * 0.5f;
  const V3 defocus = lens.u_axis * rd0 + lens.v_axis * rd1;
  const V3 o = lens.origin + defocus;
  const V3 target = (lens.lower_left + lens.horizontal * u) +
                    lens.vertical * v;
  store3(out.o, i, o);
  store3(out.d, i, normalize((target - defocus) - lens.origin));
  out.rng[i] = (long long)state;
  if (kState) {  // _Trace.reset
    out.active[i] = true;
    store3(out.throughput, i, v3(1.0f, 1.0f, 1.0f));
    store3(out.radiance, i, v3(0.0f, 0.0f, 0.0f));
    out.last_pdf[i] = 1.0f;
    out.last_delta[i] = false;
    out.pix[i] = i;
  }
}

// ---- accumulate

// The frame's int64 device scalars the accumulation adds to (thread 0 of
// the launch; all null where the caller keeps none): rays += trace_rays,
// segments += bounce, sample += nbatch (renderer._Frame's counts)
struct Tally {
  long long* rays;
  const long long* trace_rays;
  long long* segments;
  const long long* bounce;
  long long* sample;
};

// The pixel of pixel lane q (renderer's unpack): its row-major index in
// acc [bh, width, 4]
template <bool kTiled>
__device__ __forceinline__ int pixel_at(int q, int width) {
  if (!kTiled) return q;
  const int t = q / (kTileH * kTileW), r = q % (kTileH * kTileW);
  const int tiles_x = width / kTileW;
  const int ty = t / tiles_x;
  const int x = (t - ty * tiles_x) * kTileW + r % kTileW;
  const int y = ty * kTileH + r / kTileW;
  return y * width + x;
}

// into[pix[j]] = (radiance[j], 0): the radiance in pixel-lane order, a
// 16-byte row a lane
__global__ void __launch_bounds__(kBlock)
    pix_scatter_kernel(const float* radiance, const long long* pix,
                       float4* into, int n) {
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= n) return;
  into[pix[j]] = make_float4(radiance[3 * j], radiance[3 * j + 1],
                             radiance[3 * j + 2], 0.0f);
}

// The accumulation's reads of a lane's pixel lane and radiance row, each
// read once: evict-first (ld.global.cs), so that they pass through the L2
// without evicting acc's sectors, which a random pix reaches twice (two
// pixels a 32-byte sector) at random times
__device__ __forceinline__ long long lane_pix(const long long* pix, int t) {
  return __ldcs(pix + t);
}
__device__ __forceinline__ V3 lane_row(const float* src, int i) {
  const float* p = src + 3 * (long long)i;
  return v3(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2));
}
__device__ __forceinline__ V3 lane_row(const float4* src, int i) {
  const float4 r = __ldcs(src + i);
  return v3(r.x, r.y, r.z);
}

// acc's pixel p += s, its 4th float as it was: one 16-byte load and one
// 16-byte store
__device__ __forceinline__ void add_at(float4* acc, int p, V3 s) {
  float4* a = acc + p;
  float4 v = *a;
  v.x = v.x + s.x;
  v.y = v.y + s.y;
  v.z = v.z + s.z;
  *a = v;
}

// kByPix (one sample a batch, lanes moved): thread j adds lane j's
// radiance at its pixel pix[j]. Else thread q sums pixel lane q over the
// batch's samples, src[q] + src[band + q] + ... left to right, and adds
// the sum at its pixel. Either way one 16-byte load and one 16-byte store
// of acc a lane (its 4th float written back as it was read).
template <bool kTiled, bool kByPix, typename Src>
__global__ void __launch_bounds__(kBlock)
    accumulate_kernel(const Src* src, const long long* pix, int nbatch,
                      int band, int width, float4* acc, Tally tally) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t == 0 && tally.rays != nullptr) {
    *tally.rays += *tally.trace_rays;
    *tally.segments += *tally.bounce;
    *tally.sample += nbatch;
  }
  if (t >= band) return;
  const int q = kByPix ? (int)lane_pix(pix, t) : t;
  V3 s = lane_row(src, t);
  for (int b = 1; b < nbatch; ++b) s = s + lane_row(src, b * band + t);
  add_at(acc, pixel_at<kTiled>(q, width), s);
}

unsigned blocks(long long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

bool tiled(long long bh, int width) {
  return bh % kTileH == 0 && width % kTileW == 0;
}

}  // namespace

extern "C" {

// The camera rays of nbatch samples from *sample (an int64 device scalar)
// of rows [y0, y0 + bh) of a height x width frame, nbatch * bh * width
// lanes sample-major in the band's order; the lens as LensArrays' six
// float32 device tensors (origin, forward, up [3]; vfov, aperture,
// focus_distance scalars), read on the device; aspect float32(width) /
// float32(height). Writes o, d [n, 3] float32 and rng int64 (uint32
// values); with `active` non-null also the fresh state of _Trace.reset:
// active bool, throughput, radiance [n, 3], last_pdf, last_delta bool,
// pix int64, and the int64 scalars rays 0, bounce 0, widx [2] 2, live n.
int msn_frame_raygen(const float* origin, const float* forward,
                     const float* up, const float* vfov,
                     const float* aperture, const float* focus_distance,
                     const long long* sample, int height, int width, int y0,
                     int bh, int nbatch, int flip, float aspect, float* o,
                     float* d, long long* rng, bool* active,
                     float* throughput, float* radiance, float* last_pdf,
                     bool* last_delta, long long* pix, long long* rays,
                     long long* bounce, long long* widx, long long* live,
                     void* stream) {
  if (height <= 0 || width <= 0 || bh <= 0 || nbatch <= 0)
    return (int)cudaErrorInvalidValue;
  const long long band = (long long)bh * width;
  Shape sh{band * nbatch, band, width, y0, flip, 1.0f / (float)width,
           1.0f / (float)height, aspect};
  LensIn lens{origin, forward, up, vfov, aperture, focus_distance};
  Fresh out{o, d, rng, active, throughput, radiance, last_pdf, last_delta,
            pix, rays, bounce, widx, live};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks(sh.n);
  const bool t = tiled(bh, width);
  if (active != nullptr) {
    if (t) raygen_kernel<true, true><<<g, kBlock, 0, s>>>(lens, sample, sh, out);
    else raygen_kernel<false, true><<<g, kBlock, 0, s>>>(lens, sample, sh, out);
  } else {
    if (t) raygen_kernel<true, false><<<g, kBlock, 0, s>>>(lens, sample, sh, out);
    else raygen_kernel<false, false><<<g, kBlock, 0, s>>>(lens, sample, sh, out);
  }
  return (int)cudaGetLastError();
}

// acc [bh, width, 4] (16-byte aligned; its 4th float unused) += the
// radiance [nbatch * bh * width, 3] of a trace, summed over its nbatch
// samples left to right; pix int64 (null: the lanes in their own order)
// the pixel lane of each lane (the resort's); scratch [n, 4] float32
// (16-byte aligned), non-null: the radiance scattered into pixel-lane
// order first and summed from there, null with pix: each lane added at
// its pixel (nbatch 1 only). The int64 device scalars rays, segments and
// sample (all null, or none) take trace_rays, bounce and nbatch in the
// same launch.
int msn_frame_accumulate(const float* radiance, const long long* pix,
                         int nbatch, int bh, int width, float* scratch,
                         float* acc, long long* rays,
                         const long long* trace_rays, long long* segments,
                         const long long* bounce, long long* sample,
                         void* stream) {
  if (bh <= 0 || width <= 0 || nbatch <= 0) return (int)cudaErrorInvalidValue;
  const long long band = (long long)bh * width;
  if (4 * band * nbatch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (pix != nullptr && scratch == nullptr && nbatch != 1)
    return (int)cudaErrorInvalidValue;
  const Tally tally{rays, trace_rays, segments, bounce, sample};
  if ((rays == nullptr) != (trace_rays == nullptr) ||
      (rays == nullptr) != (segments == nullptr) ||
      (rays == nullptr) != (bounce == nullptr) ||
      (rays == nullptr) != (sample == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks(band);
  const bool t = tiled(bh, width);
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const int b = (int)band;
#define MSN_ACC(T, P, SRC, PIX)                                    \
  accumulate_kernel<T, P><<<g, kBlock, 0, s>>>(SRC, PIX, nbatch, b,    \
                                               width, acc4, tally)
  if (pix != nullptr && scratch != nullptr) {
    float4* into = reinterpret_cast<float4*>(scratch);
    pix_scatter_kernel<<<blocks(band * nbatch), kBlock, 0, s>>>(
        radiance, pix, into, (int)(band * nbatch));
    const float4* src = into;
    if (t) MSN_ACC(true, false, src, nullptr);
    else MSN_ACC(false, false, src, nullptr);
  } else if (pix != nullptr) {
    if (t) MSN_ACC(true, true, radiance, pix);
    else MSN_ACC(false, true, radiance, pix);
  } else {
    if (t) MSN_ACC(true, false, radiance, nullptr);
    else MSN_ACC(false, false, radiance, nullptr);
  }
#undef MSN_ACC
  return (int)cudaGetLastError();
}

}  // extern "C"
