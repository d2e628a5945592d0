// Fused HSV jitter + two-pass bilinear affine warp of staged canvases.
//
// Replaces the TPU kernels hgr_tpu/ops/warp_pallas.py:251
// (_warp_kernel_packed, the default) and :195 (_warp_kernel, planar),
// both launched by _warp_one_call :325 under warp_twopass_pallas :398.
// One kernel, templated over the canvas element type (uint8, float,
// __nv_bfloat16), covers both: the int32 channel packing was a TPU layout
// device, and the canvas is read here as stored, (B, S, S, 3) NHWC.
//
// What it computes, per image b and output pixel (y', x'), with the
// per-image parameters the host wrapper (ops/warp_fused.py) derives from
// the inverse affine:
//   img      = the canvas row/column swapped where use_t (the transpose
//              route for |t| < |s|: strides swapped, no copy), with the
//              cv2 8-bit HSV-LUT jitter applied to each pixel as it is
//              read where do_jitter > 0 (_hsv_jitter_planes :118);
//   H[k, x'] = lerp_x(img[k, .], alpha x' + beta k + gamma)
//   out      = lerp_y(H[., x'], s2 x' + t2 y' + u2)
// with the clamped taps of _taps :100 (the fraction tied to the clamped
// integer tap, clipped to [0, 1]), blended left (1 - fx) + right fx, then
// top (1 - fy) + bot fy. The vertical lerp reads H at its two rows only,
// so 4 source pixels per output pixel give exactly the two-pass result.
// Then the BORDER_CONSTANT mask from the inverse affine
// (warp_pallas.py:502-513) and, on request, round(clip(., 0, 255))
// (:515-518 and data/pipeline.py:306). Output (B, out_h, out_w, 3) f32.
//
// Built with -fmad=false (utils/cuda_build.py): every product and sum is
// rounded on its own, as the plain PyTorch version's separate
// elementwise ops round them, so the two agree bit for bit (the LUT's
// floor would otherwise turn a one-ulp difference into a level).
//
// Bound on an H100 SXM at the training shape (B=256, S=256, 192x192
// out): the function must read the uint8 canvas once (50.3 MB) and write
// the f32 output once (113.2 MB), 163.6 MB in all: 48.8 us at 3.35 TB/s
// (12.2 us at B=64). The kernel is memory-bound: ~30 flops per read.
//
// Design (simple first): one thread per output pixel, all 3 channels;
// blocks of 256 threads tile the output rows of one image
// (blockIdx.y = image). Each thread reads its 4 source pixels straight
// from device memory (the 12-row band one block touches stays in L1/L2)
// and jitters each read. Left for later: staging the two source rows of
// each output row through shared memory, and jittering each source pixel
// once instead of once per read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 17;  // ops/warp_fused.py _kernel_params

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(uint8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// cv2 8-bit HSV jitter of one BGR pixel (ops/color.py jitter_bgr_planes).
__device__ void jitter(float* bgr, float gh, float gs, float gv) {
  const float b = bgr[0], g = bgr[1], r = bgr[2];
  float v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float c = v - mn;
  const float safe_c = c > 0.f ? c : 1.f;
  const float h_r = 30.f * (g - b) / safe_c;
  const float h_g = 60.f + 30.f * (b - r) / safe_c;
  const float h_b = 120.f + 30.f * (r - g) / safe_c;
  float h = v == r ? h_r : (v == g ? h_g : h_b);
  h = c > 0.f ? h : 0.f;
  h = h < 0.f ? h + 180.f : h;
  float s = v > 0.f ? 255.f * c / (v > 0.f ? v : 1.f) : 0.f;

  // uint8 LUT semantics: round the stored HSV, scale, floor
  h = floorf(fmodf(rintf(h) * gh, 180.f));
  s = floorf(clip(rintf(s) * gs, 0.f, 255.f));
  v = floorf(clip(rintf(v) * gv, 0.f, 255.f));

  const float h_deg = h * 2.f;
  const float s01 = s / 255.f;
  const float cc = v * s01;
  const float hp = h_deg / 60.f;
  const float x = cc * (1.f - fabsf(fmodf(hp, 2.f) - 1.f));
  const float m = v - cc;
  const int sector = static_cast<int>(floorf(hp)) % 6;
  float r2, g2, b2;
  switch (sector) {
    case 0: r2 = cc; g2 = x; b2 = 0.f; break;
    case 1: r2 = x; g2 = cc; b2 = 0.f; break;
    case 2: r2 = 0.f; g2 = cc; b2 = x; break;
    case 3: r2 = 0.f; g2 = x; b2 = cc; break;
    case 4: r2 = x; g2 = 0.f; b2 = cc; break;
    default: r2 = cc; g2 = 0.f; b2 = x; break;
  }
  bgr[0] = rintf(clip(b2 + m, 0.f, 255.f));
  bgr[1] = rintf(clip(g2 + m, 0.f, 255.f));
  bgr[2] = rintf(clip(r2 + m, 0.f, 255.f));
}

struct Taps {
  int i0, i1;
  float frac;
};

__device__ __forceinline__ Taps taps(float pos, int s) {
  const float i0 = clip(floorf(pos), 0.f, static_cast<float>(s - 1));
  Taps t;
  t.frac = clip(pos - i0, 0.f, 1.f);
  t.i0 = static_cast<int>(i0);
  t.i1 = min(t.i0 + 1, s - 1);
  return t;
}

template <typename T>
struct Image {
  const T* base;
  int64_t row_stride, col_stride;  // of the routed (maybe transposed) view
  bool jit;
  float gh, gs, gv;

  __device__ void read(int k, int x, float* bgr) const {
    const T* p = base + k * row_stride + x * col_stride;
    bgr[0] = to_f32(p[0]);
    bgr[1] = to_f32(p[1]);
    bgr[2] = to_f32(p[2]);
    if (jit) jitter(bgr, gh, gs, gv);
  }

  // H[k, x'] at source row k: the horizontal pass
  __device__ void row(int k, float xp, float alpha, float beta, float gamma,
                      int s, float* h) const {
    const float pos = alpha * xp + beta * static_cast<float>(k) + gamma;
    const Taps t = taps(pos, s);
    float left[3], right[3];
    read(k, t.i0, left);
    read(k, t.i1, right);
#pragma unroll
    for (int c = 0; c < 3; ++c) h[c] = left[c] * (1.f - t.frac) + right[c] * t.frac;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_twopass_kernel(const T* __restrict__ canvas,
                    const float* __restrict__ params, float* __restrict__ out,
                    int s, int out_h, int out_w, int with_jitter,
                    int round_output) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_h * out_w) return;
  const int yo = pix / out_w;
  const int xo = pix - yo * out_w;
  const float* pr = params + static_cast<int64_t>(b) * kParams;
  const float alpha = pr[0], beta = pr[1], gamma = pr[2];
  const float s2 = pr[3], t2 = pr[4], u2 = pr[5];
  const bool use_t = pr[10] > 0.f;

  Image<T> img;
  img.base = canvas + static_cast<int64_t>(b) * s * s * 3;
  img.row_stride = use_t ? 3 : 3 * static_cast<int64_t>(s);
  img.col_stride = use_t ? 3 * static_cast<int64_t>(s) : 3;
  img.jit = with_jitter && pr[9] > 0.f;
  img.gh = pr[6];
  img.gs = pr[7];
  img.gv = pr[8];

  const float xp = static_cast<float>(xo);
  const float yp = static_cast<float>(yo);
  const Taps ty = taps(s2 * xp + t2 * yp + u2, s);
  float top[3], bot[3];
  img.row(ty.i0, xp, alpha, beta, gamma, s, top);
  img.row(ty.i1, xp, alpha, beta, gamma, s, bot);

  // cv2 BORDER_CONSTANT: zero where the exact inverse map leaves the canvas
  const float sx = pr[11] * xp + pr[12] * yp + pr[13];
  const float sy = pr[14] * xp + pr[15] * yp + pr[16];
  const float fs = static_cast<float>(s);
  const float inside =
      (sx > -1.f && sx < fs && sy > -1.f && sy < fs) ? 1.f : 0.f;

  float* o = out + ((static_cast<int64_t>(b) * out_h + yo) * out_w + xo) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = (top[c] * (1.f - ty.frac) + bot[c] * ty.frac) * inside;
    if (round_output) v = rintf(clip(v, 0.f, 255.f));
    o[c] = v;
  }
}

template <typename T>
cudaError_t launch(const void* canvas, const void* params, void* out,
                   int batch, int s, int out_h, int out_w, int with_jitter,
                   int round_output, cudaStream_t stream) {
  const dim3 grid((out_h * out_w + kThreads - 1) / kThreads, batch);
  warp_twopass_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(canvas), static_cast<const float*>(params),
      static_cast<float*>(out), s, out_h, out_w, with_jitter, round_output);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = uint8 canvas. params: (batch, 17)
// float32 (ops/warp_fused.py _kernel_params). Returns cudaGetLastError()
// after the launch (0 on success); the caller has checked shapes.
int warp_twopass(const void* canvas, const void* params, void* out, int batch,
                 int s, int out_h, int out_w, int dtype, int with_jitter,
                 int round_output, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || out_h < 1 || out_w < 1 ||
      out_h > s || out_w > s) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(canvas, params, out, batch, s,
                                            out_h, out_w, with_jitter,
                                            round_output, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          canvas, params, out, batch, s, out_h, out_w, with_jitter,
          round_output, st));
    case 2:
      return static_cast<int>(launch<uint8_t>(canvas, params, out, batch, s,
                                              out_h, out_w, with_jitter,
                                              round_output, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* warp_twopass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
