// Fused HSV jitter + two-pass bilinear affine warp of staged canvases.
//
// Replaces the TPU kernels hgr_tpu/ops/warp_pallas.py:251
// (_warp_kernel_packed, the default) and :195 (_warp_kernel, planar),
// both launched by _warp_one_call :325 under warp_twopass_pallas :398.
// One kernel, templated over the canvas element type (uint8, float,
// __nv_bfloat16) and the output type, covers both: the canvas is read as
// stored, (B, S, S, 3) NHWC.
//
// What it computes, per image b and output pixel (y', x'), from the
// image's (2, 3) src->dst affine M, its HSV gains and its do_jitter flag:
//   minv     = the inverse of M, (sx, sy) = (p x' + q y' + r, s x' + t y'
//              + u), and the shear decomposition of ops/warp.py
//              twopass_coefficients: the transpose route use_t where
//              |t| < |s| (rows and columns of the canvas swapped), then
//              alpha, beta, gamma, s2, t2, u2;
//   img      = the (routed) canvas, with the cv2 8-bit HSV-LUT jitter
//              applied to each pixel where the image jitters
//              (_hsv_jitter_planes :118);
//   H[k, x'] = lerp_x(img[k, .], alpha x' + beta k + gamma)
//   out      = lerp_y(H[., x'], s2 x' + t2 y' + u2)
// with the clamped taps of _taps :100 (the fraction tied to the clamped
// integer tap, clipped to [0, 1]), blended left (1 - fx) + right fx, then
// top (1 - fy) + bot fy; then the BORDER_CONSTANT mask from minv
// (warp_pallas.py:502-513) and, on request, round(clip(., 0, 255))
// (:515-518). Output (B, out_h, out_w, 3): uint8 for a uint8 canvas with
// rounding (the Pallas wrapper's out.astype(orig_dtype)), else float32.
//
// Built with -fmad=false (utils/cuda_build.py): every product, sum and
// quotient is rounded on its own, in the order of the plain PyTorch
// version's separate elementwise ops (ops/affine.py invert_affine,
// ops/warp.py twopass_coefficients, twopass_sample, border_mask), so the
// two agree bit for bit; one ulp in alpha can move a floor by a level.
//
// Bound on an H100 SXM at the training shape (B=256, S=256, 192x192 out,
// uint8): the function must read the canvas pixels its taps reach (the
// crop's footprint, ~100 x 100 px an image at the training scales, ~7.5
// MB in all) and write the uint8 crop once (28.3 MB): ~11 us at 3.35
// TB/s. The kernel is memory-bound: ~45 flops per output pixel and ~60
// per jittered source pixel.
//
// Design: one block of 256 threads per (image, 32 x 64 output tile; 32 x
// 32 tiles timed 20% slower: the staging's load latency is paid once a
// tile), at most 48 registers a thread so that five blocks share an SM.
//   1. Thread 0 derives the image's parameters into shared memory.
//   2. The tile is cut into sub-tiles whose footprint fits the block's
//      shared memory: the whole 32 x 64 tile at the training shapes, and
//      halves of it (32 x 32, 16 x 32, ... down to one pixel) where the
//      affine shrinks hard; the size is chosen once per image from a
//      bound on the footprint of a sub-tile (sub_tile_bytes).
//   3. Per sub-tile: the routed rows k of its vertical taps and, over
//      those rows, the columns of its horizontal taps, from the positions
//      at its corners (each position is monotone in x' and y' as computed,
//      so the corners bound every tap). That box of the canvas, in canvas
//      coordinates (rows and columns swapped on the transpose route, so
//      rows of the canvas are always read along the row), is copied into
//      shared memory by 16-byte cp.async chunks, then each staged pixel is
//      jittered once and kept as one packed word B | G<<8 | R<<16 (uint8
//      canvases; the jitter gives exact 0-255 integers, the TPU kernel's
//      own packing) or three floats (float canvases).
//   4. Pass 1: H[k, x'] for the sub-tile's rows and columns into shared
//      memory (f32, planar); pass 2: the vertical lerp, the mask and the
//      rounding read it and write the output tile in shared memory; both
//      a warp a row, a lane a column.
//   5. The output tile goes out as 16-byte stores where its rows are
//      aligned (every row at out_w = 192), else element by element.
// What bounds it (B=256, 256 -> 192, uint8, on an H100): not the ~36 MB
// it moves (~11 us) but each block's two serial global-memory latencies
// (its parameters, then its staging) at five blocks an SM, and the
// instructions of the jitter and of the two passes; overlapping one
// tile's staging with the previous tile's passes (persistent blocks) is
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32, kTileW = 64;     // output tile, rows x columns
// dynamic shared memory a block asks for by default: with the static
// parameters it stays under the 48 KB a block may take without opting in
constexpr int kDefaultSmem = 44 * 1024;
constexpr size_t kSmemLimit = 232448;       // bytes one H100 block may use

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
  // the sector formulas 30 (g - b) / c, 60 + 30 (b - r) / c and 120 +
  // 30 (r - g) / c, only the one that is taken divided
  const float num = v == r ? g - b : (v == g ? b - r : r - g);
  const float q = 30.f * num / safe_c;
  float h = v == r ? q : (v == g ? 60.f : 120.f) + q;
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

// x as a value the compiler may not re-derive from its operands. Each of
// the footprint's bounds below (kmin, kmax, nk, cmin, cmax, nx; the box's
// origin and extent are selects of these) goes through it: nvcc 12.9 (and
// the driver's JIT) for sm_90a re-derived kmin, nk, cmin and nx from their
// min/max chain in a later phase, got a different value there and read H
// out of its rows (wrong pixels, or an "illegal instruction" fault),
// depending on the loop shapes around them; -Xptxas -O0 hid it.
// tools/probe_warp_opaque.py builds this source with opaque() and with an
// identity in its place and holds both against the plain version.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The clamped integer tap of a position: clip(floor(pos), 0, s - 1), as
// taps() takes it (NaN lands on 0).
__device__ __forceinline__ int tap0(float pos, int s) {
  return static_cast<int>(clip(floorf(pos), 0.f, static_cast<float>(s - 1)));
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

// An image's parameters, derived from its affine in the order of the
// plain version's ops.
struct Params {
  float mi[6];  // the inverse affine p, q, r, s, t, u (the border mask)
  float alpha, beta, gamma, s2, t2, u2;
  float gh, gs, gv;
  int use_t, jit;
};

__device__ Params make_params(const float* __restrict__ m,
                              const float* __restrict__ gains,
                              const float* __restrict__ do_jitter, int b) {
  Params p;
  // ops/affine.py invert_affine
  const float a00 = m[0], a01 = m[1], b0 = m[2];
  const float a10 = m[3], a11 = m[4], b1 = m[5];
  const float det = a00 * a11 - a01 * a10;
  const float i00 = a11 / det, i01 = -a01 / det;
  const float i10 = -a10 / det, i11 = a00 / det;
  const float r_ = -(i00 * b0 + i01 * b1);
  const float u_ = -(i10 * b0 + i11 * b1);
  p.mi[0] = i00; p.mi[1] = i01; p.mi[2] = r_;
  p.mi[3] = i10; p.mi[4] = i11; p.mi[5] = u_;
  // ops/warp.py twopass_coefficients
  const bool use_t = fabsf(i11) < fabsf(i10);
  const float pp = use_t ? i10 : i00;
  const float q = use_t ? i11 : i01;
  const float r = use_t ? u_ : r_;
  p.s2 = use_t ? i00 : i10;
  p.t2 = use_t ? i01 : i11;
  p.u2 = use_t ? r_ : u_;
  const float safe_t = fabsf(p.t2) < 1e-6f ? 1e-6f : p.t2;
  p.alpha = pp - q * p.s2 / safe_t;
  p.beta = q / safe_t;
  p.gamma = r - q * p.u2 / safe_t;
  p.use_t = use_t;
  p.jit = gains != nullptr && (do_jitter == nullptr || do_jitter[b] > 0.f);
  p.gh = gains != nullptr ? gains[3 * b] : 1.f;
  p.gs = gains != nullptr ? gains[3 * b + 1] : 1.f;
  p.gv = gains != nullptr ? gains[3 * b + 2] : 1.f;
  return p;
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// Shared memory a sub-tile needs besides the output tile: the staged box
// of nr x nc canvas pixels (raw bytes as copied, then ``planes`` words a
// pixel at a row pitch of nc | 1) and H for its k rows and w columns (f32,
// three planes), which reuses the raw bytes' room.
__host__ __device__ __forceinline__ int sub_tile_bytes(int nr, int nc, int k,
                                                       int w, int es,
                                                       int planes) {
  const int raw = nr * round16(3 * es * nc + 15);
  const int h = 12 * k * w;
  return round16(raw > h ? raw : h) + 4 * planes * nr * (nc | 1);
}

// Bounds on the rows k and the columns of a sub-tile of sh x sw output
// pixels: its taps span at most |s2| (sw - 1) + |t2| (sh - 1) rows and
// |alpha| (sw - 1) + |beta| (rows - 1) columns, plus the two taps and
// the floors (and less than an ulp of rounding at these magnitudes).
__device__ __forceinline__ void footprint_bound(const Params& p, int s, int sh,
                                                int sw, int* k, int* w) {
  const float fs = static_cast<float>(s);
  const float kf = fabsf(p.s2) * static_cast<float>(sw - 1) +
                   fabsf(p.t2) * static_cast<float>(sh - 1);
  *k = min(s, static_cast<int>(fminf(kf, fs)) + 4);
  const float wf = fabsf(p.alpha) * static_cast<float>(sw - 1) +
                   fabsf(p.beta) * static_cast<float>(*k - 1);
  *w = min(s, static_cast<int>(fminf(wf, fs)) + 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

template <typename T>
struct Staged;  // how a staged pixel is kept

template <>
struct Staged<uint8_t> {  // one packed word B | G<<8 | R<<16
  static constexpr int kPlanes = 1;
  __device__ static void put(uint32_t* st, int plane, int i,
                             const float* bgr) {
    st[i] = static_cast<uint32_t>(bgr[0]) |
            (static_cast<uint32_t>(bgr[1]) << 8) |
            (static_cast<uint32_t>(bgr[2]) << 16);
  }
  __device__ static void get(const uint32_t* st, int plane, int i,
                             float* bgr) {
    const uint32_t v = st[i];
    bgr[0] = static_cast<float>(v & 0xffu);
    bgr[1] = static_cast<float>((v >> 8) & 0xffu);
    bgr[2] = static_cast<float>((v >> 16) & 0xffu);
  }
};

template <typename T>
struct Staged {  // float canvases: three f32 planes
  static constexpr int kPlanes = 3;
  __device__ static void put(uint32_t* st, int plane, int i,
                             const float* bgr) {
    float* f = reinterpret_cast<float*>(st);
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c * plane + i] = bgr[c];
  }
  __device__ static void get(const uint32_t* st, int plane, int i,
                             float* bgr) {
    const float* f = reinterpret_cast<const float*>(st);
#pragma unroll
    for (int c = 0; c < 3; ++c) bgr[c] = f[c * plane + i];
  }
};

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v) {
  return static_cast<OutT>(v);
}

// One sub-tile: output rows y0..y0+h-1, columns x0..x0+w-1 of the tile at
// (ty0, tx0), into the output tile ``ot`` (kTileH x kTileW x 3, shared).
template <typename T, typename OutT>
__device__ void sub_tile(const Params& p, const T* __restrict__ img,
                         const unsigned char* begin, const unsigned char* end,
                         int s, int y0, int x0, int h, int w, int ty0,
                         int tx0, int kb, int wb, bool round_output,
                         unsigned char* work, OutT* ot) {
  constexpr int es = sizeof(T);
  using St = Staged<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float xa = static_cast<float>(x0), xb = static_cast<float>(x0 + w - 1);
  const float ya = static_cast<float>(y0), yb = static_cast<float>(y0 + h - 1);

  // the routed rows of the vertical taps (v is monotone in x' and y')
  const int v00 = tap0(p.s2 * xa + p.t2 * ya + p.u2, s);
  const int v01 = tap0(p.s2 * xb + p.t2 * ya + p.u2, s);
  const int v10 = tap0(p.s2 * xa + p.t2 * yb + p.u2, s);
  const int v11 = tap0(p.s2 * xb + p.t2 * yb + p.u2, s);
  const int kmin = opaque(min(min(v00, v01), min(v10, v11)));
  const int vhi = max(max(v00, v01), max(v10, v11));
  // the cap at kmin + kb - 1 never binds (memory safety)
  const int kmax = opaque(min(min(vhi + 1, s - 1), kmin + kb - 1));
  const int nk = opaque(kmax - kmin + 1);
  // over those rows, the columns of the horizontal taps
  const float ka = static_cast<float>(kmin), kz = static_cast<float>(kmax);
  const int c00 = tap0(p.alpha * xa + p.beta * ka + p.gamma, s);
  const int c01 = tap0(p.alpha * xb + p.beta * ka + p.gamma, s);
  const int c10 = tap0(p.alpha * xa + p.beta * kz + p.gamma, s);
  const int c11 = tap0(p.alpha * xb + p.beta * kz + p.gamma, s);
  const int cmin = opaque(min(min(c00, c01), min(c10, c11)));
  const int chi = max(max(c00, c01), max(c10, c11));
  // the cap at cmin + wb - 1 never binds (memory safety)
  const int cmax = opaque(min(min(chi + 1, s - 1), cmin + wb - 1));
  const int nx = opaque(cmax - cmin + 1);

  // the box in canvas coordinates: routed rows are canvas columns on the
  // transpose route
  const int r0 = p.use_t ? cmin : kmin, nr = p.use_t ? nx : nk;
  const int c0 = p.use_t ? kmin : cmin, nc = p.use_t ? nk : nx;
  const int seg = 3 * es * nc;               // bytes of a box row
  const int rp = round16(seg + 15);          // raw row pitch
  const int sp = nc | 1;                     // staged row pitch (banks)
  const int hb = 12 * nk * w;
  unsigned char* raw = work;                 // then H
  float* hs = reinterpret_cast<float*>(work);
  uint32_t* st = reinterpret_cast<uint32_t*>(
      work + round16(nr * rp > hb ? nr * rp : hb));
  const int plane = nr * sp;

  // 1. the box rows, a warp a row, 16-byte chunks from the row's aligned
  // start
  const int chunks = rp / 16;
  for (int r = warp; r < nr; r += kWarps) {
    const unsigned char* a = reinterpret_cast<const unsigned char*>(
        img + (static_cast<int64_t>(r0 + r) * s + c0) * 3);
    const unsigned char* a16 = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(a) & ~static_cast<uintptr_t>(15));
    for (int c = lane; c < chunks; c += 32) {
      const unsigned char* q = a16 + 16 * c;
      if (q >= a + seg) break;
      unsigned char* dst = raw + r * rp + 16 * c;
      if (q >= begin && q + 16 <= end) {
        cp_async16(dst, q);
      } else {  // a chunk over the canvas's first or last byte
        for (int j = 0; j < 16; ++j) {
          if (q + j >= begin && q + j < end) dst[j] = q[j];
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // 2. each staged pixel jittered once, a warp a row
  for (int r = warp; r < nr; r += kWarps) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        img + (static_cast<int64_t>(r0 + r) * s + c0) * 3);
    const unsigned char* row = raw + r * rp + (a & 15);
    for (int c = lane; c < nc; c += 32) {
      const T* px = reinterpret_cast<const T*>(row + 3 * es * c);
      float bgr[3] = {to_f32(px[0]), to_f32(px[1]), to_f32(px[2])};
      if (p.jit) jitter(bgr, p.gh, p.gs, p.gv);
      St::put(st, plane, r * sp + c, bgr);
    }
  }
  __syncthreads();
  // 3. pass 1: H[k, x'] of the rows kmin..kmax (raw is dead: H reuses it),
  // a warp a row, a lane a column
  for (int kk = warp; kk < nk; kk += kWarps) {
    const float kf = static_cast<float>(kmin + kk);
    for (int xx = lane; xx < w; xx += 32) {
      const float pos =
          p.alpha * static_cast<float>(x0 + xx) + p.beta * kf + p.gamma;
      const Taps t = taps(pos, s);
      const int x_0 = min(max(t.i0 - cmin, 0), nx - 1);
      const int x_1 = min(max(t.i1 - cmin, 0), nx - 1);
      float left[3], right[3];
      St::get(st, plane, p.use_t ? x_0 * sp + kk : kk * sp + x_0, left);
      St::get(st, plane, p.use_t ? x_1 * sp + kk : kk * sp + x_1, right);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        hs[(c * nk + kk) * w + xx] =
            left[c] * (1.f - t.frac) + right[c] * t.frac;
      }
    }
  }
  __syncthreads();
  // 4. pass 2: the vertical lerp, the mask, the rounding, a warp a row
  const float fs = static_cast<float>(s);
  for (int yy = warp; yy < h; yy += kWarps) {
    const float yp = static_cast<float>(y0 + yy);
    for (int xx = lane; xx < w; xx += 32) {
      const float xp = static_cast<float>(x0 + xx);
      const Taps ty = taps(p.s2 * xp + p.t2 * yp + p.u2, s);
      const int k0 = min(max(ty.i0 - kmin, 0), nk - 1);
      const int k1 = min(max(ty.i1 - kmin, 0), nk - 1);
      // cv2 BORDER_CONSTANT: zero where the exact inverse map leaves the
      // canvas
      const float sx = p.mi[0] * xp + p.mi[1] * yp + p.mi[2];
      const float sy = p.mi[3] * xp + p.mi[4] * yp + p.mi[5];
      const float inside =
          (sx > -1.f && sx < fs && sy > -1.f && sy < fs) ? 1.f : 0.f;
      OutT* o = ot + ((y0 - ty0 + yy) * kTileW + (x0 - tx0 + xx)) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float top = hs[(c * nk + k0) * w + xx];
        const float bot = hs[(c * nk + k1) * w + xx];
        float v = (top * (1.f - ty.frac) + bot * ty.frac) * inside;
        if (round_output) v = rintf(clip(v, 0.f, 255.f));
        o[c] = to_out<OutT>(v);
      }
    }
  }
  __syncthreads();  // the next sub-tile reuses the staging room
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads, 5)
warp_twopass_kernel(const T* __restrict__ canvas,
                    const float* __restrict__ affines,
                    const float* __restrict__ gains,
                    const float* __restrict__ do_jitter,
                    OutT* __restrict__ out, int batch, int s, int out_h,
                    int out_w, int round_output, int smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Params shared_params;
  const int b = blockIdx.y;
  const int tiles_x = (out_w + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * kTileW;
  const int th = min(kTileH, out_h - ty0), tw = min(kTileW, out_w - tx0);
  if (threadIdx.x == 0) {
    shared_params = make_params(affines + 6 * b, gains, do_jitter, b);
  }
  __syncthreads();
  const Params p = shared_params;

  constexpr int kOutBytes = kTileH * kTileW * 3 * sizeof(OutT);
  OutT* ot = reinterpret_cast<OutT*>(smem_raw);
  unsigned char* work = smem_raw + kOutBytes;
  const int room = smem - kOutBytes;
  constexpr int es = sizeof(T);
  constexpr int planes = Staged<T>::kPlanes;

  // the largest sub-tile (32 x 64, 32 x 32, 16 x 32, ... 1 x 1) whose
  // footprint bound fits, the same for every tile of the image
  int sh = kTileH, sw = kTileW, kb = 0, wb = 0;
  for (;;) {
    footprint_bound(p, s, sh, sw, &kb, &wb);
    const int nr = p.use_t ? wb : kb, nc = p.use_t ? kb : wb;
    if (sub_tile_bytes(nr, nc, kb, sw, es, planes) <= room ||
        (sh == 1 && sw == 1)) {
      break;
    }
    if (sh >= sw) {  // halve the longer side
      sh = (sh + 1) / 2;
    } else {
      sw = (sw + 1) / 2;
    }
  }

  const T* img = canvas + static_cast<int64_t>(b) * s * s * 3;
  const unsigned char* begin = reinterpret_cast<const unsigned char*>(canvas);
  const unsigned char* end = reinterpret_cast<const unsigned char*>(
      canvas + static_cast<int64_t>(batch) * s * s * 3);
  for (int sy = 0; sy < th; sy += sh) {
    for (int sx = 0; sx < tw; sx += sw) {
      sub_tile<T, OutT>(p, img, begin, end, s, ty0 + sy, tx0 + sx,
                        min(sh, th - sy), min(sw, tw - sx), ty0, tx0, kb, wb,
                        round_output != 0, work, ot);
    }
  }

  // the output tile: 16-byte stores where a row allows them
  const int row_bytes = tw * 3 * static_cast<int>(sizeof(OutT));
  unsigned char* base = reinterpret_cast<unsigned char*>(
      out + (static_cast<int64_t>(b) * out_h + ty0) * out_w * 3);
  const int64_t out_row = static_cast<int64_t>(out_w) * 3 * sizeof(OutT);
  const int64_t col0 = static_cast<int64_t>(tx0) * 3 * sizeof(OutT);
  const bool vec = row_bytes % 16 == 0 && out_row % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(base) + col0) % 16 == 0;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(ot);
  constexpr int kTileRow = kTileW * 3 * sizeof(OutT);
  const int lane = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < th; y += kWarps) {  // a warp a row
    if (vec) {
      for (int c = lane; c < row_bytes / 16; c += 32) {
        *reinterpret_cast<uint4*>(base + y * out_row + col0 + 16 * c) =
            *reinterpret_cast<const uint4*>(src + y * kTileRow + 16 * c);
      }
    } else {
      for (int c = lane; c < tw * 3; c += 32) {
        reinterpret_cast<OutT*>(base + y * out_row + col0)[c] =
            ot[y * kTileW * 3 + c];
      }
    }
  }
}

// Shared memory a block asks for: the default, or what a one-pixel
// sub-tile's widest footprint (two to four rows, or columns, across the
// canvas) needs beside the output tile.
size_t smem_bytes(int s, int es, int planes, int out_es) {
  const int out_bytes = kTileH * kTileW * 3 * out_es;
  const int k = s < 4 ? s : 4;
  const int rows = sub_tile_bytes(k, s, k, 1, es, planes);
  const int cols = sub_tile_bytes(s, k, k, 1, es, planes);
  const int need = out_bytes + (rows > cols ? rows : cols);
  return static_cast<size_t>(need > kDefaultSmem ? need : kDefaultSmem);
}

template <typename T, typename OutT>
cudaError_t launch(const void* canvas, const void* affines, const void* gains,
                   const void* do_jitter, void* out, int batch, int s,
                   int out_h, int out_w, int round_output,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(s, sizeof(T), Staged<T>::kPlanes,
                                 sizeof(OutT));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(warp_twopass_kernel<T, OutT>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = ((out_h + kTileH - 1) / kTileH) *
                    ((out_w + kTileW - 1) / kTileW);
  warp_twopass_kernel<T, OutT><<<dim3(tiles, batch), kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(canvas), static_cast<const float*>(affines),
      static_cast<const float*>(gains), static_cast<const float*>(do_jitter),
      static_cast<OutT*>(out), batch, s, out_h, out_w, round_output,
      static_cast<int>(smem));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// canvas (batch, s, s, 3) of dtype 0 = float32, 1 = bfloat16, 2 = uint8;
// affines (batch, 2, 3) float32 src->dst; gains (batch, 3) float32 or
// null (no jitter); do_jitter (batch,) float32 or null (every image
// jitters when gains are given); out (batch, out_h, out_w, 3) of out_dtype
// 0 = float32 or 2 = uint8 (only with round_output). All contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
int warp_twopass(const void* canvas, const void* affines, const void* gains,
                 const void* do_jitter, void* out, int batch, int s,
                 int out_h, int out_w, int dtype, int out_dtype,
                 int round_output, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || out_h < 1 || out_w < 1 ||
      out_h > s || out_w > s || (out_dtype == 2 && !round_output)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (out_dtype == 2 && dtype == 2) {
    err = launch<uint8_t, uint8_t>(canvas, affines, gains, do_jitter, out,
                                   batch, s, out_h, out_w, round_output, st);
  } else if (out_dtype == 0) {
    switch (dtype) {
      case 0:
        err = launch<float, float>(canvas, affines, gains, do_jitter, out,
                                   batch, s, out_h, out_w, round_output, st);
        break;
      case 1:
        err = launch<__nv_bfloat16, float>(canvas, affines, gains, do_jitter,
                                           out, batch, s, out_h, out_w,
                                           round_output, st);
        break;
      case 2:
        err = launch<uint8_t, float>(canvas, affines, gains, do_jitter, out,
                                     batch, s, out_h, out_w, round_output,
                                     st);
        break;
      default:
        break;
    }
  }
  return static_cast<int>(err);
}

const char* warp_twopass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
