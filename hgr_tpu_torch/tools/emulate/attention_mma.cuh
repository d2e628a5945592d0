// Host stand-in for csrc/attention_mma.cuh's primitives, with the same
// names and fragment layouts (the real header's comment lists them): each
// warp collective posts its lane's operands through emulate.cpp's per-warp
// slots and reads the others'. mma sums in double, so the products are
// exact where the tensor cores' f32 accumulation rounds; copies are
// immediate, barriers of the copies are no-ops.
#pragma once
#include <cstdint>

#include "cuda_bf16.h"

namespace emu {
// a warp-wide exchange: every lane posts ``n`` words (a barrier), reads
// any lane's, and ends it (a second barrier)
void post(const uint32_t* w, int n);
const uint32_t* slot(int lane);
void done();
int lane();
}  // namespace emu

namespace attn_mma {
using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
inline int pad16(int n) { return (n + 15) & ~15; }
inline uint32_t smem_addr(const void*) { return 0; }
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async_wait_all() {}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void mbar_init(uint64_t*, unsigned) {}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t*) {}
inline void mbar_wait(uint64_t*, unsigned) {}

// ldmatrix: lanes 8i..8i+7 address the rows of matrix i; lane l receives
// (row l / 4, columns 2 (l % 4), + 1), or with .trans (rows 2 (l % 4) and
// + 1, column l / 4)
template <int M, bool kTrans>
inline void ldsm(uint32_t* r, const bf16* p) {
  const uint64_t a = reinterpret_cast<uint64_t>(p);
  const uint32_t w[2] = {uint32_t(a), uint32_t(a >> 32)};
  emu::post(w, 2);
  const int l = emu::lane();
  for (int i = 0; i < M; ++i) {
    auto row = [&](int rr) {
      const uint32_t* s = emu::slot(8 * i + rr);
      return reinterpret_cast<const bf16*>(uint64_t(s[0]) |
                                           (uint64_t(s[1]) << 32));
    };
    uint16_t lo, hi;
    if (!kTrans) {
      lo = row(l / 4)[2 * (l % 4)].x;
      hi = row(l / 4)[2 * (l % 4) + 1].x;
    } else {
      lo = row(2 * (l % 4))[l / 4].x;
      hi = row(2 * (l % 4) + 1)[l / 4].x;
    }
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  emu::done();
}
inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) { ldsm<4, false>(r, p); }
inline void ldsm_x2(uint32_t (&r)[2], const bf16* p) { ldsm<2, false>(r, p); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  ldsm<4, true>(r, p);
}

inline float bf16_half(uint32_t w, int hi) {
  return __uint_as_float((hi ? (w >> 16) : (w & 0xffffu)) << 16);
}

// d += a (16 x 16 bf16) . b (16 x 8 bf16)
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                uint32_t b1) {
  const uint32_t w[6] = {a[0], a[1], a[2], a[3], b0, b1};
  emu::post(w, 6);
  const int l = emu::lane(), g = l / 4, t = l % 4;
  auto A = [&](int r, int k) {
    const uint32_t* s = emu::slot(4 * (r % 8) + (k % 8) / 2);
    return bf16_half(s[(r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)], k % 2);
  };
  auto B = [&](int k, int c) {
    const uint32_t* s = emu::slot(4 * c + (k % 8) / 2);
    return bf16_half(s[4 + (k >= 8)], k % 2);
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double acc = d[e];
    for (int k = 0; k < 16; ++k) acc += double(A(r, k)) * double(B(k, c));
    out[e] = float(acc);
  }
  emu::done();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}

inline uint32_t pack(float x0, float x1) {
  return uint32_t(__float2bfloat16(x0).x) |
         (uint32_t(__float2bfloat16(x1).x) << 16);
}

template <int K>
inline void pack_split(float x0, float x1, uint32_t (&part)[K]) {
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    part[k] = uint32_t(h.x.x) | (uint32_t(h.y.x) << 16);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
inline float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
}  // namespace attn_mma
