// Host stand-ins for the PTX primitives of csrc/attention_mma.cuh
// (cp.async, the bulk copy, the mbarriers, ldmatrix and mma), with the
// same names and fragment layouts (the real header's comment lists them).
// hgr_tpu_torch/tools/emulate_wide.py cuts the real ones out of a copy of
// that header and puts these ahead of the rest of it, so every other
// helper of the header (staging, fragment loads, the ring, the row
// reductions, the stores) runs as written. Each warp collective posts its
// lane's operands through emulate.cpp's per-warp slots and reads the
// others'. mma sums in double, so the products are exact where the tensor
// cores' f32 accumulation rounds; copies are immediate; an mbarrier counts
// its arrivals and completes its phase as the hardware's does, and a wait
// yields the fiber until the phase it waits for has completed.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"

namespace emu {
// a warp-wide exchange: every lane posts ``n`` words (a barrier), reads
// any lane's, and ends it (a second barrier)
void post(const uint32_t* w, int n);
const uint32_t* slot(int lane);
void done();
int lane();
// lets the other fibers run while a wait is not met
void yield();
// an arrival on an mbarrier: progress for the scheduler's deadlock check
void progressed();
}  // namespace emu

namespace attn_mma {
using bf16 = __nv_bfloat16;
inline uint32_t smem_addr(const void*) { return 0; }
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async_wait_all() {}
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}

// An mbarrier's word: bits 0-19 the arrivals a phase takes, bits 20-39
// those the current phase still waits for, bit 63 the current phase's
// parity.
inline void mbar_init(uint64_t* bar, unsigned count) {
  *bar = uint64_t(count) | (uint64_t(count) << 20);
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  const uint64_t count = *bar & 0xfffffu;
  uint64_t pending = ((*bar >> 20) & 0xfffffu) - 1;
  uint64_t parity = *bar >> 63;
  if (pending == 0) {  // the phase completes, the next one starts
    pending = count;
    parity ^= 1u;
  }
  *bar = count | (pending << 20) | (parity << 63);
  emu::progressed();
}
// the copies have landed at once: the arrival happens now
inline void mbar_arrive_copies(uint64_t* bar) { mbar_arrive(bar); }
// a bulk copy completes at once (its bytes never pend), so an arrival
// expecting bytes is a plain arrival
inline void bulk_row(void* dst, const void* src, unsigned bytes, uint64_t*) {
  memcpy(dst, src, bytes);
}
inline void mbar_arrive_expect(uint64_t* bar, unsigned) { mbar_arrive(bar); }
// returns once the phase of parity ``parity`` has completed, that is while
// the current phase has the other parity
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((*bar >> 63) == parity) emu::yield();
}

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
}  // namespace attn_mma
