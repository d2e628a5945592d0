// Host stand-in for csrc/attention_tf32.cuh's mma: the m16n8k8 TF32
// product with the low 13 bits of each operand ignored, as the tensor
// cores do, summed in double.
#pragma once
#include "mma_primitives.h"

namespace attn_tf32 {
inline float tf32(uint32_t w) { return __uint_as_float(w & 0xffffe000u); }

// d += a (16 x 8 tf32) . b (8 x 8 tf32)
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                uint32_t b1) {
  const uint32_t w[6] = {a[0], a[1], a[2], a[3], b0, b1};
  emu::post(w, 6);
  const int l = emu::lane(), g = l / 4, t = l % 4;
  auto A = [&](int r, int k) {
    const uint32_t* s = emu::slot(4 * (r % 8) + k % 4);
    return tf32(s[(r >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)]);
  };
  auto B = [&](int k, int c) {
    return tf32(emu::slot(4 * c + k % 4)[4 + (k >= 4)]);
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double acc = d[e];
    for (int k = 0; k < 8; ++k) acc += double(A(r, k)) * double(B(k, c));
    out[e] = float(acc);
  }
  emu::done();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
}  // namespace attn_tf32
