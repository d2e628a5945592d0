// The bf16 key-chunked forward as a two-buffer kernel: one block per 16 *
// kChunkedWarps queries, K and V through two cp.async buffers a register
// chunk at a time, two block barriers a chunk. It takes the steps of
// csrc/attention_qkv_fwd.cu's bodies in their order (the first sweep the
// row max and sum, the second S again, P normalised in f32 and rounded,
// then P V), so the ring body there must give its bits: the emulator
// (emulate.cpp, "chunked") runs it as the ring body's bit reference. It
// is the key-chunked forward the card ran before the ring body served
// every padded width, and is not built for the card. Included by
// emulate.cpp after that source's bf16 kernels, whose helpers it uses.
#pragma once

namespace {

constexpr int kChunkedWarps = 4;

template <int Dp>
__global__ void __launch_bounds__(kChunkedWarps * 32)
attention_fwd_mma_long_kernel(const Operand<tc::bf16> q_op,
                              const Operand<tc::bf16> k_op,
                              const Operand<tc::bf16> v_op,
                              tc::bf16* __restrict__ out, int n, int heads,
                              int d, float scale) {
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  constexpr int kRows = 16 * kChunkedWarps;
  extern __shared__ uint4 smem_tc[];
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_tc);  // kRows rows
  tc::bf16* kv = qs + kRows * kPad;  // 2 buffers of K then V, kChunk rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRows;
  const int npad = tc::pad16(n);
  const bool active = q0 + 16 * warp < npad;
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const tc::bf16* kh = k_op.head(b, h, d);
  const tc::bf16* vh = v_op.head(b, h, d);

  tc::stage_rows<Dp>(q_op.head(b, h, d) + q0 * q_op.row, q_op.row, qs,
                     min(kRows, n - q0), kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();
  constexpr bool kQSmem = tc::a_in_smem(Dp);  // Q's fragments read per step
  uint32_t qa[kQSmem ? 1 : Dp / 16][4];
  if constexpr (!kQSmem) {
    if (active) tc::load_a<Dp>(qa, qs, 16 * warp, lane);
  }

  const int chunks = (n + kChunk - 1) / kChunk;
  // stage chunk c of K (and of V) into buffer c % 2, as one cp.async group
  auto stage = [&](int c, bool with_v) {
    tc::bf16* kb = kv + (c & 1) * 2 * kChunk * kPad;
    const int k0 = c * kChunk;
    const int cnt = min(kChunk, n - k0);
    tc::stage_rows<Dp>(kh + k0 * k_op.row, k_op.row, kb, cnt, kChunk, d);
    if (with_v) {
      tc::stage_rows<Dp>(vh + k0 * v_op.row, v_op.row, kb + kChunk * kPad,
                         cnt, kChunk, d);
    }
    tc::cp_async_commit();
  };

  float s[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[Dp / 8][4] = {};
  float inv[2] = {0.f, 0.f};
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool second = sweep == 1;
    stage(0, second);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(c + 1, second);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const tc::bf16* kb = kv + (c & 1) * 2 * kChunk * kPad;
        if constexpr (kQSmem) {
          tc::masked_scores_smem<Dp>(s, qs, 16 * warp, kb, 0, n - c * kChunk,
                                     kChunk, scale, lane);
        } else {
          tc::masked_scores<Dp>(s, qa, kb, 0, n - c * kChunk, kChunk, scale,
                                lane);
        }
        if (!second) {
          fold_chunk(s, m, l, false);
        } else {
          exp_scores(s, m);
          accumulate_pv<Dp>(o, s, inv, kb + kChunk * kPad, 0, kChunk, lane);
        }
      }
      __syncthreads();  // buffer c % 2 is free for chunk c + 2
    }
    // P normalised by the rounded reciprocal of the sum
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
  }
  if (active) {
    tc::store_rows<Dp>(o, out + static_cast<int64_t>(b) * n * hd + h * d,
                       hd, q0 + 16 * warp, n, d, lane);
  }
}

}  // namespace
