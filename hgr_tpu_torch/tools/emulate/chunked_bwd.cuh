// The bf16 key-chunked backward as a pair of two-buffer kernels: one block
// per 16 * kChunkedWarps query (then key) rows, the other side through two
// cp.async buffers of kChunkedRows rows, two block barriers a chunk,
// 16-row steps. It takes the whole-sequence body's steps of
// csrc/attention_qkv_bwd.cu in their order (phase 1: m, l and rd, then
// dq; phase 2: dk and dv), so the ring pair there must give its bits: the
// emulator (emulate.cpp, "chunked_bwd") runs it as the ring pair's bit
// reference. It is the key-chunked backward the card ran at padded
// widths 128 and 256 before the ring pair served them, and is not built
// for the card. Included by emulate.cpp after that source's bf16 kernels,
// whose helpers it uses.
#pragma once

namespace emu_bwd {

constexpr int kChunkedWarps = 4;
constexpr int kChunkedRows = 64;

// Phase 2, one step: dk += dS^T Q and dv += round(P^T) G over the staged
// query rows q0..q0+15 (P^T rounded to bf16, as the forward multiplied V
// by it); 16-row steps at or past npad skipped.
template <int Dp>
__device__ __forceinline__ void key_accumulate(
    float (&dk)[Dp / 8][4], float (&dv)[Dp / 8][4],
    const float (&s)[kBwdTiles][4], const float (&da)[kBwdTiles][4],
    const tc::bf16* qs, const tc::bf16* gs, int q0, int npad, int lane) {
#pragma unroll
  for (int p = 0; p < kBwdTiles / 2; ++p) {
    const int k0 = q0 + 16 * p;
    if (k0 >= npad) continue;
    accumulate_split<Dp>(dk, da[2 * p], da[2 * p + 1], qs, k0, lane);
    const uint32_t pa[1][4] = {{
        tc::pack(s[2 * p][0], s[2 * p][1]),
        tc::pack(s[2 * p][2], s[2 * p][3]),
        tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
        tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
    tc::accumulate<Dp, 1>(dv, pa, gs, k0, lane);
  }
}

// Phase 1: one block per 16 * kChunkedWarps query rows, K and V
// kChunkedRows rows at a time (double-buffered cp.async groups) -> dq and
// the rows' max, 1 / sum and rd in ``stats``.
template <int Dp>
__global__ void __launch_bounds__(kChunkedWarps * 32)
attention_bwd_mma_q_kernel(const Operands<tc::bf16> ops,
                           float* __restrict__ stats, int n, int heads, int d,
                           float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int kRows = 16 * kChunkedWarps;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // kRows rows each
  bf16* gs = qs + kRows * kPad;
  bf16* kv = gs + kRows * kPad;  // 2 buffers of K then V, kChunkedRows rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = tc::pad16(n);
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + 16 * warp;  // this warp's query tile
  const bool active = r0 < npad;
  const bf16* kh = ops.k.head(b, h, d);
  const bf16* vh = ops.v.head(b, h, d);
  const int rows = min(kRows, n - q0);

  tc::stage_rows<Dp>(ops.q.head(b, h, d) + q0 * ops.q.row, ops.q.row, qs,
                     rows, kRows, d);
  tc::stage_rows<Dp>(ops.g.head(b, h, d) + q0 * ops.g.row, ops.g.row, gs,
                     rows, kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();
  constexpr bool kASmem = tc::a_in_smem(Dp);  // Q's, G's fragments per step
  uint32_t qa[kASmem ? 1 : Dp / 16][4], ga[kASmem ? 1 : Dp / 16][4];
  if constexpr (!kASmem) {
    if (active) {
      tc::load_a<Dp>(qa, qs, 16 * warp, lane);
      tc::load_a<Dp>(ga, gs, 16 * warp, lane);
    }
  }

  const int chunks = (n + kChunkedRows - 1) / kChunkedRows;
  auto stage = [&](int c) {
    bf16* kb = kv + (c & 1) * 2 * kChunkedRows * kPad;
    const int k0 = c * kChunkedRows;
    const int cnt = min(kChunkedRows, n - k0);
    tc::stage_rows<Dp>(kh + k0 * ops.k.row, ops.k.row, kb, cnt, kChunkedRows,
                       d);
    tc::stage_rows<Dp>(vh + k0 * ops.v.row, ops.v.row, kb + kChunkedRows * kPad,
                       cnt, kChunkedRows, d);
    tc::cp_async_commit();
  };

  float s[kBwdTiles][4], da[kBwdTiles][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float dq[Dp / 8][4] = {};
  for (int sweep = 0; sweep < 2; ++sweep) {
    stage(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(c + 1);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const bf16* kb = kv + (c & 1) * 2 * kChunkedRows * kPad;
        const bf16* vb = kb + kChunkedRows * kPad;
        const int left = n - c * kChunkedRows;  // keys from the chunk's first
        // the whole-sequence body's 16-key steps, those below n
        for (int key0 = 0; key0 < kChunkedRows && key0 < left; key0 += kStep) {
          if constexpr (kASmem) {
            tc::masked_scores_smem<Dp>(s, qs, 16 * warp, kb, key0, left,
                                       kChunkedRows, scale, lane);
            tc::products_smem<Dp>(da, gs, 16 * warp, vb, key0, kChunkedRows,
                                  lane);
          } else {
            tc::masked_scores<Dp>(s, qa, kb, key0, left, kChunkedRows, scale,
                                  lane);
            tc::products<Dp>(da, ga, vb, key0, kChunkedRows, lane);
          }
          if (sweep == 0) {
            fold_step(s, da, m, l, rd);
          } else {
            query_dscores(s, da, m, inv, rd, scale);
#pragma unroll
            for (int p = 0; p < kBwdTiles / 2; ++p) {
              accumulate_split<Dp>(dq, s[2 * p], s[2 * p + 1], kb,
                                   key0 + 16 * p, lane);
            }
          }
        }
      }
      __syncthreads();  // buffer c % 2 is free for chunk c + 2
    }
    if (sweep == 0) {
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
      rd[0] *= inv[0];
      rd[1] *= inv[1];
    }
  }
  if (active) {
    tc::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
    if (t == 0) {
      float* st = stats_of(stats, b, h, heads, npad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        st[r0 + g + 8 * r] = m[r];
        st[npad + r0 + g + 8 * r] = inv[r];
        st[2 * npad + r0 + g + 8 * r] = rd[r];
      }
    }
  }
}

// Phase 2: one block per 16 * kChunkedWarps key rows, Q, G and the rows'
// statistics kChunkedRows rows at a time -> dk, dv.
template <int Dp>
__global__ void __launch_bounds__(kChunkedWarps * 32 * key_roles(Dp))
attention_bwd_mma_k_kernel(const Operands<tc::bf16> ops,
                           const float* __restrict__ stats, int n, int heads,
                           int d, float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int kRows = 16 * kChunkedWarps;
  constexpr int kBuf = 2 * kChunkedRows * kPad;  // Q then G of one chunk
  constexpr int kRoles = key_roles(Dp);
  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);  // kRows rows each
  bf16* vs = ks + kRows * kPad;
  bf16* qg = vs + kRows * kPad;                  // 2 buffers of kBuf
  float* sts = reinterpret_cast<float*>(qg + 2 * kBuf);  // 2 x 3 kChunkedRows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  // the warp's key tile, and with two roles whether it sums dk (0) or dv
  const int warp = kRoles == 1 ? threadIdx.x >> 5
                               : (threadIdx.x >> 5) % kChunkedWarps;
  const int role = kRoles == 1 ? 0 : (threadIdx.x >> 5) / kChunkedWarps;
  const int npad = tc::pad16(n);
  const int k0 = blockIdx.x * kRows;
  const int c0 = k0 + 16 * warp;  // this warp's key tile
  const bool active = c0 < npad;
  const bf16* qh = ops.q.head(b, h, d);
  const bf16* gh = ops.g.head(b, h, d);
  const float* sh = stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
  const int rows = min(kRows, n - k0);

  tc::stage_rows<Dp>(ops.k.head(b, h, d) + k0 * ops.k.row, ops.k.row, ks,
                     rows, kRows, d);
  tc::stage_rows<Dp>(ops.v.head(b, h, d) + k0 * ops.v.row, ops.v.row, vs,
                     rows, kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();
  uint32_t ka[kRoles == 1 ? Dp / 16 : 1][4], va[kRoles == 1 ? Dp / 16 : 1][4];
  if constexpr (kRoles == 1) {
    if (active) {
      tc::load_a<Dp>(ka, ks, 16 * warp, lane);
      tc::load_a<Dp>(va, vs, 16 * warp, lane);
    }
  }

  const int chunks = (n + kChunkedRows - 1) / kChunkedRows;
  auto stage = [&](int c) {
    bf16* qb = qg + (c & 1) * kBuf;
    float* st = sts + (c & 1) * 3 * kChunkedRows;
    const int q0 = c * kChunkedRows;
    const int cnt = min(kChunkedRows, n - q0);
    tc::stage_rows<Dp>(qh + q0 * ops.q.row, ops.q.row, qb, cnt, kChunkedRows,
                       d);
    tc::stage_rows<Dp>(gh + q0 * ops.g.row, ops.g.row, qb + kChunkedRows * kPad,
                       cnt, kChunkedRows, d);
    tc::cp_async_commit();
    for (int idx = threadIdx.x; idx < 3 * kChunkedRows; idx += blockDim.x) {
      const int w = idx / kChunkedRows, i = idx - w * kChunkedRows;
      st[idx] = q0 + i < npad ? sh[w * npad + q0 + i] : 0.f;
    }
  };

  float s[kBwdTiles][4], da[kBwdTiles][4];
  // with two roles dk holds the warp's one gradient, dk or dv
  float dk[Dp / 8][4] = {}, dv[kRoles == 1 ? Dp / 8 : 1][4] = {};
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* qb = qg + (c & 1) * kBuf;
      const bf16* gb = qb + kChunkedRows * kPad;
      const float* st = sts + (c & 1) * 3 * kChunkedRows;
      const int left = n - c * kChunkedRows;  // queries from the chunk's first
      for (int q0 = 0; q0 < kChunkedRows && q0 < left; q0 += kStep) {
        if constexpr (kRoles == 1) {
          tc::products<Dp>(s, ka, qb, q0, kChunkedRows, lane);   // S^T
          tc::products<Dp>(da, va, gb, q0, kChunkedRows, lane);  // dA^T
          key_pds(s, da, q0, left, st, st + kChunkedRows, st + 2 * kChunkedRows,
                  scale, lane);
          key_accumulate<Dp>(dk, dv, s, da, qb, gb, q0, kChunkedRows, lane);
        } else {
          tc::products_smem<Dp>(s, ks, 16 * warp, qb, q0, kChunkedRows,
                                lane);  // S^T
          if (role == 0) {
            tc::products_smem<Dp>(da, vs, 16 * warp, gb, q0, kChunkedRows,
                                  lane);  // dA^T
          } else {
#pragma unroll
            for (int j = 0; j < kBwdTiles; ++j) {
              da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
            }
          }
          key_pds(s, da, q0, left, st, st + kChunkedRows, st + 2 * kChunkedRows,
                  scale, lane);
#pragma unroll
          for (int p = 0; p < kBwdTiles / 2; ++p) {
            const int k0q = q0 + 16 * p;
            if (k0q >= kChunkedRows) continue;
            if (role == 0) {
              accumulate_split<Dp>(dk, da[2 * p], da[2 * p + 1], qb, k0q,
                                   lane);
            } else {  // P^T rounded to bf16, as the forward multiplied V
              const uint32_t pa[1][4] = {{
                  tc::pack(s[2 * p][0], s[2 * p][1]),
                  tc::pack(s[2 * p][2], s[2 * p][3]),
                  tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
                  tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
              tc::accumulate<Dp, 1>(dk, pa, gb, k0q, lane);
            }
          }
        }
      }
    }
    __syncthreads();  // buffer c % 2 is free for chunk c + 2
  }
  if (active) {
    if constexpr (kRoles == 1) {
      tc::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d,
                         lane);
      tc::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d,
                         lane);
    } else {
      const Operand<bf16>& o = role == 0 ? ops.dk : ops.dv;
      tc::store_rows<Dp>(dk, o.head(b, h, d), o.row, c0, n, d, lane);
    }
  }
}

}  // namespace emu_bwd
