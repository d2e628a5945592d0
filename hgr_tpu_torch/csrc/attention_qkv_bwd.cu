// Fused multi-head attention backward, on the packed qkv projection or on
// q, k and v as three operands.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:175
// (_attention_qkv_bwd_kernel, launched by _attention_qkv_bwd_impl :233
// from the custom VJP _bwd :398) through attention_qkv_bwd, and
// _split_bwd_impl :302 (the same kernel fed the concatenation of three
// operands, its output cut in three) through attention_split_bwd. It
// differentiates the forward kernel csrc/attention_qkv_fwd.cu as
// executed, from q, k, v and the output cotangent g (B, N, H*D), without
// any saved N x N tensor.
//
// What it computes, per image b and head h (D = 32), all in f32:
//   s[i, j]  = (q_i . k_j) * scale, P = softmax_j(s)   (recomputed)
//   dA[i, j] = g_i . v_j
//   dS[i, j] = P[i, j] * (dA[i, j] - sum_j dA[i, j] P[i, j]) * scale
//   dq_i = sum_j dS[i, j] k_j          dk_j = sum_i dS[i, j] q_i
//   dv_j = sum_i P^[i, j] g_i,  P^ = P rounded to the compute type T and
//                                    widened back (the forward multiplies
//                                    v by that rounded P, :218-225)
// and writes dq, dk and dv once each, in T.
//
// One kernel body serves both entry points: every operand (q, k, v, g in;
// dq, dk, dv out) is a base pointer with an image stride and a row stride
// in elements. attention_qkv_bwd passes the packed qkv and the packed
// gradient (B, N, 3*H*D) as three thirds each with row stride 3*H*D;
// attention_split_bwd passes its caller's operands as they are. The two
// entry points compute bit-identical gradients on the same data.
//
// Bound on an H100 SXM at the training shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 33.26 MB (qkv 14.25 MB and g 4.75 MB read
// once, the gradient 14.25 MB written once), 9.9 us at 3.35 TB/s, against
// 10 N^2 D H B = 3.44 GFLOP for the five products, 3.5 us at 989 TFLOP/s.
// The kernel is memory-bound.
//
// Two bodies, chosen by the compute type, both one block per (head,
// image) with no atomics, so the result is deterministic, and both in two
// phases: query rows give dq and the rows' softmax statistics, then key
// rows give dk and dv from those statistics.
//
// bf16 (every train path): Hopper's tensor cores through
// mma.sync.aligned.m16n8k16 bf16 -> f32 (attention_mma.cuh). The block
// stages the head's Q, K, V and G as bf16 rows of 80 bytes with 16-byte
// cp.async copies (element by element where an operand is not 16-byte
// aligned or its row stride is not a multiple of 8), the row count padded
// to a multiple of 16 with zero rows: 332 bytes of shared memory per
// padded row, linear in N (53,120 at N = 145). Each warp owns one 16-row
// tile at a time and sweeps the other side 16 rows at a time.
//   1. query tile: S = Q K^T (masked at keys >= n) and dA = G V^T; the
//      row max m, the sum l of exp(s - m) and sum dA exp(s - m) in one
//      sweep (the sums rescaled when a later chunk raises m), so
//      rd = sum dA P after it; then, sweeping again, P = exp(s - m) / l
//      (by the rounded reciprocal of l), dS = P (dA - rd) scale and
//      dq = dS K. m, 1 / l and rd go to shared memory.
//   2. key tile: S^T = K Q^T and dA^T = V G^T, P^T from the saved m and
//      1 / l, dS^T likewise, zeroed at query rows >= n (the zero pad rows
//      of Q have a softmax of their own); dk = dS^T Q, dv = round(P^T) G.
// P and dS enter the tensor cores as A fragments repacked from the
// accumulators; K, Q and G (the B operands of dq, dk, dv) through
// ldmatrix.trans. dS is an f32 value that one bf16 would cut to 8 bits;
// it goes in as three bf16 terms (kSplit; each the rounding of what the
// ones before leave out), whose products sum to dS's f32 product within
// an f32 product's own error. Two terms (hi + lo) miss by ~5e-6
// (tests/test_torch_attention.py), enough to flip now and then the bf16
// rounding of a gradient near 1 over a B = 256 batch.
// The bf16 inputs and the rounded P are exact operands. Both phases
// round the scaled score with __fmul_rn and take P and dS by the same
// instructions; the tensor cores give Q K^T and K Q^T the same bits
// (tools/probe_score_bits.py), so the two phases see the same P.
//
// f32 (the check paths' type, kept at 1e-4) keeps the CUDA-core body: it
// stages Q, K, V and G (widened to f32, rows padded to D + 1 floats so
// that lane j reading row j hits 32 distinct banks) by 16-byte loads;
//   1. query rows, one warp per row: lane j computes s, dA for keys
//      j, j + 32, ...; the warp reduces the softmax max and sum and the
//      row sum of dA P with shuffles; lane d then sums dq_i[d] over the
//      keys. The row's max, sum and dA.P sum go to shared memory.
//   2. key rows, one warp per key j: lane i recomputes s, P and dA for
//      queries i, i + 32, ... from the saved statistics, and lane d sums
//      dk_j[d] and dv_j[d] over the queries. Both phases round the scaled
//      score with __fmul_rn, which nvcc never contracts into the next
//      subtraction, and then take the same instructions in the same
//      order, so P and dS have the same bits in both phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

namespace tc = attn_mma;

constexpr int kHeadDim = 32;            // one lane per feature
constexpr int kWarps = 8;               // warps per block
constexpr int kStride = kHeadDim + 1;   // padded row (bank conflicts)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// a . b over D features, a in registers, b a padded shared-memory row;
// the one order both phases use
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Stage n rows of one head (D = 32 features, row stride ``row`` elements)
// into shared memory as f32 rows of ``stride`` floats: 16-byte loads when
// the rows allow them (every layout the callers pass in practice), else
// one element per thread. The staged values are the same either way. With
// ``stride`` = D + 1 the vector path's stores hit 32 distinct banks.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t row, float* dst,
                                           int stride, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kHeadDim / kVec;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % kVec == 0) {
    for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
      const int j = idx / kChunks;
      const int c = (idx - j * kChunks) * kVec;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + j * row + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) dst[j * stride + c + t] = to_f32(e[t]);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * kHeadDim; idx += blockDim.x) {
      const int j = idx / kHeadDim;
      const int d = idx - j * kHeadDim;
      dst[j * stride + d] = to_f32(src[j * row + d]);
    }
  }
}

// One (B, N, H*D) operand: element strides between images and rows.
template <typename P>
struct Operand {
  P* p;
  int64_t img;
  int64_t row;
  // the head's columns of image b: element (i, d) is at [i * row + d]
  __device__ __forceinline__ P* head(int b, int h) const {
    return p + b * img + h * kHeadDim;
  }
};

template <typename T>
struct Operands {
  Operand<const T> q, k, v, g;
  Operand<T> dq, dk, dv;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const Operands<T> ops, int n, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // n * kStride each
  float* ks = qs + n * kStride;
  float* vs = ks + n * kStride;
  float* gs = vs + n * kStride;
  float* row_max = gs + n * kStride;    // n each: phase 1 statistics
  float* row_sum = row_max + n;
  float* row_dot = row_sum + n;
  float* scratch = row_dot + n;         // 2 * n per warp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage_rows(ops.q.head(b, h), ops.q.row, qs, kStride, n);
  stage_rows(ops.k.head(b, h), ops.k.row, ks, kStride, n);
  stage_rows(ops.v.head(b, h), ops.v.row, vs, kStride, n);
  stage_rows(ops.g.head(b, h), ops.g.row, gs, kStride, n);
  T* __restrict__ dqh = ops.dq.head(b, h);
  T* __restrict__ dkh = ops.dk.head(b, h);
  T* __restrict__ dvh = ops.dv.head(b, h);
  __syncthreads();

  float* pa = scratch + warp * 2 * n;  // this warp's two rows
  float* pb = pa + n;
  float a[kHeadDim], c[kHeadDim];

  // ---- phase 1: query rows -> dq, row statistics
  for (int i = warp; i < n; i += kWarps) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      a[d] = qs[i * kStride + d];
      c[d] = gs[i * kStride + d];
    }
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = __fmul_rn(dot(a, ks + j * kStride), scale);
      pa[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) l += expf(pa[j] - m);
    l = warp_sum(l);
    float rd = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pa[j] - m) / l;
      const float da = dot(c, vs + j * kStride);
      pa[j] = p;
      pb[j] = da;
      rd += da * p;
    }
    rd = warp_sum(rd);
    for (int j = lane; j < n; j += 32) pb[j] = pa[j] * (pb[j] - rd) * scale;
    __syncwarp();
    float dq = 0.f;
    for (int j = 0; j < n; ++j) dq = fmaf(pb[j], ks[j * kStride + lane], dq);
    dqh[i * ops.dq.row + lane] = from_f32<T>(dq);
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = l;
      row_dot[i] = rd;
    }
    __syncwarp();  // pa, pb are rewritten by the warp's next row
  }
  __syncthreads();

  // ---- phase 2: key rows -> dk, dv
  for (int j = warp; j < n; j += kWarps) {
    const float* kj = ks + j * kStride;
    const float* vj = vs + j * kStride;
    for (int i = lane; i < n; i += 32) {
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        a[d] = qs[i * kStride + d];
        c[d] = gs[i * kStride + d];
      }
      const float s = __fmul_rn(dot(a, kj), scale);
      const float p = expf(s - row_max[i]) / row_sum[i];
      const float da = dot(c, vj);
      pa[i] = p * (da - row_dot[i]) * scale;
      pb[i] = to_f32(from_f32<T>(p));
    }
    __syncwarp();
    float dk = 0.f, dv = 0.f;
    for (int i = 0; i < n; ++i) {
      dk = fmaf(pa[i], qs[i * kStride + lane], dk);
      dv = fmaf(pb[i], gs[i * kStride + lane], dv);
    }
    dkh[j * ops.dk.row + lane] = from_f32<T>(dk);
    dvh[j * ops.dv.row + lane] = from_f32<T>(dv);
    __syncwarp();
  }
}

// 8-row C tiles of S and dA a warp holds at a time (16 rows, ~100
// registers a thread)
constexpr int kBwdTiles = 2;
// Most warps per block: 4 blocks of 4 fill an SM's shared memory (53 KB
// each at N = 145) with 16 warps. tools/tune_attention.py times other
// sizes.
constexpr int kBwdWarps = 4;
// bf16 parts that carry dS into the tensor cores (3: all of f32's bits)
constexpr int kSplit = 3;

// dS from P, dA and the row's sum rd, in the same instructions in both
// phases
__device__ __forceinline__ float dscore(float p, float da, float rd,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(da, rd)), scale);
}

// acc += X . rows[r0..r0+15] for x (16 x 16, C tiles x0 and x1 of 8
// columns each) in f32, as the sum of the products of its kSplit bf16
// parts
__device__ __forceinline__ void accumulate_split(float (&acc)[4][4],
                                                 const float (&x0)[4],
                                                 const float (&x1)[4],
                                                 const tc::bf16* rows, int r0,
                                                 int lane) {
  uint32_t part[4][kSplit], a[kSplit][4];
  tc::pack_split(x0[0], x0[1], part[0]);
  tc::pack_split(x0[2], x0[3], part[1]);
  tc::pack_split(x1[0], x1[1], part[2]);
  tc::pack_split(x1[2], x1[3], part[3]);
#pragma unroll
  for (int k = 0; k < kSplit; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[k][r] = part[r][k];
  }
  tc::accumulate(acc, a, rows, r0, lane);
}

// The bf16 body (see the note at the top).
__global__ void __launch_bounds__(tc::kMaxWarps * 32)
attention_bwd_mma_kernel(const Operands<tc::bf16> ops, int n, float scale) {
  using tc::bf16;
  extern __shared__ uint4 smem_tc[];
  const int npad = tc::pad16(n);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + npad * tc::kRowPad;
  bf16* vs = ks + npad * tc::kRowPad;
  bf16* gs = vs + npad * tc::kRowPad;
  float* row_max = reinterpret_cast<float*>(gs + npad * tc::kRowPad);
  float* row_inv = row_max + npad;  // 1 / the row's sum
  float* row_dot = row_inv + npad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  tc::stage_rows(ops.q.head(b, h), ops.q.row, qs, n, npad);
  tc::stage_rows(ops.k.head(b, h), ops.k.row, ks, n, npad);
  tc::stage_rows(ops.v.head(b, h), ops.v.row, vs, n, npad);
  tc::stage_rows(ops.g.head(b, h), ops.g.row, gs, n, npad);
  tc::cp_async_wait_all();
  __syncthreads();

  float s[kBwdTiles][4], da[kBwdTiles][4];

  // ---- phase 1: query tiles -> dq, row statistics
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    uint32_t qa[2][4], ga[2][4];
    tc::load_a(qa, qs, r0, lane);
    tc::load_a(ga, gs, r0, lane);
    // rows g and g + 8 of the tile: the max m, the sum l of exp(s - m)
    // and rd = sum dA exp(s - m), both rescaled when a later chunk raises
    // m, then rd / l = sum dA P
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          rd[2] = {0.f, 0.f};
    for (int key0 = 0; key0 < npad; key0 += 8 * kBwdTiles) {
      tc::masked_scores(s, qa, ks, key0, n, npad, scale, lane);
      tc::products(da, ga, vs, key0, npad, lane);
      float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
        mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
        mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
      }
      mc[0] = tc::quad_max(mc[0]);
      mc[1] = tc::quad_max(mc[1]);
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[j][e] - mc[e >> 1]);
          sum[e >> 1] += x;
          dot[e >> 1] = fmaf(da[j][e], x, dot[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every chunk holds a key below n, so mc is finite; the first
        // chunk's factor is exp(-inf) = 0
        const float f = expf(m[r] - mc[r]);
        l[r] = l[r] * f + tc::quad_sum(sum[r]);
        rd[r] = rd[r] * f + tc::quad_sum(dot[r]);
        m[r] = mc[r];
      }
    }
    // P = exp(s - m) * inv: normalised by the rounded reciprocal of l
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    rd[0] *= inv[0];
    rd[1] *= inv[1];

    float dq[4][4] = {};
    for (int key0 = 0; key0 < npad; key0 += 8 * kBwdTiles) {
      tc::masked_scores(s, qa, ks, key0, n, npad, scale, lane);
      tc::products(da, ga, vs, key0, npad, lane);
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys >= n: P = 0 and dA = 0 (zero V rows), so dS = 0
          const float p = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
          s[j][e] = dscore(p, da[j][e], rd[e >> 1], scale);
        }
      }
#pragma unroll
      for (int p = 0; p < kBwdTiles / 2; ++p) {
        if (key0 + 16 * p >= npad) continue;
        accumulate_split(dq, s[2 * p], s[2 * p + 1], ks, key0 + 16 * p,
                         lane);
      }
    }
    tc::store_rows(dq, ops.dq.head(b, h), ops.dq.row, r0, n, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[r0 + g + 8 * r] = m[r];
        row_inv[r0 + g + 8 * r] = inv[r];
        row_dot[r0 + g + 8 * r] = rd[r];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key tiles -> dk, dv
  for (int c0 = 16 * warp; c0 < npad; c0 += 16 * warps) {
    uint32_t ka[2][4], va[2][4];
    tc::load_a(ka, ks, c0, lane);
    tc::load_a(va, vs, c0, lane);
    float dk[4][4] = {}, dv[4][4] = {};
    for (int q0 = 0; q0 < npad; q0 += 8 * kBwdTiles) {
      tc::products(s, ka, qs, q0, npad, lane);   // S^T
      tc::products(da, va, gs, q0, npad, lane);  // dA^T
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + 8 * j + 2 * t + (e & 1);  // the query
          float p = 0.f, ds = 0.f;
          if (i < n) {
            p = expf(__fmul_rn(s[j][e], scale) - row_max[i]) * row_inv[i];
            ds = dscore(p, da[j][e], row_dot[i], scale);
          }
          s[j][e] = p;
          da[j][e] = ds;
        }
      }
#pragma unroll
      for (int p = 0; p < kBwdTiles / 2; ++p) {
        const int k0 = q0 + 16 * p;
        if (k0 >= npad) continue;
        accumulate_split(dk, da[2 * p], da[2 * p + 1], qs, k0, lane);
        // P^T rounded to bf16, as the forward multiplied V by it
        const uint32_t pa[1][4] = {{
            tc::pack(s[2 * p][0], s[2 * p][1]),
            tc::pack(s[2 * p][2], s[2 * p][3]),
            tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
            tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
        tc::accumulate(dv, pa, gs, k0, lane);
      }
    }
    tc::store_rows(dk, ops.dk.head(b, h), ops.dk.row, c0, n, lane);
    tc::store_rows(dv, ops.dv.head(b, h), ops.dv.row, c0, n, lane);
  }
}

size_t smem_bytes(int n, int dtype) {
  if (dtype == 1) {
    const size_t npad = tc::pad16(n);
    return npad * (4 * tc::kRowPad * sizeof(tc::bf16) + 3 * sizeof(float));
  }
  return sizeof(float) * static_cast<size_t>(n) *
         (4 * kStride + 3 + 2 * kWarps);
}

// ptrs: q, k, v, g, dq, dk, dv; strides: their (image, row) element
// strides, in that order (14 values)
template <typename T>
cudaError_t launch(const void* const* ptrs, const int64_t* strides,
                   int batch, int n, int heads, float scale,
                   cudaStream_t stream) {
  // the tensor-core body for bf16, the CUDA-core body for float
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  const size_t smem = smem_bytes(n, kMma ? 1 : 0);
  const void* body;
  if constexpr (kMma) {
    body = reinterpret_cast<const void*>(attention_bwd_mma_kernel);
  } else {
    body = reinterpret_cast<const void*>(attention_bwd_kernel<T>);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        body, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  auto in = [&](int i) {
    return Operand<const T>{static_cast<const T*>(ptrs[i]), strides[2 * i],
                            strides[2 * i + 1]};
  };
  auto out = [&](int i) {
    return Operand<T>{static_cast<T*>(const_cast<void*>(ptrs[i])),
                      strides[2 * i], strides[2 * i + 1]};
  };
  const Operands<T> ops{in(0), in(1), in(2), in(3), out(4), out(5), out(6)};
  const dim3 grid(heads, batch);
  if constexpr (kMma) {
    const int threads = 32 * tc::warps_for(tc::pad16(n) / 16, kBwdWarps);
    attention_bwd_mma_kernel<<<grid, threads, smem, stream>>>(ops, n, scale);
  } else {
    attention_bwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(ops, n,
                                                                   scale);
  }
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim != kHeadDim || batch < 1 || batch > 65535 || n < 1 ||
         heads < 1 || heads > 65535;
}

int dispatch(const void* const* ptrs, const int64_t* strides, int batch,
             int n, int heads, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(ptrs, strides, batch, n, heads, scale, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(ptrs, strides, batch, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the body for ``dtype`` (0 = float32,
// 1 = bfloat16) needs at sequence length n, in bytes.
int attention_qkv_bwd_smem_bytes(int n, int dtype) {
  return static_cast<int>(smem_bytes(n, dtype));
}

// qkv (B, N, 3*H*D) and g (B, N, H*D), contiguous -> the packed gradient
// dqkv (B, N, 3*H*D). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success); the caller has
// checked shapes and pointers.
int attention_qkv_bwd(const void* qkv, const void* g, void* dqkv, int batch,
                      int n, int heads, int head_dim, float scale, int dtype,
                      void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * kHeadDim;
  const int64_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* x = static_cast<const char*>(qkv);
  const char* dx = static_cast<const char*>(dqkv);
  const void* ptrs[7] = {x, x + hd * es, x + 2 * hd * es, g,
                         dx, dx + hd * es, dx + 2 * hd * es};
  const int64_t row = 3 * hd, img = n * row;
  const int64_t strides[14] = {img, row, img, row, img, row, n * hd, hd,
                               img, row, img, row, img, row};
  return dispatch(ptrs, strides, batch, n, heads, scale, dtype, stream);
}

// q, k, v, g in and dq, dk, dv out: seven (B, N, H*D) operands with unit
// feature stride, their pointers in ``ptrs`` and their (image, row)
// element strides in ``strides`` (14 values), in that order.
int attention_split_bwd(const void* const* ptrs, const int64_t* strides,
                        int batch, int n, int heads, int head_dim,
                        float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(ptrs, strides, batch, n, heads, scale, dtype, stream);
}

const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
