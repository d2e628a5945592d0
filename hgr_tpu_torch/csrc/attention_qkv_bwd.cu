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
// What it computes, per image b and head h (any head width D), all in
// f32:
//   s[i, j]  = (q_i . k_j) * scale, P = softmax_j(s)   (recomputed)
//   dA[i, j] = g_i . v_j
//   dS[i, j] = P[i, j] * (dA[i, j] - sum_j dA[i, j] P[i, j]) * scale
//   dq_i = sum_j dS[i, j] k_j          dk_j = sum_i dS[i, j] q_i
//   dv_j = sum_i P^[i, j] g_i,  P^ = P rounded to the compute type T and
//                                    widened back (the forward multiplies
//                                    v by that rounded P, :218-225)
// and writes dq, dk and dv once each, in T. The row sum rd = sum_j dA P
// is taken with the f32, unrounded P, as the Pallas kernel takes it
// (:193-208); it is not FlashAttention's rowsum(dO * O), which would come
// from the rounded P and a rounded O.
//
// One kernel body serves both entry points: every operand (q, k, v, g in;
// dq, dk, dv out) is a base pointer with an image stride and a row stride
// in elements. attention_qkv_bwd passes the packed qkv and the packed
// gradient (B, N, 3*H*D) as three thirds each with row stride 3*H*D;
// attention_split_bwd passes its caller's operands as they are. The two
// entry points compute bit-identical gradients on the same data. Head
// widths above 256 take the column-sliced bodies of attention_wide.cuh
// (three kernels and the chunked route's statistics scratch). Up to 256
// widths are handled as in the forward: bodies templated over the padded
// width Dp in {16, 32, 64, 128, 256}, staged features D..Dp-1 zero, output
// columns beyond D never written. At Dp = 256 every length takes the
// key-chunked route (a warp's A fragments and its 16 x Dp gradient tiles
// do not fit one thread's registers in the whole-sequence bodies): the
// query-tile kernel reads Q's and G's A fragments from shared memory
// (attention_mma.cuh, products_smem) beside its 128 dq accumulators, and
// the key-tile kernel gives each key tile two warps, one summing dk and
// one dv (128 accumulators each, where one warp would need 256); the dv
// warp computes S^T only, the dk warp S^T and dA^T.
//
// Bound on an H100 SXM at the training shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 33.26 MB (qkv 14.25 MB and g 4.75 MB read
// once, the gradient 14.25 MB written once), 9.9 us at 3.35 TB/s, against
// 10 N^2 D H B = 3.44 GFLOP for the five products, 3.5 us at 989 TFLOP/s.
// The kernel is memory-bound.
//
// Two bodies, chosen by the compute type, no atomics anywhere, so the
// result is deterministic, and both in two phases: query rows give dq and
// the rows' softmax statistics (max, sum, rd), then key rows give dk and
// dv from those statistics. While the head's Q, K, V and G fit in one
// block's shared memory (n <= 688 at D = 32 in bf16, n <= 384 in f32),
// both phases run in one block per (head, image) with the statistics in
// shared memory. Past that, the key-chunked route runs the phases as two
// kernels: one over query tiles (dq and the statistics, K and V streamed
// through shared memory in chunks), then one over key tiles (dk and dv, Q,
// G and the statistics streamed likewise); the statistics pass through a
// (B, H, 3, pad16(N)) f32 scratch that the wrapper allocates. Each
// gradient element is still summed by one thread in a fixed order.
//
// bf16 (every train path): Hopper's tensor cores through
// mma.sync.aligned.m16n8k16 bf16 -> f32 (attention_mma.cuh). The block
// stages the head's Q, K, V and G as bf16 rows of (Dp + 8) * 2 bytes with
// 16-byte cp.async copies (element by element where an operand is not
// 16-byte aligned or its row stride or D is not a multiple of 8), the row
// count padded to a multiple of 16 with zero rows: 332 bytes of shared
// memory per padded row at Dp = 32 (53,120 at N = 145). Each warp owns
// one 16-row tile at a time and sweeps the other side 16 rows at a time.
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
// (tools/probe_score_bits.py), so the two phases see the same P. The
// key-chunked kernels take the same 16-row steps in the same order, so
// they compute the same bits as the whole-sequence body would.
//
// f32 (the check paths' type, kept at 1e-4) keeps the CUDA-core body: it
// stages Q, K, V and G (widened to f32, rows padded to Dp + 1 floats so
// that lane j reading row j hits 32 distinct banks) by 16-byte loads;
//   1. query rows, one warp per row: lane j computes s, dA for keys
//      j, j + 32, ...; the warp reduces the softmax max and sum and the
//      row sum of dA P with shuffles; lane f then sums dq_i[f] (features
//      f, f + 32, ...) over the keys. The row's max, sum and dA.P sum go
//      to shared memory.
//   2. key rows, one warp per key j: lane i recomputes s, P and dA for
//      queries i, i + 32, ... from the saved statistics, and lane f sums
//      dk_j[f] and dv_j[f] over the queries. Both phases round the scaled
//      score with __fmul_rn, which nvcc never contracts into the next
//      subtraction, and then take the same instructions in the same
//      order, so P and dS have the same bits in both phases.
// Its key-chunked kernels stage 32 rows of one side and 64 of the other
// at a time; in the query kernel each lane keeps a running max, sum and
// dA-weighted sum over its keys (merged across the warp after the sweep).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

namespace tc = attn_mma;

constexpr int kWarps = 8;               // warps per block (f32 bodies)
constexpr int kRowsPerWarp = 4;         // rows each warp walks (chunked)
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kLongKeys = 64;           // rows per chunk, f32 chunked route
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;   // bytes one H100 block may use

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

// a . b over Dp features (registers or shared memory); the one order
// every phase uses. At Dp = 256 (shared memory only) in unrolled steps of
// 32 features: a full unroll spills.
template <int Dp>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
  if constexpr (Dp > 128) {
#pragma unroll 1
    for (int f0 = 0; f0 < Dp; f0 += 32) {
#pragma unroll
      for (int f = f0; f < f0 + 32; ++f) s = fmaf(a[f], b[f], s);
    }
  } else {
#pragma unroll
    for (int f = 0; f < Dp; ++f) s = fmaf(a[f], b[f], s);
  }
  return s;
}

// Stage n rows of one head (d features, row stride ``row`` elements) into
// shared memory as f32 rows of Dp + 1 floats, features d..Dp-1 zero:
// 16-byte loads when the rows allow them (every layout the callers pass
// in practice), else one element per thread. The staged values are the
// same either way.
template <int Dp>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          int64_t row, float* dst, int n,
                                          int d) {
  constexpr int kS = Dp + 1;
  constexpr int kChunks = Dp / 4;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % 4 == 0 &&
      d % 4 == 0) {
    const int dc = d >> 2;
    for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
      const int j = idx / kChunks;
      const int c = idx - j * kChunks;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < dc) v = *reinterpret_cast<const float4*>(src + j * row + c * 4);
      float* o = dst + j * kS + c * 4;
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  } else {
    for (int idx = threadIdx.x; idx < n * Dp; idx += blockDim.x) {
      const int j = idx / Dp;
      const int f = idx - j * Dp;
      dst[j * kS + f] = f < d ? src[j * row + f] : 0.f;
    }
  }
}

// One (B, N, H*D) operand: element strides between images and rows.
template <typename P>
struct Operand {
  P* p;
  int64_t img;
  int64_t row;
  // the head's columns of image b: element (i, f) is at [i * row + f]
  __device__ __forceinline__ P* head(int b, int h, int d) const {
    return p + b * img + h * d;
  }
};

template <typename T>
struct Operands {
  Operand<const T> q, k, v, g;
  Operand<T> dq, dk, dv;
};

// The lane's first feature: lanes 16..31 repeat lanes 0..15's at Dp = 16
// (and store nothing).
template <int Dp>
__device__ __forceinline__ int first_feature(int lane) {
  return Dp < 32 ? (lane & (Dp - 1)) : lane;
}

// Store a lane's features f0, f0 + 32, ... of one row.
template <int Dp>
__device__ __forceinline__ void store_lane(float* dst, const float* acc,
                                           int f0, int d, int lane) {
#pragma unroll
  for (int t = 0; t < (Dp + 31) / 32; ++t) {
    const int f = f0 + 32 * t;
    if (f < d && (Dp >= 32 || lane < Dp)) dst[f] = acc[t];
  }
}

// The statistics scratch of the key-chunked routes: (B, H, 3, npad) f32,
// the rows' max, sum (f32 body) or 1 / sum (bf16 body), and rd.
__device__ __forceinline__ float* stats_of(float* stats, int b, int h,
                                           int heads, int npad) {
  return stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
}

template <int Dp>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_kernel(const Operands<float> ops, int n, int d, float scale) {
  constexpr int kS = Dp + 1;              // padded row (bank conflicts)
  constexpr int kSlots = (Dp + 31) / 32;  // features per lane
  extern __shared__ float smem[];
  float* qs = smem;                     // n * kS each
  float* ks = qs + n * kS;
  float* vs = ks + n * kS;
  float* gs = vs + n * kS;
  float* row_max = gs + n * kS;         // n each: phase 1 statistics
  float* row_sum = row_max + n;
  float* row_dot = row_sum + n;
  float* scratch = row_dot + n;         // 2 * n per warp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = first_feature<Dp>(lane);

  stage_f32<Dp>(ops.q.head(b, h, d), ops.q.row, qs, n, d);
  stage_f32<Dp>(ops.k.head(b, h, d), ops.k.row, ks, n, d);
  stage_f32<Dp>(ops.v.head(b, h, d), ops.v.row, vs, n, d);
  stage_f32<Dp>(ops.g.head(b, h, d), ops.g.row, gs, n, d);
  float* __restrict__ dqh = ops.dq.head(b, h, d);
  float* __restrict__ dkh = ops.dk.head(b, h, d);
  float* __restrict__ dvh = ops.dv.head(b, h, d);
  __syncthreads();

  float* pa = scratch + warp * 2 * n;  // this warp's two rows
  float* pb = pa + n;
  float a[Dp], c[Dp];

  // ---- phase 1: query rows -> dq, row statistics
  for (int i = warp; i < n; i += kWarps) {
#pragma unroll
    for (int f = 0; f < Dp; ++f) {
      a[f] = qs[i * kS + f];
      c[f] = gs[i * kS + f];
    }
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float s = __fmul_rn(dot<Dp>(a, ks + j * kS), scale);
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
      const float da = dot<Dp>(c, vs + j * kS);
      pa[j] = p;
      pb[j] = da;
      rd += da * p;
    }
    rd = warp_sum(rd);
    for (int j = lane; j < n; j += 32) pb[j] = pa[j] * (pb[j] - rd) * scale;
    __syncwarp();
    float dq[kSlots] = {};
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        dq[t] = fmaf(pb[j], ks[j * kS + f0 + 32 * t], dq[t]);
      }
    }
    store_lane<Dp>(dqh + i * ops.dq.row, dq, f0, d, lane);
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
    const float* kj = ks + j * kS;
    const float* vj = vs + j * kS;
    for (int i = lane; i < n; i += 32) {
#pragma unroll
      for (int f = 0; f < Dp; ++f) {
        a[f] = qs[i * kS + f];
        c[f] = gs[i * kS + f];
      }
      const float s = __fmul_rn(dot<Dp>(a, kj), scale);
      const float p = expf(s - row_max[i]) / row_sum[i];
      const float da = dot<Dp>(c, vj);
      pa[i] = p * (da - row_dot[i]) * scale;
      pb[i] = p;
    }
    __syncwarp();
    float dk[kSlots] = {}, dv[kSlots] = {};
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        dk[t] = fmaf(pa[i], qs[i * kS + f0 + 32 * t], dk[t]);
        dv[t] = fmaf(pb[i], gs[i * kS + f0 + 32 * t], dv[t]);
      }
    }
    store_lane<Dp>(dkh + j * ops.dk.row, dk, f0, d, lane);
    store_lane<Dp>(dvh + j * ops.dv.row, dv, f0, d, lane);
    __syncwarp();
  }
}

// f32 key-chunked route, phase 1: one block per 32 query rows (4 per
// warp), K and V kLongKeys rows at a time -> dq and the rows' max, sum
// and rd in ``stats``. At Dp = 256 one block an SM is asked for: ptxas
// otherwise caps the kernel at 64 registers and spills (0: the narrower
// bodies as they were).
template <int Dp>
__global__ void __launch_bounds__(kWarps * 32, Dp > 128 ? 1 : 0)
attention_bwd_q_kernel(const Operands<float> ops, float* __restrict__ stats,
                       int n, int heads, int d, float scale) {
  constexpr int kS = Dp + 1;
  constexpr int kSlots = (Dp + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;                            // kRowsPerBlock * kS each
  float* gs = qs + kRowsPerBlock * kS;
  float* ks = gs + kRowsPerBlock * kS;         // kLongKeys * kS each
  float* vs = ks + kLongKeys * kS;
  float* ps = vs + kLongKeys * kS;             // kWarps * kLongKeys

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = first_feature<Dp>(lane);
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, n - row0);
  const float* kh = ops.k.head(b, h, d);
  const float* vh = ops.v.head(b, h, d);
  float* p = ps + warp * kLongKeys;

  stage_f32<Dp>(ops.q.head(b, h, d) + row0 * ops.q.row, ops.q.row, qs, rows,
                d);
  stage_f32<Dp>(ops.g.head(b, h, d) + row0 * ops.g.row, ops.g.row, gs, rows,
                d);

  // sweep 1: per lane, over its keys, the running max m, the sum l of
  // exp(s - m) and rd = sum dA exp(s - m), both rescaled as m rises
  float m[kRowsPerWarp], l[kRowsPerWarp], rd[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = rd[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kLongKeys) {
    const int cnt = min(kLongKeys, n - k0);
    __syncthreads();  // the previous chunk is consumed
    stage_f32<Dp>(kh + k0 * ops.k.row, ops.k.row, ks, cnt, d);
    stage_f32<Dp>(vh + k0 * ops.v.row, ops.v.row, vs, cnt, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = r * kWarps + warp;
      if (il >= rows) break;
      for (int j = lane; j < cnt; j += 32) {
        const float s = __fmul_rn(dot<Dp>(qs + il * kS, ks + j * kS), scale);
        const float da = dot<Dp>(gs + il * kS, vs + j * kS);
        if (s > m[r]) {
          const float f = expf(m[r] - s);
          l[r] = l[r] * f + 1.f;
          rd[r] = rd[r] * f + da;
          m[r] = s;
        } else {
          const float e = expf(s - m[r]);
          l[r] += e;
          rd[r] = fmaf(da, e, rd[r]);
        }
      }
    }
  }
  float* st = stats_of(stats, b, h, heads, tc::pad16(n));
  const int npad = tc::pad16(n);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float mr = warp_max(m[r]);
    const float fac = m[r] == -INFINITY ? 0.f : expf(m[r] - mr);
    l[r] = warp_sum(l[r] * fac);
    rd[r] = warp_sum(rd[r] * fac) / l[r];
    m[r] = mr;
    const int il = r * kWarps + warp;
    if (lane == 0 && il < rows) {
      st[row0 + il] = m[r];
      st[npad + row0 + il] = l[r];
      st[2 * npad + row0 + il] = rd[r];
    }
  }

  // sweep 2: dS -> dq
  float dq[kRowsPerWarp][kSlots] = {};
  for (int k0 = 0; k0 < n; k0 += kLongKeys) {
    const int cnt = min(kLongKeys, n - k0);
    __syncthreads();
    stage_f32<Dp>(kh + k0 * ops.k.row, ops.k.row, ks, cnt, d);
    stage_f32<Dp>(vh + k0 * ops.v.row, ops.v.row, vs, cnt, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = r * kWarps + warp;
      if (il >= rows) break;
      for (int j = lane; j < cnt; j += 32) {
        const float s = __fmul_rn(dot<Dp>(qs + il * kS, ks + j * kS), scale);
        const float pj = expf(s - m[r]) / l[r];
        const float da = dot<Dp>(gs + il * kS, vs + j * kS);
        p[j] = pj * (da - rd[r]) * scale;
      }
      __syncwarp();
      for (int j = 0; j < cnt; ++j) {
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          dq[r][t] = fmaf(p[j], ks[j * kS + f0 + 32 * t], dq[r][t]);
        }
      }
      __syncwarp();
    }
  }
  float* dqh = ops.dq.head(b, h, d);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int il = r * kWarps + warp;
    if (il >= rows) break;
    store_lane<Dp>(dqh + (row0 + il) * ops.dq.row, dq[r], f0, d, lane);
  }
}

// f32 key-chunked route, phase 2: one block per 32 key rows (4 per warp),
// Q, G and the rows' statistics kLongKeys rows at a time -> dk, dv.
template <int Dp>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_k_kernel(const Operands<float> ops,
                       const float* __restrict__ stats, int n, int heads,
                       int d, float scale) {
  constexpr int kS = Dp + 1;
  constexpr int kSlots = (Dp + 31) / 32;
  extern __shared__ float smem[];
  float* ks = smem;                            // kRowsPerBlock * kS each
  float* vs = ks + kRowsPerBlock * kS;
  float* qs = vs + kRowsPerBlock * kS;         // kLongKeys * kS each
  float* gs = qs + kLongKeys * kS;
  float* st = gs + kLongKeys * kS;             // 3 * kLongKeys
  float* ps = st + 3 * kLongKeys;              // 2 * kLongKeys per warp

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = first_feature<Dp>(lane);
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, n - row0);
  const int npad = tc::pad16(n);
  const float* qh = ops.q.head(b, h, d);
  const float* gh = ops.g.head(b, h, d);
  const float* sh = stats_of(const_cast<float*>(stats), b, h, heads, npad);
  float* pa = ps + warp * 2 * kLongKeys;
  float* pb = pa + kLongKeys;

  stage_f32<Dp>(ops.k.head(b, h, d) + row0 * ops.k.row, ops.k.row, ks, rows,
                d);
  stage_f32<Dp>(ops.v.head(b, h, d) + row0 * ops.v.row, ops.v.row, vs, rows,
                d);

  float dk[kRowsPerWarp][kSlots] = {}, dv[kRowsPerWarp][kSlots] = {};
  for (int q0 = 0; q0 < n; q0 += kLongKeys) {
    const int cnt = min(kLongKeys, n - q0);
    __syncthreads();
    stage_f32<Dp>(qh + q0 * ops.q.row, ops.q.row, qs, cnt, d);
    stage_f32<Dp>(gh + q0 * ops.g.row, ops.g.row, gs, cnt, d);
    for (int idx = threadIdx.x; idx < 3 * cnt; idx += blockDim.x) {
      const int w = idx / cnt;
      st[w * kLongKeys + idx - w * cnt] = sh[w * npad + q0 + idx - w * cnt];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int jl = r * kWarps + warp;
      if (jl >= rows) break;
      for (int i = lane; i < cnt; i += 32) {
        const float s = __fmul_rn(dot<Dp>(qs + i * kS, ks + jl * kS), scale);
        const float p = expf(s - st[i]) / st[kLongKeys + i];
        const float da = dot<Dp>(gs + i * kS, vs + jl * kS);
        pa[i] = p * (da - st[2 * kLongKeys + i]) * scale;
        pb[i] = p;
      }
      __syncwarp();
      for (int i = 0; i < cnt; ++i) {
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          dk[r][t] = fmaf(pa[i], qs[i * kS + f0 + 32 * t], dk[r][t]);
          dv[r][t] = fmaf(pb[i], gs[i * kS + f0 + 32 * t], dv[r][t]);
        }
      }
      __syncwarp();
    }
  }
  float* dkh = ops.dk.head(b, h, d);
  float* dvh = ops.dv.head(b, h, d);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int jl = r * kWarps + warp;
    if (jl >= rows) break;
    store_lane<Dp>(dkh + (row0 + jl) * ops.dk.row, dk[r], f0, d, lane);
    store_lane<Dp>(dvh + (row0 + jl) * ops.dv.row, dv[r], f0, d, lane);
  }
}

// 8-row C tiles of S and dA a warp holds at a time (16 rows, ~100
// registers a thread at Dp = 32)
constexpr int kBwdTiles = 2;
constexpr int kStep = 8 * kBwdTiles;  // rows of the other side per step
// Most warps per block: 4 blocks of 4 fill an SM's shared memory (53 KB
// each at N = 145) with 16 warps. tools/tune_attention.py times other
// sizes.
constexpr int kBwdWarps = 4;
// bf16 parts that carry dS into the tensor cores (3: all of f32's bits)
constexpr int kSplit = 3;
// Key-chunked route: 16-row tiles (warps) per block, and rows of the other
// side per staged chunk.
constexpr int kLongWarps = 4;
constexpr int kLongRows = 64;
// Warps per key tile in the key-chunked route's key kernel: two at Dp =
// 256 (dk and dv each in a warp of its own), else one (both).
__host__ __device__ constexpr int key_roles(int dp) {
  return tc::a_in_smem(dp) ? 2 : 1;
}

// dS from P, dA and the row's sum rd, in the same instructions in both
// phases
__device__ __forceinline__ float dscore(float p, float da, float rd,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(da, rd)), scale);
}

// acc += X . rows[r0..r0+15] for x (16 x 16, C tiles x0 and x1 of 8
// columns each) in f32, as the sum of the products of its kSplit bf16
// parts
template <int Dp>
__device__ __forceinline__ void accumulate_split(float (&acc)[Dp / 8][4],
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
  tc::accumulate<Dp, kSplit>(acc, a, rows, r0, lane);
}

// Phase 1, one step of keys: fold the step's scores s and dA into the
// running max m, sum l of exp(s - m) and rd = sum dA exp(s - m) of rows
// g and g + 8 (both sums rescaled when the step raises m).
__device__ __forceinline__ void fold_step(const float (&s)[kBwdTiles][4],
                                          const float (&da)[kBwdTiles][4],
                                          float (&m)[2], float (&l)[2],
                                          float (&rd)[2]) {
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
    // every step holds a key below n, so mc is finite; the first
    // step's factor is exp(-inf) = 0
    const float f = expf(m[r] - mc[r]);
    l[r] = l[r] * f + tc::quad_sum(sum[r]);
    rd[r] = rd[r] * f + tc::quad_sum(dot[r]);
    m[r] = mc[r];
  }
}

// Phase 1, second sweep: s becomes dS = P (dA - rd) scale, P = exp(s - m)
// times the rounded reciprocal of l. Keys >= n: P = 0 and dA = 0 (zero V
// rows), so dS = 0.
__device__ __forceinline__ void query_dscores(float (&s)[kBwdTiles][4],
                                              const float (&da)[kBwdTiles][4],
                                              const float (&m)[2],
                                              const float (&inv)[2],
                                              const float (&rd)[2],
                                              float scale) {
#pragma unroll
  for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
      s[j][e] = dscore(p, da[j][e], rd[e >> 1], scale);
    }
  }
}

// Phase 2, one step of queries from q0 on: s (raw K Q^T) becomes P^T and
// da (V G^T) dS^T, from the rows' saved max, 1 / sum and rd (indexed from
// q0 as the step is); queries at or beyond ``limit`` give 0.
__device__ __forceinline__ void key_pds(float (&s)[kBwdTiles][4],
                                        float (&da)[kBwdTiles][4], int q0,
                                        int limit, const float* row_max,
                                        const float* row_inv,
                                        const float* row_dot, float scale,
                                        int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + 8 * j + 2 * t + (e & 1);  // the query
      float p = 0.f, ds = 0.f;
      if (i < limit) {
        p = expf(__fmul_rn(s[j][e], scale) - row_max[i]) * row_inv[i];
        ds = dscore(p, da[j][e], row_dot[i], scale);
      }
      s[j][e] = p;
      da[j][e] = ds;
    }
  }
}

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

// The bf16 body, whole-sequence route (see the note at the top). kD > 0
// fixes the head width at compile time (the model's 32: the staging and
// the stores then fold their width checks away). Its phases are written
// out rather than through the step helpers the chunked kernels share:
// nvcc schedules this form ~5% faster at the model's shapes (timed on the
// card against the helper form, bits equal).
template <int Dp, int kD>
__global__ void __launch_bounds__(tc::kMaxWarps * 32)
attention_bwd_mma_kernel(const Operands<tc::bf16> ops, int n, int d_arg,
                         float scale) {
  const int d = kD > 0 ? kD : d_arg;
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  extern __shared__ uint4 smem_tc[];
  const int npad = tc::pad16(n);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + npad * kPad;
  bf16* vs = ks + npad * kPad;
  bf16* gs = vs + npad * kPad;
  float* row_max = reinterpret_cast<float*>(gs + npad * kPad);
  float* row_inv = row_max + npad;  // 1 / the row's sum
  float* row_dot = row_inv + npad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  tc::stage_rows<Dp>(ops.q.head(b, h, d), ops.q.row, qs, n, npad, d);
  tc::stage_rows<Dp>(ops.k.head(b, h, d), ops.k.row, ks, n, npad, d);
  tc::stage_rows<Dp>(ops.v.head(b, h, d), ops.v.row, vs, n, npad, d);
  tc::stage_rows<Dp>(ops.g.head(b, h, d), ops.g.row, gs, n, npad, d);
  tc::cp_async_wait_all();
  __syncthreads();

  float s[kBwdTiles][4], da[kBwdTiles][4];

  // ---- phase 1: query tiles -> dq, row statistics
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    uint32_t qa[Dp / 16][4], ga[Dp / 16][4];
    tc::load_a<Dp>(qa, qs, r0, lane);
    tc::load_a<Dp>(ga, gs, r0, lane);
    // rows g and g + 8 of the tile: the max m, the sum l of exp(s - m)
    // and rd = sum dA exp(s - m), both rescaled when a later chunk raises
    // m, then rd / l = sum dA P
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          rd[2] = {0.f, 0.f};
    for (int key0 = 0; key0 < npad; key0 += kStep) {
      tc::masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
      tc::products<Dp>(da, ga, vs, key0, npad, lane);
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

    float dq[Dp / 8][4] = {};
    for (int key0 = 0; key0 < npad; key0 += kStep) {
      tc::masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
      tc::products<Dp>(da, ga, vs, key0, npad, lane);
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
        accumulate_split<Dp>(dq, s[2 * p], s[2 * p + 1], ks, key0 + 16 * p,
                             lane);
      }
    }
    tc::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
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
    uint32_t ka[Dp / 16][4], va[Dp / 16][4];
    tc::load_a<Dp>(ka, ks, c0, lane);
    tc::load_a<Dp>(va, vs, c0, lane);
    float dk[Dp / 8][4] = {}, dv[Dp / 8][4] = {};
    for (int q0 = 0; q0 < npad; q0 += kStep) {
      tc::products<Dp>(s, ka, qs, q0, npad, lane);   // S^T
      tc::products<Dp>(da, va, gs, q0, npad, lane);  // dA^T
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
        accumulate_split<Dp>(dk, da[2 * p], da[2 * p + 1], qs, k0, lane);
        // P^T rounded to bf16, as the forward multiplied V by it
        const uint32_t pa[1][4] = {{
            tc::pack(s[2 * p][0], s[2 * p][1]),
            tc::pack(s[2 * p][2], s[2 * p][3]),
            tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
            tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
        tc::accumulate<Dp, 1>(dv, pa, gs, k0, lane);
      }
    }
    tc::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d, lane);
    tc::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d, lane);
  }
}

// bf16 key-chunked route, phase 1: one block per 16 * kLongWarps query
// rows, K and V kLongRows rows at a time (double-buffered cp.async
// groups) -> dq and the rows' max, 1 / sum and rd in ``stats``.
template <int Dp>
__global__ void __launch_bounds__(kLongWarps * 32)
attention_bwd_mma_q_kernel(const Operands<tc::bf16> ops,
                           float* __restrict__ stats, int n, int heads, int d,
                           float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int kRows = 16 * kLongWarps;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // kRows rows each
  bf16* gs = qs + kRows * kPad;
  bf16* kv = gs + kRows * kPad;  // 2 buffers of K then V, kLongRows rows

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

  const int chunks = (n + kLongRows - 1) / kLongRows;
  auto stage = [&](int c) {
    bf16* kb = kv + (c & 1) * 2 * kLongRows * kPad;
    const int k0 = c * kLongRows;
    const int cnt = min(kLongRows, n - k0);
    tc::stage_rows<Dp>(kh + k0 * ops.k.row, ops.k.row, kb, cnt, kLongRows, d);
    tc::stage_rows<Dp>(vh + k0 * ops.v.row, ops.v.row, kb + kLongRows * kPad,
                       cnt, kLongRows, d);
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
        const bf16* kb = kv + (c & 1) * 2 * kLongRows * kPad;
        const bf16* vb = kb + kLongRows * kPad;
        const int left = n - c * kLongRows;  // keys from the chunk's first
        // the whole-sequence body's 16-key steps, those below n
        for (int key0 = 0; key0 < kLongRows && key0 < left; key0 += kStep) {
          if constexpr (kASmem) {
            tc::masked_scores_smem<Dp>(s, qs, 16 * warp, kb, key0, left,
                                       kLongRows, scale, lane);
            tc::products_smem<Dp>(da, gs, 16 * warp, vb, key0, kLongRows,
                                  lane);
          } else {
            tc::masked_scores<Dp>(s, qa, kb, key0, left, kLongRows, scale,
                                  lane);
            tc::products<Dp>(da, ga, vb, key0, kLongRows, lane);
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

// bf16 key-chunked route, phase 2: one block per 16 * kLongWarps key
// rows, Q, G and the rows' statistics kLongRows rows at a time -> dk, dv.
template <int Dp>
__global__ void __launch_bounds__(kLongWarps * 32 * key_roles(Dp))
attention_bwd_mma_k_kernel(const Operands<tc::bf16> ops,
                           const float* __restrict__ stats, int n, int heads,
                           int d, float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int kRows = 16 * kLongWarps;
  constexpr int kBuf = 2 * kLongRows * kPad;  // Q then G of one chunk
  constexpr int kRoles = key_roles(Dp);
  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);  // kRows rows each
  bf16* vs = ks + kRows * kPad;
  bf16* qg = vs + kRows * kPad;                  // 2 buffers of kBuf
  float* sts = reinterpret_cast<float*>(qg + 2 * kBuf);  // 2 x 3 kLongRows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  // the warp's key tile, and with two roles whether it sums dk (0) or dv
  const int warp = kRoles == 1 ? threadIdx.x >> 5
                               : (threadIdx.x >> 5) % kLongWarps;
  const int role = kRoles == 1 ? 0 : (threadIdx.x >> 5) / kLongWarps;
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

  const int chunks = (n + kLongRows - 1) / kLongRows;
  auto stage = [&](int c) {
    bf16* qb = qg + (c & 1) * kBuf;
    float* st = sts + (c & 1) * 3 * kLongRows;
    const int q0 = c * kLongRows;
    const int cnt = min(kLongRows, n - q0);
    tc::stage_rows<Dp>(qh + q0 * ops.q.row, ops.q.row, qb, cnt, kLongRows, d);
    tc::stage_rows<Dp>(gh + q0 * ops.g.row, ops.g.row, qb + kLongRows * kPad,
                       cnt, kLongRows, d);
    tc::cp_async_commit();
    for (int idx = threadIdx.x; idx < 3 * kLongRows; idx += blockDim.x) {
      const int w = idx / kLongRows, i = idx - w * kLongRows;
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
      const bf16* gb = qb + kLongRows * kPad;
      const float* st = sts + (c & 1) * 3 * kLongRows;
      const int left = n - c * kLongRows;  // queries from the chunk's first
      for (int q0 = 0; q0 < kLongRows && q0 < left; q0 += kStep) {
        if constexpr (kRoles == 1) {
          tc::products<Dp>(s, ka, qb, q0, kLongRows, lane);   // S^T
          tc::products<Dp>(da, va, gb, q0, kLongRows, lane);  // dA^T
          key_pds(s, da, q0, left, st, st + kLongRows, st + 2 * kLongRows,
                  scale, lane);
          key_accumulate<Dp>(dk, dv, s, da, qb, gb, q0, kLongRows, lane);
        } else {
          tc::products_smem<Dp>(s, ks, 16 * warp, qb, q0, kLongRows,
                                lane);  // S^T
          if (role == 0) {
            tc::products_smem<Dp>(da, vs, 16 * warp, gb, q0, kLongRows,
                                  lane);  // dA^T
          } else {
#pragma unroll
            for (int j = 0; j < kBwdTiles; ++j) {
              da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
            }
          }
          key_pds(s, da, q0, left, st, st + kLongRows, st + 2 * kLongRows,
                  scale, lane);
#pragma unroll
          for (int p = 0; p < kBwdTiles / 2; ++p) {
            const int k0q = q0 + 16 * p;
            if (k0q >= kLongRows) continue;
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

size_t smem_f32_whole(int n, int dp) {
  return sizeof(float) * static_cast<size_t>(n) *
         (4 * (dp + 1) + 3 + 2 * kWarps);
}

size_t smem_f32_long(int dp) {
  // q kernel: 2 x 32 + 2 x 64 rows and a 64-float row per warp; the k
  // kernel: the same rows, 3 x 64 statistics, two rows per warp
  return sizeof(float) * ((2 * kRowsPerBlock + 2 * kLongKeys) * (dp + 1) +
                          3 * kLongKeys + 2 * kWarps * kLongKeys);
}

size_t smem_mma_whole(int n, int dp) {
  const size_t npad = tc::pad16(n);
  return npad * (4 * tc::row_pad(dp) * sizeof(tc::bf16) + 3 * sizeof(float));
}

size_t smem_mma_long(int dp) {
  // 2 tiles of 16 kLongWarps rows and 2 buffers of 2 kLongRows rows, plus
  // the k kernel's 2 x 3 kLongRows statistics
  return (2 * 16 * kLongWarps + 4 * kLongRows) * tc::row_pad(dp) *
             sizeof(tc::bf16) +
         6 * kLongRows * sizeof(float);
}

// 0: the whole-sequence route, 1: the key-chunked route
int route(int n, int dtype, int dp) {
  if (tc::a_in_smem(dp)) return 1;  // no whole-sequence body there
  const size_t whole = dtype == 1 ? smem_mma_whole(n, dp)
                                  : smem_f32_whole(n, dp);
  return whole <= kSmemLimit ? 0 : 1;
}

size_t smem_bytes(int n, int dtype, int dp) {
  if (route(n, dtype, dp) == 0) {
    return dtype == 1 ? smem_mma_whole(n, dp) : smem_f32_whole(n, dp);
  }
  return dtype == 1 ? smem_mma_long(dp) : smem_f32_long(dp);
}

cudaError_t allow_smem(const void* body, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(body,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
Operands<T> operands(const void* const* ptrs, const int64_t* strides) {
  auto in = [&](int i) {
    return Operand<const T>{static_cast<const T*>(ptrs[i]), strides[2 * i],
                            strides[2 * i + 1]};
  };
  auto out = [&](int i) {
    return Operand<T>{static_cast<T*>(const_cast<void*>(ptrs[i])),
                      strides[2 * i], strides[2 * i + 1]};
  };
  return {in(0), in(1), in(2), in(3), out(4), out(5), out(6)};
}

// Launch the whole-sequence body, or the key-chunked pair (Q then K) with
// the statistics in ``stats``.
template <typename T, int Dp>
cudaError_t launch(const Operands<T>& ops, float* stats, int batch, int n,
                   int heads, int d, float scale, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, tc::bf16>::value;
  constexpr int dtype = kMma ? 1 : 0;
  const size_t smem = smem_bytes(n, dtype, Dp);
  const void *qk, *kk;
  if constexpr (kMma) {
    qk = reinterpret_cast<const void*>(attention_bwd_mma_q_kernel<Dp>);
    kk = reinterpret_cast<const void*>(attention_bwd_mma_k_kernel<Dp>);
  } else {
    qk = reinterpret_cast<const void*>(attention_bwd_q_kernel<Dp>);
    kk = reinterpret_cast<const void*>(attention_bwd_k_kernel<Dp>);
  }
  cudaError_t err;
  if constexpr (!tc::a_in_smem(Dp)) {
    if (route(n, dtype, Dp) == 0) {
      const void* whole;
      if constexpr (kMma) {
        whole = d == Dp ? reinterpret_cast<const void*>(
                              attention_bwd_mma_kernel<Dp, Dp>)
                        : reinterpret_cast<const void*>(
                              attention_bwd_mma_kernel<Dp, 0>);
      } else {
        whole = reinterpret_cast<const void*>(attention_bwd_kernel<Dp>);
      }
      if ((err = allow_smem(whole, smem)) != cudaSuccess) return err;
      const dim3 grid(heads, batch);
      if constexpr (kMma) {
        const int threads =
            32 * tc::warps_for(tc::pad16(n) / 16, kBwdWarps);
        if (d == Dp) {
          attention_bwd_mma_kernel<Dp, Dp><<<grid, threads, smem, stream>>>(
              ops, n, d, scale);
        } else {
          attention_bwd_mma_kernel<Dp, 0><<<grid, threads, smem, stream>>>(
              ops, n, d, scale);
        }
      } else {
        attention_bwd_kernel<Dp><<<grid, kWarps * 32, smem, stream>>>(
            ops, n, d, scale);
      }
      return cudaGetLastError();
    }
  }
  if ((err = allow_smem(qk, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(kk, smem)) != cudaSuccess) return err;
  if constexpr (kMma) {
    const dim3 grid((tc::pad16(n) + 16 * kLongWarps - 1) / (16 * kLongWarps),
                    heads, batch);
    attention_bwd_mma_q_kernel<Dp><<<grid, 32 * kLongWarps, smem, stream>>>(
        ops, stats, n, heads, d, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attention_bwd_mma_k_kernel<Dp>
        <<<grid, 32 * kLongWarps * key_roles(Dp), smem, stream>>>(
            ops, stats, n, heads, d, scale);
  } else {
    const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
    attention_bwd_q_kernel<Dp><<<grid, kWarps * 32, smem, stream>>>(
        ops, stats, n, heads, d, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attention_bwd_k_kernel<Dp><<<grid, kWarps * 32, smem, stream>>>(
        ops, stats, n, heads, d, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* const* ptrs, const int64_t* strides,
                         float* stats, int batch, int n, int heads, int d,
                         float scale, cudaStream_t stream) {
  const Operands<T> ops = operands<T>(ptrs, strides);
  switch (tc::padded_width(d)) {
    case 16:
      return launch<T, 16>(ops, stats, batch, n, heads, d, scale, stream);
    case 32:
      return launch<T, 32>(ops, stats, batch, n, heads, d, scale, stream);
    case 64:
      return launch<T, 64>(ops, stats, batch, n, heads, d, scale, stream);
    case 128:
      return launch<T, 128>(ops, stats, batch, n, heads, d, scale, stream);
    default:
      return launch<T, 256>(ops, stats, batch, n, heads, d, scale, stream);
  }
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim < 1 || batch < 1 || batch > 65535 ||
         n < 1 || heads < 1 || heads > 65535;
}

int dispatch(const void* const* ptrs, const int64_t* strides, void* scratch,
             int batch, int n, int heads, int d, float scale, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(scratch);
  const bool wide = d >= attn_wide::kNarrowest;
  if ((wide || route(n, dtype, tc::padded_width(d)) == 1) &&
      stats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wide && dtype == 0) {
    return static_cast<int>(attn_wide::launch_bwd<float>(
        ptrs, strides, stats, batch, n, heads, d, scale, s));
  }
  if (wide && dtype == 1) {
    return static_cast<int>(attn_wide::launch_bwd<tc::bf16>(
        ptrs, strides, stats, batch, n, heads, d, scale, s));
  }
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_width<float>(
          ptrs, strides, stats, batch, n, heads, d, scale, s));
    case 1:
      return static_cast<int>(launch_width<tc::bf16>(
          ptrs, strides, stats, batch, n, heads, d, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The route the body for ``dtype`` (0 = float32, 1 = bfloat16) takes at
// sequence length n and head width head_dim: 0 = one block per (head,
// image) with the whole sequence in shared memory, 1 = key-chunked (two
// kernels and a statistics scratch), 2 = the column-sliced bodies of head
// widths above 256 (three kernels and the same scratch).
int attention_qkv_bwd_route(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return 2;
  return route(n, dtype, tc::padded_width(head_dim));
}

// Shared memory one block of that route needs, in bytes (static on
// route 2, dynamic on the others).
int attention_qkv_bwd_smem_bytes(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return attn_wide::kBwdSmem;
  return static_cast<int>(smem_bytes(n, dtype, tc::padded_width(head_dim)));
}

// f32 elements of the statistics scratch the launch needs (0 on the
// whole-sequence route): B * H * 3 * pad16(n).
long long attention_qkv_bwd_scratch_floats(int batch, int n, int heads,
                                           int head_dim, int dtype) {
  if (head_dim < attn_wide::kNarrowest &&
      route(n, dtype, tc::padded_width(head_dim)) == 0) {
    return 0;
  }
  return static_cast<long long>(batch) * heads * 3 * tc::pad16(n);
}

// qkv (B, N, 3*H*D) and g (B, N, H*D), contiguous -> the packed gradient
// dqkv (B, N, 3*H*D). dtype: 0 = float32, 1 = bfloat16. scratch: the f32
// statistics scratch (attention_qkv_bwd_scratch_floats; may be null when
// that is 0). Returns cudaGetLastError() after the launches (0 on
// success); the caller has checked shapes and pointers.
int attention_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                      void* scratch, int batch, int n, int heads,
                      int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * head_dim;
  const int64_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* x = static_cast<const char*>(qkv);
  const char* dx = static_cast<const char*>(dqkv);
  const void* ptrs[7] = {x, x + hd * es, x + 2 * hd * es, g,
                         dx, dx + hd * es, dx + 2 * hd * es};
  const int64_t row = 3 * hd, img = n * row;
  const int64_t strides[14] = {img, row, img, row, img, row, n * hd, hd,
                               img, row, img, row, img, row};
  return dispatch(ptrs, strides, scratch, batch, n, heads, head_dim, scale,
                  dtype, stream);
}

// q, k, v, g in and dq, dk, dv out: seven (B, N, H*D) operands with unit
// feature stride, their pointers in ``ptrs`` and their (image, row)
// element strides in ``strides`` (14 values), in that order; scratch as
// for attention_qkv_bwd.
int attention_split_bwd(const void* const* ptrs, const int64_t* strides,
                        void* scratch, int batch, int n, int heads,
                        int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(ptrs, strides, scratch, batch, n, heads, head_dim, scale,
                  dtype, stream);
}

const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
