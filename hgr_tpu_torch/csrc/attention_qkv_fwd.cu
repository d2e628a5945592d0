// Fused multi-head attention forward, on the packed qkv projection or on
// q, k and v as three operands.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:51
// (_attention_qkv_kernel, launched by _attention_qkv_impl :85) through
// attention_qkv_fwd, and _split_fwd_impl :294 (the same kernel fed the
// concatenation of three operands) through attention_split_fwd.
//
// What it computes, per image b and head h (any head width D):
//   s[i, j] = (q_i . k_j) * scale          q, k widened to f32, f32 dot,
//                                          scale applied after the dot
//   P[i, j] = round_T(exp(s - max_j s) / sum_j exp(s - max_j s))
//                                          f32 max / exp / sum, P rounded
//                                          to the compute type T
//   out[i]  = round_T(sum_j P[i, j] * v_j) f32 accumulation
// reading q, k, v by stride and writing out (B, N, H*D). No N x N tensor
// reaches device memory. One kernel body serves both entry points: each
// operand is a base pointer with an image stride and a row stride (in
// elements), head-major within a row. attention_qkv_fwd passes the packed
// qkv (B, N, 3*H*D) = [q | k | v] as (qkv, qkv + H*D, qkv + 2*H*D) with
// row stride 3*H*D; attention_split_fwd passes three operands of its
// caller's strides (a chunk view of a packed tensor, or contiguous
// tensors) with no copy and no concatenation. The two entry points
// therefore compute bit-identical outputs on the same data.
//
// Head widths above 256 take the column-sliced bodies of
// attention_wide.cuh (route 2). Up to 256, every body is a template over
// the padded width Dp in {16, 32, 64, 128, 256} (the smallest that holds
// D); the true D is a runtime
// value. Staged features D..Dp-1 are zero, so the dot products over Dp
// features equal those over D, and output columns beyond D are never
// written. At Dp = 256 every length takes the key-chunked route: the
// whole-sequence bodies keep a row's or a tile's features in registers
// (the f32 body a query row of Dp floats a lane, the bf16 body Q's A
// fragments beside a 16 x Dp output tile), which do not fit one thread's
// 255 registers at that width, and at N = 145 the bf16 body's Q, K and V
// would not fit one block's shared memory either. The chunked bf16 kernel
// reads Q's A fragments from shared memory there (attention_mma.cuh,
// products_smem) and takes 32 keys a chunk.
//
// Bound on an H100 SXM at the serving shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 19.0 MB (qkv read once, 14.25 MB; out
// written once, 4.75 MB), 5.7 us at 3.35 TB/s, against 1.38 GFLOP for
// the two products, 1.4 us at 989 TFLOP/s. The kernel is memory-bound.
//
// Two bodies, chosen by the compute type, each with two routes, chosen by
// the sequence length: the whole-sequence route stages the head's whole
// K and V (and Q) in one block's shared memory, while it fits (n <= 960
// at D = 32 in bf16, n <= 785 in f32); past that the key-chunked route
// streams K and V through shared memory in chunks and sweeps the keys
// twice: the first sweep takes the row max and the sum of exp(s - max),
// the second recomputes S, normalises P in f32, rounds it and
// accumulates P V. (P is rounded after the normalisation, as the Pallas
// kernel does, so the output cannot be rescaled online.)
//
// bf16 (every train and serve path): Hopper's tensor cores through
// mma.sync.aligned.m16n8k16 bf16 -> f32 (attention_mma.cuh). The
// whole-sequence route is one block per (head, image), so K and V are read
// from device memory once per head. The block stages the head's Q, K and
// V as bf16 rows of (Dp + 8) * 2 bytes (so ldmatrix meets no bank
// conflict) with 16-byte cp.async copies (element by element into the same
// layout where an operand is not 16-byte aligned or its row stride or D
// is not a multiple of 8), the row count padded to a multiple of 16 with
// zero rows. Each warp owns one 16-row query tile at a time:
//   S = Q K^T by mma into registers, a chunk of 160 keys (80 f32 a
//   thread at Dp <= 32; 96 and 48 keys at Dp = 64 and 128) at a time;
//   __fmul_rn(., scale); keys at or beyond n at -inf; the row max and sum
//   across the four lanes of a quad by shuffles (with more than one chunk
//   the sum is rescaled when a later chunk raises the max; the output
//   never is);
//   P = exp(s - max) times the rounded reciprocal of the sum (exp on the
//   SFU, softmax_exp), normalised first and then rounded to bf16,
//   repacked from the S accumulators straight into the A fragments of
//   P V, with V's B fragments from ldmatrix.trans: P never touches
//   shared memory;
//   out rounded to bf16 and stored by row stride, pad rows not written.
// At N <= 160 one chunk holds the whole row and S is computed once;
// above, the keys are swept twice (max and sum, then P and P V).
// Shared memory: 3 (Dp + 8) * 2 bytes per padded row (38,400 at N = 145,
// Dp = 32). The key-chunked route is one block per 64 queries (four warps,
// a 16-row tile each), their Q staged once, and the keys' register chunk
// staged as one shared-memory chunk of K (and V in the second sweep),
// double-buffered by cp.async groups so that chunk c + 1 loads while
// chunk c is computed; the per-row arithmetic is the whole-sequence
// route's, in the same order. A per-element division and expf cost more
// than the products here, hence the reciprocal and the SFU exp.
// tools/tune_attention.py times the body at other chunk and block sizes.
//
// f32 (the check paths' type; tensor cores could not keep it at its 1e-5
// tolerance without a three-way operand split) keeps the CUDA-core body:
// one block per (row group of 32 queries, head, image). The block stages
// that head's K and V (N x Dp, widened to f32) into shared memory by
// 16-byte loads; rows are padded to Dp + 1 floats so that lane j reading
// row j hits 32 distinct banks. Each warp owns one query row at a time:
// lane j computes the scores of keys j, j + 32, ... into the warp's own
// row of shared memory, the warp reduces max and sum with shuffles, and
// lane f then accumulates output features f, f + 32, ... (Dp / 32 of them;
// at Dp = 16 lanes 16..31 idle) over all keys. Its key-chunked route
// stages the block's 32 query rows and 64 keys at a time; each lane keeps
// a running max and sum over its keys in the first sweep (merged across
// the warp after it), and the second sweep writes the chunk's normalised
// P to the warp's row and accumulates P V as above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "attention_wide.cuh"

namespace {

namespace tc = attn_mma;

constexpr int kWarps = 8;                // warps per block (f32 bodies)
constexpr int kRowsPerWarp = 4;          // query rows each warp walks
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kLongKeys = 64;            // keys per chunk, f32 chunked route
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;    // bytes one H100 block may use

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

// Stage n rows of one head (d features, row stride ``row`` elements) into
// shared memory as f32 rows of Dp + 1 floats, features d..Dp-1 zero:
// 16-byte loads when the rows allow them (every layout the callers pass
// in practice), else one element per thread. The staged values are the
// same either way. At Dp + 1 floats a row the vector path's stores hit
// 32 distinct banks.
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

// a . b over Dp features, both rows in shared memory; at Dp = 256 in
// unrolled steps of 32 features (a full unroll spills)
template <int Dp>
__device__ __forceinline__ float dot_smem(const float* a, const float* b) {
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

// One (B, N, H*D) operand: element strides between images and rows.
template <typename T>
struct Operand {
  const T* p;
  int64_t img;
  int64_t row;
  // the head's columns of image b: element (i, f) is at [i * row + f]
  __device__ __forceinline__ const T* head(int b, int h, int d) const {
    return p + b * img + h * d;
  }
};

// The lane's first output feature: lanes 16..31 repeat lanes 0..15's at
// Dp = 16 (and store nothing).
template <int Dp>
__device__ __forceinline__ int first_feature(int lane) {
  return Dp < 32 ? (lane & (Dp - 1)) : lane;
}

template <int Dp>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const Operand<float> q_op, const Operand<float> k_op,
                     const Operand<float> v_op, float* __restrict__ out,
                     int n, int heads, int d, float scale) {
  constexpr int kS = Dp + 1;               // padded K, V rows (banks)
  constexpr int kSlots = (Dp + 31) / 32;   // output features per lane
  extern __shared__ float smem[];
  float* ks = smem;                     // n * kS each
  float* vs = ks + n * kS;
  float* ps = vs + n * kS;              // kWarps * n, one row per warp

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = first_feature<Dp>(lane);

  const float* __restrict__ qh = q_op.head(b, h, d);
  stage_f32<Dp>(k_op.head(b, h, d), k_op.row, ks, n, d);
  stage_f32<Dp>(v_op.head(b, h, d), v_op.row, vs, n, d);
  __syncthreads();

  float* p = ps + warp * n;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r * kWarps + warp;
    if (i >= n) break;  // uniform across the warp; later rows are larger
    float q_lane[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int f = f0 + 32 * t;
      q_lane[t] = f < d ? qh[i * q_op.row + f] : 0.f;
    }
    float q[Dp];
#pragma unroll
    for (int f = 0; f < Dp; ++f) {
      q[f] = __shfl_sync(kFull, q_lane[f >> 5], f & 31);
    }

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * kS;
      float s = 0.f;
#pragma unroll
      for (int f = 0; f < Dp; ++f) s = fmaf(q[f], kr[f], s);
      s *= scale;
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) p[j] = p[j] / sum;
    __syncwarp();

    float acc[kSlots] = {};
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        acc[t] = fmaf(p[j], vs[j * kS + f0 + 32 * t], acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int f = f0 + 32 * t;
      if (f < d && (Dp >= 32 || lane < Dp)) {
        out[(static_cast<int64_t>(b) * n + i) * hd + h * d + f] = acc[t];
      }
    }
    __syncwarp();  // p is rewritten by the warp's next row
  }
}

// The f32 key-chunked route (see the note at the top): one block per 32
// query rows, the keys kLongKeys at a time.
template <int Dp>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_long_kernel(const Operand<float> q_op,
                          const Operand<float> k_op,
                          const Operand<float> v_op,
                          float* __restrict__ out, int n, int heads, int d,
                          float scale) {
  constexpr int kS = Dp + 1;
  constexpr int kSlots = (Dp + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;                           // kRowsPerBlock * kS
  float* ks = qs + kRowsPerBlock * kS;        // kLongKeys * kS each
  float* vs = ks + kLongKeys * kS;
  float* ps = vs + kLongKeys * kS;            // kWarps * kLongKeys

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = first_feature<Dp>(lane);
  const int row0 = blockIdx.x * kRowsPerBlock;
  const float* kh = k_op.head(b, h, d);
  const float* vh = v_op.head(b, h, d);
  float* p = ps + warp * kLongKeys;

  stage_f32<Dp>(q_op.head(b, h, d) + row0 * q_op.row, q_op.row, qs,
                min(kRowsPerBlock, n - row0), d);

  // sweep 1: each lane's running max and sum of exp(s - max) over its keys
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kLongKeys) {
    const int cnt = min(kLongKeys, n - k0);
    __syncthreads();  // the previous chunk is consumed (Q staged, first)
    stage_f32<Dp>(kh + k0 * k_op.row, k_op.row, ks, cnt, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = r * kWarps + warp;
      if (row0 + il >= n) break;
      for (int j = lane; j < cnt; j += 32) {
        const float s = dot_smem<Dp>(qs + il * kS, ks + j * kS) * scale;
        if (s > m[r]) {
          l[r] = l[r] * expf(m[r] - s) + 1.f;
          m[r] = s;
        } else {
          l[r] += expf(s - m[r]);
        }
      }
    }
  }
  // the rows' max and sum across the warp
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float mr = warp_max(m[r]);
    l[r] = warp_sum(m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mr));
    m[r] = mr;
  }

  // sweep 2: P normalised in f32, then P V
  float acc[kRowsPerWarp][kSlots] = {};
  for (int k0 = 0; k0 < n; k0 += kLongKeys) {
    const int cnt = min(kLongKeys, n - k0);
    __syncthreads();
    stage_f32<Dp>(kh + k0 * k_op.row, k_op.row, ks, cnt, d);
    stage_f32<Dp>(vh + k0 * v_op.row, v_op.row, vs, cnt, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = r * kWarps + warp;
      if (row0 + il >= n) break;
      for (int j = lane; j < cnt; j += 32) {
        const float s = dot_smem<Dp>(qs + il * kS, ks + j * kS) * scale;
        p[j] = expf(s - m[r]) / l[r];
      }
      __syncwarp();
      for (int j = 0; j < cnt; ++j) {
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          acc[r][t] = fmaf(p[j], vs[j * kS + f0 + 32 * t], acc[r][t]);
        }
      }
      __syncwarp();  // p is rewritten by the warp's next row
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r * kWarps + warp;
    if (i >= n) break;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int f = f0 + 32 * t;
      if (f < d && (Dp >= 32 || lane < Dp)) {
        out[(static_cast<int64_t>(b) * n + i) * hd + h * d + f] = acc[r][t];
      }
    }
  }
}

constexpr int kChunkTiles = 20;  // 8-key C tiles of S in registers, Dp <= 32
// ... and at wider heads, where the A fragments and the output take more
// registers (the chunk stays a multiple of 16 keys)
__host__ __device__ constexpr int chunk_tiles_for(int dp) {
  return dp <= 32 ? kChunkTiles : dp == 64 ? 12 : dp == 128 ? 6 : 4;
}
template <int Dp>
__host__ __device__ constexpr int chunk_tiles() {
  return chunk_tiles_for(Dp);
}
// Most warps per block. At its ~160 registers a thread an SM holds 12 of
// this body's warps: blocks of 3 fill it 4 at a time, so the serving
// batch (B = 64, 512 blocks) runs in one wave; at N = 145 the 10 query
// tiles go 4, 3, 3 to the warps.
constexpr int kFwdWarps = 3;
// Warps (16-row query tiles) per block of the key-chunked route.
constexpr int kLongWarps = 4;

// e^x for the softmax, as 2^(x log2 e) on the SFU. P is rounded to bf16
// (8 bits) right after, so this exp's ~1e-6 relative error moves P across
// a rounding boundary about once in 4,000 values and the output by less
// than its own rounding. (The backward keeps expf: its dS stays in f32.)
__device__ __forceinline__ float softmax_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Rows g and g + 8 of a query tile: fold one chunk's scores ``s`` into the
// running max m and sum l of exp(s - m) (the sum rescaled when the chunk
// raises the max). With ``keep`` s becomes exp(s - max).
template <int NT>
__device__ __forceinline__ void fold_chunk(float (&s)[NT][4], float (&m)[2],
                                           float (&l)[2], bool keep) {
  float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
    mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
  }
  mc[0] = tc::quad_max(mc[0]);
  mc[1] = tc::quad_max(mc[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = softmax_exp(s[j][e] - mc[e >> 1]);
      sum[e >> 1] += x;
      if (keep) s[j][e] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every chunk holds a key below n, so mc is finite; the first
    // chunk's factor is exp(-inf) = 0
    l[r] = l[r] * softmax_exp(m[r] - mc[r]) + tc::quad_sum(sum[r]);
    m[r] = mc[r];
  }
}

template <int NT>
__device__ __forceinline__ void exp_scores(float (&s)[NT][4],
                                           const float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = softmax_exp(s[j][e] - m[e >> 1]);
  }
}

// o += round(P) V over one chunk of keys from key0 on: P = e * inv from the
// exp'd scores e, normalised and then rounded to bf16 as the A fragments
// of the product; 16-key steps at or past npad skipped.
template <int Dp, int NT>
__device__ __forceinline__ void accumulate_pv(float (&o)[Dp / 8][4],
                                              const float (&s)[NT][4],
                                              const float (&inv)[2],
                                              const tc::bf16* vs, int key0,
                                              int npad, int lane) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    const int k0 = key0 + 16 * p;
    if (k0 >= npad) continue;
    const uint32_t pa[1][4] = {{
        tc::pack(s[2 * p][0] * inv[0], s[2 * p][1] * inv[0]),
        tc::pack(s[2 * p][2] * inv[1], s[2 * p][3] * inv[1]),
        tc::pack(s[2 * p + 1][0] * inv[0], s[2 * p + 1][1] * inv[0]),
        tc::pack(s[2 * p + 1][2] * inv[1], s[2 * p + 1][3] * inv[1])}};
    tc::accumulate<Dp, 1>(o, pa, vs, k0, lane);
  }
}

// The bf16 body: one block per (head, image), one 16-row query tile per
// warp at a time (see the note at the top). kD > 0 fixes the head width at
// compile time (the model's 32); the bounds ask for 12 warps an SM (the
// compiler otherwise takes ~226 registers and 9).
template <int Dp, int kD>
__global__ void __launch_bounds__(32 * kFwdWarps, 12 / kFwdWarps)
attention_fwd_mma_kernel(const Operand<tc::bf16> q_op,
                         const Operand<tc::bf16> k_op,
                         const Operand<tc::bf16> v_op,
                         tc::bf16* __restrict__ out, int n, int heads,
                         int d_arg, float scale) {
  const int d = kD > 0 ? kD : d_arg;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  extern __shared__ uint4 smem_tc[];
  const int npad = tc::pad16(n);
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_tc);
  tc::bf16* ks = qs + npad * kPad;
  tc::bf16* vs = ks + npad * kPad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t hd = static_cast<int64_t>(heads) * d;

  tc::stage_rows<Dp>(q_op.head(b, h, d), q_op.row, qs, n, npad, d);
  tc::stage_rows<Dp>(k_op.head(b, h, d), k_op.row, ks, n, npad, d);
  tc::stage_rows<Dp>(v_op.head(b, h, d), v_op.row, vs, n, npad, d);
  tc::cp_async_wait_all();
  __syncthreads();

  tc::bf16* outh = out + static_cast<int64_t>(b) * n * hd + h * d;
  const int chunks = (npad + kChunk - 1) / kChunk;
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    uint32_t qa[Dp / 16][4];
    tc::load_a<Dp>(qa, qs, r0, lane);
    float s[NT][4];
    // rows g and g + 8 of the tile: max and sum of exp(s - max)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      tc::masked_scores<Dp>(s, qa, ks, c * kChunk, n, npad, scale, lane);
      fold_chunk(s, m, l, chunks == 1);
    }

    // P normalised by the rounded reciprocal of the sum
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    float o[Dp / 8][4] = {};
    for (int c = 0; c < chunks; ++c) {
      const int key0 = c * kChunk;
      if (chunks > 1) {
        tc::masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
        exp_scores(s, m);
      }
      accumulate_pv<Dp>(o, s, inv, vs, key0, npad, lane);
    }
    tc::store_rows<Dp>(o, outh, hd, r0, n, d, lane);
  }
}

// The bf16 key-chunked route: one block per 16 * kLongWarps queries, K
// and V through shared memory a register chunk at a time (see the note at
// the top).
template <int Dp>
__global__ void __launch_bounds__(kLongWarps * 32)
attention_fwd_mma_long_kernel(const Operand<tc::bf16> q_op,
                              const Operand<tc::bf16> k_op,
                              const Operand<tc::bf16> v_op,
                              tc::bf16* __restrict__ out, int n, int heads,
                              int d, float scale) {
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  constexpr int kRows = 16 * kLongWarps;
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

size_t smem_f32_whole(int n, int dp) {
  return sizeof(float) * static_cast<size_t>(n) * (2 * (dp + 1) + kWarps);
}

size_t smem_f32_long(int dp) {
  return sizeof(float) * ((kRowsPerBlock + 2 * kLongKeys) * (dp + 1) +
                          kWarps * kLongKeys);
}

size_t smem_mma_whole(int n, int dp) {
  return sizeof(tc::bf16) * 3 * static_cast<size_t>(tc::pad16(n)) *
         tc::row_pad(dp);
}

size_t smem_mma_long(int dp) {
  const int chunk = 8 * chunk_tiles_for(dp);
  return sizeof(tc::bf16) * (16 * kLongWarps + 4 * chunk) * tc::row_pad(dp);
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
struct Operands3 {
  Operand<T> q, k, v;
};

template <typename T>
Operands3<T> operands(const void* q, const void* k, const void* v,
                      const int64_t* strides) {
  return {{static_cast<const T*>(q), strides[0], strides[1]},
          {static_cast<const T*>(k), strides[2], strides[3]},
          {static_cast<const T*>(v), strides[4], strides[5]}};
}

template <int Dp>
cudaError_t launch_mma(const Operands3<tc::bf16>& ops, void* out, int batch,
                       int n, int heads, int d, float scale,
                       cudaStream_t stream) {
  using tc::bf16;
  bf16* o = static_cast<bf16*>(out);
  const size_t smem = smem_bytes(n, 1, Dp);
  if constexpr (!tc::a_in_smem(Dp)) {
    if (route(n, 1, Dp) == 0) {
      const void* body =
          d == Dp ? reinterpret_cast<const void*>(
                        attention_fwd_mma_kernel<Dp, Dp>)
                  : reinterpret_cast<const void*>(
                        attention_fwd_mma_kernel<Dp, 0>);
      const cudaError_t err = allow_smem(body, smem);
      if (err != cudaSuccess) return err;
      const int threads = 32 * tc::warps_for(tc::pad16(n) / 16, kFwdWarps);
      const dim3 grid(heads, batch);
      if (d == Dp) {
        attention_fwd_mma_kernel<Dp, Dp><<<grid, threads, smem, stream>>>(
            ops.q, ops.k, ops.v, o, n, heads, d, scale);
      } else {
        attention_fwd_mma_kernel<Dp, 0><<<grid, threads, smem, stream>>>(
            ops.q, ops.k, ops.v, o, n, heads, d, scale);
      }
      return cudaGetLastError();
    }
  }
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(attention_fwd_mma_long_kernel<Dp>), smem);
  if (err != cudaSuccess) return err;
  const int blocks = (tc::pad16(n) + 16 * kLongWarps - 1) / (16 * kLongWarps);
  attention_fwd_mma_long_kernel<Dp><<<dim3(blocks, heads, batch),
                                      32 * kLongWarps, smem, stream>>>(
      ops.q, ops.k, ops.v, o, n, heads, d, scale);
  return cudaGetLastError();
}

template <int Dp>
cudaError_t launch_f32(const Operands3<float>& ops, void* out, int batch,
                       int n, int heads, int d, float scale,
                       cudaStream_t stream) {
  float* o = static_cast<float*>(out);
  const size_t smem = smem_bytes(n, 0, Dp);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  if constexpr (!tc::a_in_smem(Dp)) {
    if (route(n, 0, Dp) == 0) {
      const cudaError_t err = allow_smem(
          reinterpret_cast<const void*>(attention_fwd_kernel<Dp>), smem);
      if (err != cudaSuccess) return err;
      attention_fwd_kernel<Dp><<<grid, kWarps * 32, smem, stream>>>(
          ops.q, ops.k, ops.v, o, n, heads, d, scale);
      return cudaGetLastError();
    }
  }
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(attention_fwd_long_kernel<Dp>), smem);
  if (err != cudaSuccess) return err;
  attention_fwd_long_kernel<Dp><<<grid, kWarps * 32, smem, stream>>>(
      ops.q, ops.k, ops.v, o, n, heads, d, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim < 1 || batch < 1 || batch > 65535 ||
         n < 1 || heads < 1 || heads > 65535;
}

// strides: element strides (image, row) of q, k and v, in that order
int dispatch(const void* q, const void* k, const void* v,
             const int64_t* strides, void* out, int batch, int n, int heads,
             int d, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d >= attn_wide::kNarrowest) {
    if (dtype == 1) {
      err = attn_wide::launch_fwd<tc::bf16>(q, k, v, strides, out, batch, n,
                                            heads, d, scale, s);
    } else if (dtype == 0) {
      err = attn_wide::launch_fwd<float>(q, k, v, strides, out, batch, n,
                                         heads, d, scale, s);
    }
  } else if (dtype == 1) {
    const auto ops = operands<tc::bf16>(q, k, v, strides);
    switch (tc::padded_width(d)) {
      case 16: err = launch_mma<16>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 32: err = launch_mma<32>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 64: err = launch_mma<64>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 128:
        err = launch_mma<128>(ops, out, batch, n, heads, d, scale, s);
        break;
      default:
        err = launch_mma<256>(ops, out, batch, n, heads, d, scale, s);
    }
  } else if (dtype == 0) {
    const auto ops = operands<float>(q, k, v, strides);
    switch (tc::padded_width(d)) {
      case 16: err = launch_f32<16>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 32: err = launch_f32<32>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 64: err = launch_f32<64>(ops, out, batch, n, heads, d, scale, s);
        break;
      case 128:
        err = launch_f32<128>(ops, out, batch, n, heads, d, scale, s);
        break;
      default:
        err = launch_f32<256>(ops, out, batch, n, heads, d, scale, s);
    }
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The route the body for ``dtype`` (0 = float32, 1 = bfloat16) takes at
// sequence length n and head width head_dim: 0 = the whole sequence in
// one block's shared memory, 1 = key-chunked, 2 = the column-sliced body
// of head widths above 256.
int attention_qkv_fwd_route(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return 2;
  return route(n, dtype, tc::padded_width(head_dim));
}

// Shared memory one block of that route needs, in bytes (static on
// route 2, dynamic on the others).
int attention_qkv_fwd_smem_bytes(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return attn_wide::kFwdSmem;
  return static_cast<int>(smem_bytes(n, dtype, tc::padded_width(head_dim)));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller has checked shapes and pointers.
// qkv (B, N, 3*H*D) contiguous -> out (B, N, H*D).
int attention_qkv_fwd(const void* qkv, void* out, int batch, int n, int heads,
                      int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * head_dim;
  const int64_t row = 3 * hd;
  const int64_t img = n * row;
  const int64_t strides[6] = {img, row, img, row, img, row};
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  return dispatch(base, base + hd * es, base + 2 * hd * es, strides, out,
                  batch, n, heads, head_dim, scale, dtype, stream);
}

// q, k, v: three (B, N, H*D) operands with unit feature stride and the
// element strides (image, row) of q, k, v in ``strides`` (6 values) ->
// out (B, N, H*D) contiguous.
int attention_split_fwd(const void* q, const void* k, const void* v,
                        const int64_t* strides, void* out, int batch, int n,
                        int heads, int head_dim, float scale, int dtype,
                        void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(q, k, v, strides, out, batch, n, heads, head_dim, scale,
                  dtype, stream);
}

const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
