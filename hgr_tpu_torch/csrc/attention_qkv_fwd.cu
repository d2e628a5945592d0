// Fused multi-head attention forward, on the packed qkv projection or on
// q, k and v as three operands.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:51
// (_attention_qkv_kernel, launched by _attention_qkv_impl :85) through
// attention_qkv_fwd, and _split_fwd_impl :294 (the same kernel fed the
// concatenation of three operands) through attention_split_fwd.
//
// What it computes, per image b and head h (D = 32):
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
// Bound on an H100 SXM at the serving shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 19.0 MB (qkv read once, 14.25 MB; out
// written once, 4.75 MB), 5.7 us at 3.35 TB/s, against 1.38 GFLOP for
// the two products, 1.4 us at 989 TFLOP/s. The kernel is memory-bound.
//
// Two bodies, chosen by the compute type.
//
// bf16 (every train and serve path): Hopper's tensor cores through
// mma.sync.aligned.m16n8k16 bf16 -> f32 (attention_mma.cuh). One block per
// (head, image), so K and V are read from device memory once per head.
// The block stages the head's Q, K and V as bf16 rows of 80 bytes (32
// features and 8 of padding, so ldmatrix meets no bank conflict) with
// 16-byte cp.async copies (element by element into the same layout where
// an operand is not 16-byte aligned or its row stride is not a multiple
// of 8), the row count padded to a multiple of 16 with zero rows. Each
// warp owns one 16-row query tile at a time:
//   S = Q K^T by mma into registers, a chunk of 160 keys (80 f32 a
//   thread) at a time; __fmul_rn(., scale); keys at or beyond n at -inf;
//   the row max and sum across the four lanes of a quad by shuffles
//   (with more than one chunk the sum is rescaled when a later chunk
//   raises the max; the output never is);
//   P = exp(s - max) times the rounded reciprocal of the sum (exp on the
//   SFU, softmax_exp), normalised first and then rounded to bf16,
//   repacked from the S accumulators straight into the A fragments of
//   P V, with V's B fragments from ldmatrix.trans: P never touches
//   shared memory;
//   out rounded to bf16 and stored by row stride, pad rows not written.
// At N <= 160 one chunk holds the whole row and S is computed once;
// above, the keys are swept twice (max and sum, then P and P V).
// Shared memory: 240 bytes per padded row (38,400 at N = 145). A
// per-element division and expf cost more than the products here, hence
// the reciprocal and the SFU exp. tools/tune_attention.py times the body
// at other chunk and block sizes.
//
// f32 (the check paths' type; tensor cores could not keep it at its 1e-5
// tolerance without a three-way operand split) keeps the CUDA-core body:
// one block per (row group of 32 queries, head, image). The block stages
// that head's K and V (N x D, widened to f32) into shared memory by
// 16-byte loads; rows are padded to D + 1 floats so that lane j reading
// row j hits 32 distinct banks. Each warp owns one query row at a time:
// lane j computes the scores of keys j, j + 32, ... into the warp's own
// row of shared memory, the warp reduces max and sum with shuffles, and
// lane d then accumulates output feature d over all keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

namespace tc = attn_mma;

constexpr int kHeadDim = 32;             // one lane per output feature
constexpr int kWarps = 8;                // warps per block
constexpr int kRowsPerWarp = 4;          // query rows each warp walks
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kKStride = kHeadDim + 1;   // padded K, V rows (bank conflicts)
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
template <typename T>
struct Operand {
  const T* p;
  int64_t img;
  int64_t row;
  // the head's columns of image b: element (i, d) is at [i * row + d]
  __device__ __forceinline__ const T* head(int b, int h) const {
    return p + b * img + h * kHeadDim;
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const Operand<T> q_op, const Operand<T> k_op,
                     const Operand<T> v_op, T* __restrict__ out, int n,
                     int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                     // n * kKStride each
  float* vs = ks + n * kKStride;
  float* ps = vs + n * kKStride;        // kWarps * n, one row per warp

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * kHeadDim;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* __restrict__ qh = q_op.head(b, h);
  stage_rows(k_op.head(b, h), k_op.row, ks, kKStride, n);
  stage_rows(v_op.head(b, h), v_op.row, vs, kKStride, n);
  __syncthreads();

  float* p = ps + warp * n;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r * kWarps + warp;
    if (i >= n) break;  // uniform across the warp; later rows are larger
    const float q_lane = to_f32(qh[i * q_op.row + lane]);
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = __shfl_sync(kFull, q_lane, d);

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * kKStride;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], kr[d], s);
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
    for (int j = lane; j < n; j += 32) p[j] = to_f32(from_f32<T>(p[j] / sum));
    __syncwarp();

    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * kKStride + lane], acc);
    out[(static_cast<int64_t>(b) * n + i) * hd + h * kHeadDim + lane] =
        from_f32<T>(acc);
    __syncwarp();  // p is rewritten by the warp's next row
  }
}

constexpr int kChunkTiles = 20;  // 8-key C tiles of S in registers
constexpr int kChunk = 8 * kChunkTiles;
// Most warps per block. At its ~160 registers a thread an SM holds 12 of
// this body's warps: blocks of 3 fill it 4 at a time, so the serving
// batch (B = 64, 512 blocks) runs in one wave; at N = 145 the 10 query
// tiles go 4, 3, 3 to the warps.
constexpr int kFwdWarps = 3;

// e^x for the softmax, as 2^(x log2 e) on the SFU. P is rounded to bf16
// (8 bits) right after, so this exp's ~1e-6 relative error moves P across
// a rounding boundary about once in 4,000 values and the output by less
// than its own rounding. (The backward keeps expf: its dS stays in f32.)
__device__ __forceinline__ float softmax_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// The bf16 body: one block per (head, image), one 16-row query tile per
// warp at a time (see the note at the top).
__global__ void __launch_bounds__(tc::kMaxWarps * 32)
attention_fwd_mma_kernel(const Operand<tc::bf16> q_op,
                         const Operand<tc::bf16> k_op,
                         const Operand<tc::bf16> v_op,
                         tc::bf16* __restrict__ out, int n, int heads,
                         float scale) {
  extern __shared__ uint4 smem_tc[];
  const int npad = tc::pad16(n);
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem_tc);
  tc::bf16* ks = qs + npad * tc::kRowPad;
  tc::bf16* vs = ks + npad * tc::kRowPad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t hd = static_cast<int64_t>(heads) * kHeadDim;

  tc::stage_rows(q_op.head(b, h), q_op.row, qs, n, npad);
  tc::stage_rows(k_op.head(b, h), k_op.row, ks, n, npad);
  tc::stage_rows(v_op.head(b, h), v_op.row, vs, n, npad);
  tc::cp_async_wait_all();
  __syncthreads();

  tc::bf16* outh = out + static_cast<int64_t>(b) * n * hd + h * kHeadDim;
  const int chunks = (npad + kChunk - 1) / kChunk;
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    uint32_t qa[2][4];
    tc::load_a(qa, qs, r0, lane);
    float s[kChunkTiles][4];
    // rows g and g + 8 of the tile: max and sum of exp(s - max)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      tc::masked_scores(s, qa, ks, c * kChunk, n, npad, scale, lane);
      float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j) {
        mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
        mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
      }
      mc[0] = tc::quad_max(mc[0]);
      mc[1] = tc::quad_max(mc[1]);
#pragma unroll
      for (int j = 0; j < kChunkTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = softmax_exp(s[j][e] - mc[e >> 1]);
          sum[e >> 1] += x;
          if (chunks == 1) s[j][e] = x;
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

    // P normalised by the rounded reciprocal of the sum
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    float o[4][4] = {};
    for (int c = 0; c < chunks; ++c) {
      const int key0 = c * kChunk;
      if (chunks > 1) {
        tc::masked_scores(s, qa, ks, key0, n, npad, scale, lane);
#pragma unroll
        for (int j = 0; j < kChunkTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = softmax_exp(s[j][e] - m[e >> 1]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kChunkTiles / 2; ++p) {
        const int k0 = key0 + 16 * p;
        if (k0 >= npad) continue;
        // P normalised, then rounded to bf16: the A fragment of P V
        const uint32_t pa[1][4] = {{
            tc::pack(s[2 * p][0] * inv[0], s[2 * p][1] * inv[0]),
            tc::pack(s[2 * p][2] * inv[1], s[2 * p][3] * inv[1]),
            tc::pack(s[2 * p + 1][0] * inv[0], s[2 * p + 1][1] * inv[0]),
            tc::pack(s[2 * p + 1][2] * inv[1], s[2 * p + 1][3] * inv[1])}};
        tc::accumulate(o, pa, vs, k0, lane);
      }
    }
    tc::store_rows(o, outh, hd, r0, n, lane);
  }
}

size_t smem_bytes(int n, int dtype) {
  if (dtype == 1) {
    return sizeof(tc::bf16) * 3 * static_cast<size_t>(tc::pad16(n)) *
           tc::kRowPad;
  }
  return sizeof(float) * static_cast<size_t>(n) * (2 * kKStride + kWarps);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int64_t* strides, void* out, int batch, int n,
                       int heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_mma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  using tc::bf16;
  const Operand<bf16> q_op{static_cast<const bf16*>(q), strides[0],
                           strides[1]};
  const Operand<bf16> k_op{static_cast<const bf16*>(k), strides[2],
                           strides[3]};
  const Operand<bf16> v_op{static_cast<const bf16*>(v), strides[4],
                           strides[5]};
  const dim3 grid(heads, batch);
  const int threads = 32 * tc::warps_for(tc::pad16(n) / 16, kFwdWarps);
  attention_fwd_mma_kernel<<<grid, threads, smem, stream>>>(
      q_op, k_op, v_op, static_cast<bf16*>(out), n, heads, scale);
  return cudaGetLastError();
}

// strides: element strides (image, row) of q, k and v, in that order
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int64_t* strides, void* out, int batch, int n,
                   int heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const Operand<T> q_op{static_cast<const T*>(q), strides[0], strides[1]};
  const Operand<T> k_op{static_cast<const T*>(k), strides[2], strides[3]};
  const Operand<T> v_op{static_cast<const T*>(v), strides[4], strides[5]};
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  attention_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      q_op, k_op, v_op, static_cast<T*>(out), n, heads, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim != kHeadDim || batch < 1 || batch > 65535 || n < 1 ||
         heads < 1 || heads > 65535;
}

int dispatch(const void* q, const void* k, const void* v,
             const int64_t* strides, void* out, int batch, int n, int heads,
             float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(q, k, v, strides, out, batch, n, heads, scale, s));
    case 1:
      return static_cast<int>(
          launch_mma(q, k, v, strides, out, batch, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the body for ``dtype`` (0 = float32,
// 1 = bfloat16) needs at sequence length n, in bytes.
int attention_qkv_fwd_smem_bytes(int n, int dtype) {
  return static_cast<int>(smem_bytes(n, dtype));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller has checked shapes and pointers.
// qkv (B, N, 3*H*D) contiguous -> out (B, N, H*D).
int attention_qkv_fwd(const void* qkv, void* out, int batch, int n, int heads,
                      int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * kHeadDim;
  const int64_t row = 3 * hd;
  const int64_t img = n * row;
  const int64_t strides[6] = {img, row, img, row, img, row};
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  return dispatch(base, base + hd * es, base + 2 * hd * es, strides, out,
                  batch, n, heads, scale, dtype, stream);
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
  return dispatch(q, k, v, strides, out, batch, n, heads, scale, dtype,
                  stream);
}

const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
