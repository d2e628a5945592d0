// Fused multi-head attention backward on the packed qkv projection.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:175
// (_attention_qkv_bwd_kernel, launched by _attention_qkv_bwd_impl :233
// from the custom VJP _bwd :398). It differentiates the forward kernel
// csrc/attention_qkv_fwd.cu as executed, from qkv (B, N, 3*H*D) and the
// output cotangent g (B, N, H*D), without any saved N x N tensor.
//
// What it computes, per image b and head h (D = 32), all in f32:
//   s[i, j]  = (q_i . k_j) * scale, P = softmax_j(s)   (recomputed)
//   dA[i, j] = g_i . v_j
//   dS[i, j] = P[i, j] * (dA[i, j] - sum_j dA[i, j] P[i, j]) * scale
//   dq_i = sum_j dS[i, j] k_j          dk_j = sum_i dS[i, j] q_i
//   dv_j = sum_i P^[i, j] g_i,  P^ = P rounded to the compute type T and
//                                    widened back (the forward multiplies
//                                    v by that rounded P, :218-225)
// and writes dq | dk | dv once each into the packed (B, N, 3*H*D)
// gradient, in T.
//
// Bound on an H100 SXM at the training shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 33.26 MB (qkv 14.25 MB and g 4.75 MB read
// once, the gradient 14.25 MB written once), 9.9 us at 3.35 TB/s, against
// 10 N^2 D H B = 3.44 GFLOP for the five products, 3.5 us at 989 TFLOP/s.
// The kernel is memory-bound.
//
// Design (simple first): one block per (head, image), which stages that
// head's Q, K, V and G (N x D, widened to f32, rows padded to D + 1
// floats so that lane j reading row j hits 32 distinct banks) into
// shared memory by stride from the packed rows. Two phases, no atomics,
// so the result is deterministic:
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
// All five products run on the CUDA cores in f32. Left for later:
// tensor-core tiles (mma.sync, then wgmma) for the products, and
// 16-byte vector loads of the packed rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_qkv_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                         T* __restrict__ dqkv, int n, int heads,
                         float scale) {
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
  const int hd = heads * kHeadDim;
  const int64_t row_stride = 3 * static_cast<int64_t>(hd);
  const T* img = qkv + static_cast<int64_t>(b) * n * row_stride;
  const T* gimg = g + static_cast<int64_t>(b) * n * hd;
  T* out = dqkv + static_cast<int64_t>(b) * n * row_stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < n * kHeadDim; idx += blockDim.x) {
    const int j = idx / kHeadDim;
    const int d = idx - j * kHeadDim;
    const T* src = img + j * row_stride + h * kHeadDim + d;
    qs[j * kStride + d] = to_f32(src[0]);
    ks[j * kStride + d] = to_f32(src[hd]);
    vs[j * kStride + d] = to_f32(src[2 * hd]);
    gs[j * kStride + d] = to_f32(gimg[static_cast<int64_t>(j) * hd +
                                      h * kHeadDim + d]);
  }
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
    out[i * row_stride + h * kHeadDim + lane] = from_f32<T>(dq);
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
    T* o = out + j * row_stride + h * kHeadDim + lane;
    o[hd] = from_f32<T>(dk);
    o[2 * hd] = from_f32<T>(dv);
    __syncwarp();
  }
}

size_t smem_bytes(int n) {
  return sizeof(float) * static_cast<size_t>(n) *
         (4 * kStride + 3 + 2 * kWarps);
}

template <typename T>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int batch,
                   int n, int heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_qkv_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, batch);
  attention_qkv_bwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for sequence length n, in bytes.
int attention_qkv_bwd_smem_bytes(int n) {
  return static_cast<int>(smem_bytes(n));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller has checked shapes and pointers.
int attention_qkv_bwd(const void* qkv, const void* g, void* dqkv, int batch,
                      int n, int heads, int head_dim, float scale, int dtype,
                      void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || n < 1 ||
      heads < 1 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(qkv, g, dqkv, batch, n, heads, scale, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(qkv, g, dqkv, batch, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
