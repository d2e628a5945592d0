// Fused multi-head attention forward on the packed qkv projection.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:51
// (_attention_qkv_kernel, launched by _attention_qkv_impl :85).
//
// What it computes, per image b and head h (D = 32):
//   s[i, j] = (q_i . k_j) * scale          q, k widened to f32, f32 dot,
//                                          scale applied after the dot
//   P[i, j] = round_T(exp(s - max_j s) / sum_j exp(s - max_j s))
//                                          f32 max / exp / sum, P rounded
//                                          to the compute type T
//   out[i]  = round_T(sum_j P[i, j] * v_j) f32 accumulation
// reading q, k, v by stride from qkv (B, N, 3*H*D) = [q | k | v], each
// head-major, and writing out (B, N, H*D). No N x N tensor reaches
// device memory.
//
// Bound on an H100 SXM at the serving shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 19.0 MB (qkv read once, 14.25 MB; out
// written once, 4.75 MB), 5.7 us at 3.35 TB/s, against 1.38 GFLOP for
// the two products, 1.4 us at 989 TFLOP/s. The kernel is memory-bound.
//
// Design (simple first): one block per (row group of 32 queries, head,
// image). The block stages that head's K and V (N x D, widened to f32)
// from the packed rows into shared memory; K rows are padded to D + 1
// floats so that lane j reading row j hits 32 distinct banks. Each warp
// owns one query row at a time: lane j computes the scores of keys
// j, j + 32, ... into the warp's own row of shared memory, the warp
// reduces max and sum with shuffles, and lane d then accumulates output
// feature d over all keys. Both products run on the CUDA cores in f32;
// the K/V staging is repeated by the ceil(N / 32) row groups of a head
// (served from L2). Left for later: mma / wgmma tensor-core tiles for
// the two products, one block per (image, head) with K/V staged once,
// and 16-byte vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;             // one lane per output feature
constexpr int kWarps = 8;                // warps per block
constexpr int kRowsPerWarp = 4;          // query rows each warp walks
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kKStride = kHeadDim + 1;   // padded K row (bank conflicts)
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                     // n * kKStride
  float* vs = ks + n * kKStride;        // n * kHeadDim
  float* ps = vs + n * kHeadDim;        // kWarps * n, one row per warp

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * kHeadDim;
  const int64_t row_stride = 3 * static_cast<int64_t>(hd);
  const T* img = qkv + static_cast<int64_t>(b) * n * row_stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < n * kHeadDim; idx += blockDim.x) {
    const int j = idx / kHeadDim;
    const int d = idx - j * kHeadDim;
    const T* src = img + j * row_stride + h * kHeadDim + d;
    ks[j * kKStride + d] = to_f32(src[hd]);
    vs[j * kHeadDim + d] = to_f32(src[2 * hd]);
  }
  __syncthreads();

  float* p = ps + warp * n;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r * kWarps + warp;
    if (i >= n) break;  // uniform across the warp; later rows are larger
    const float q_lane = to_f32(img[i * row_stride + h * kHeadDim + lane]);
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
    for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * kHeadDim + lane], acc);
    out[(static_cast<int64_t>(b) * n + i) * hd + h * kHeadDim + lane] =
        from_f32<T>(acc);
    __syncwarp();  // p is rewritten by the warp's next row
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int heads,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(n) * (kKStride + kHeadDim + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_qkv_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  attention_qkv_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for sequence length n, in bytes.
int attention_qkv_fwd_smem_bytes(int n) {
  return static_cast<int>(sizeof(float)) * n * (kKStride + kHeadDim + kWarps);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller has checked shapes and pointers.
int attention_qkv_fwd(const void* qkv, void* out, int batch, int n, int heads,
                      int head_dim, float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || batch > 65535 || n < 1 ||
      heads < 1 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(qkv, out, batch, n, heads, scale, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(qkv, out, batch, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
