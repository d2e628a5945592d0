// Attention bodies for head widths above 256 (attention_qkv_fwd.cu,
// attention_qkv_bwd.cu route every head_dim > 256 here, packed and split,
// float32 and bfloat16).
//
// Same function as the narrower bodies and as the TPU kernels they
// replace (hgr_tpu/ops/attention_pallas.py:51 _attention_qkv_kernel and
// :175 _attention_qkv_bwd_kernel, which take any static head width):
//   s = (q . k) * scale in f32, keys >= n never enter, f32 softmax,
//   P rounded to the compute type T before P v and in dv = P^T g,
//   dS = P (dA - rowsum(dA P)) scale from the f32 P.
//
// The narrower bodies keep a row's (or a 16-row tile's) whole feature
// width in registers or in one block's shared memory; above 256 features
// that no longer fits, so these bodies cut the head into column slices:
//   * a product over the features (q . k, g . v) stages kSlice = 64
//     features of both sides at a time into shared memory (widened to
//     f32) and carries the f32 sums across the slices in registers
//     (``dots``): one fused multiply-add chain in feature order, so
//     q . k and k . q have the same bits and every kernel below sees the
//     same P;
//   * each block writes one kOut = 256-wide slice of its output rows
//     (grid x = row tiles x output slices) and recomputes the scores for
//     it. At D = 512 the scores are computed twice per sweep; simple, and
//     no register file or shared memory grows with D.
// Blocks are 8 warps; a warp owns 4 rows of the block's 32, a lane 2 rows
// of the other side's 64 per chunk (the f32 key-chunked bodies' layout).
// Shared memory is static (33,152 bytes forward, 41,344 backward): any
// head width and any length run.
//
// Forward: one kernel, two sweeps over the keys (max and sum of
// exp(s - max), then P normalised in f32, rounded to T and multiplied
// into V's slice), as the key-chunked route of the narrower bodies.
// Backward: three kernels. ``bwd_stats`` takes the rows' max, sum and
// rd = sum_j dA P into the (B, H, 3, pad16 N) f32 scratch of the chunked
// route; ``bwd_dq`` sums dq = dS K per query tile and output slice;
// ``bwd_dkv`` sums dk = dS^T Q and dv = round(P)^T G per key tile and
// output slice from those statistics. Each gradient element is summed by
// one thread in a fixed order: no atomics, deterministic.
//
// Bound: at (B, N, H, D) the function moves its inputs and outputs once,
// (4 B N H D) elements forward, (7 B N H D) backward, against 4 B H N^2 D
// and 10 B H N^2 D operations; these CUDA-core bodies recompute the
// scores per output slice and sweep, so they are bound by their
// fused multiply-adds (about 4 + 4 ceil(D / 256) N^2 D per head forward)
// and by the shared-memory reads feeding them, not by device memory. No
// configuration of the repository uses such heads; the bodies are for
// agreement with the reference, not speed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_wide {

constexpr int kNarrowest = 257;        // the first head width routed here
constexpr int kWarps = 8;
constexpr int kRows = 4;               // rows of the block's side a warp owns
constexpr int kBlockRows = kWarps * kRows;
constexpr int kChunk = 64;             // rows of the other side per chunk
constexpr int kSlice = 64;             // features staged at a time
constexpr int kS = kSlice + 1;         // staged row in floats (banks)
constexpr int kOut = 256;              // output features per block
constexpr int kOutSlots = kOut / 32;   // of them per lane
constexpr unsigned kFull = 0xffffffffu;

// static shared memory of the kernels, bytes
constexpr int kFwdSmem =
    4 * ((kBlockRows + kChunk) * kS + kWarps * kRows * kChunk);
constexpr int kBwdSmem =
    4 * ((kBlockRows + kChunk) * kS + 2 * kWarps * kRows * kChunk);

__host__ __device__ inline int out_slices(int d) {
  return (d + kOut - 1) / kOut;
}
__host__ __device__ inline int tiles(int n) {
  return (n + kBlockRows - 1) / kBlockRows;
}
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
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

// One (B, N, H*D) operand: element strides between images and rows.
template <typename P>
struct Rows {
  P* p;
  int64_t img;
  int64_t row;
  // row i of head h of image b
  __device__ __forceinline__ P* at(int b, int h, int d, int i) const {
    return p + b * img + i * row + static_cast<int64_t>(h) * d;
  }
};

// Stage rows [0, cnt) of src (row stride ``row``), features [f0, f0 +
// kSlice), into dst as f32 rows of kS floats; features at or beyond d are
// zero (a zero adds nothing to a dot product).
template <typename T>
__device__ __forceinline__ void stage(const T* src, int64_t row, float* dst,
                                      int cnt, int f0, int d) {
  for (int idx = threadIdx.x; idx < cnt * kSlice; idx += blockDim.x) {
    const int j = idx / kSlice;
    const int f = idx - j * kSlice;
    dst[j * kS + f] = f0 + f < d ? widen(src[j * row + f0 + f]) : 0.f;
  }
}

// out[r][c] = a_i . b_j over d features for the warp's rows i = r * kWarps
// + warp (< na) of a and the lane's rows j = lane + 32 c (< nb) of b:
// kSlice features of both staged at a time, one f32 fused multiply-add
// chain in feature order (the same bits whichever side is a). Ends with
// the last slice still staged in as and bs.
template <typename T>
__device__ __forceinline__ void dots(const T* a, int64_t arow, int na,
                                     const T* b, int64_t brow, int nb, int d,
                                     float* as, float* bs,
                                     float out[kRows][2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r][0] = out[r][1] = 0.f;
  for (int f0 = 0; f0 < d; f0 += kSlice) {
    __syncthreads();  // the previous slice (or the caller's use) is done
    stage(a, arow, as, na, f0, d);
    stage(b, brow, bs, nb, f0, d);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r * kWarps + warp;
      if (i >= na) break;  // uniform across the warp
      const float* ar = as + i * kS;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < nb) {
          const float* br = bs + j * kS;
          float s = out[r][c];
#pragma unroll 16
          for (int f = 0; f < kSlice; ++f) s = fmaf(ar[f], br[f], s);
          out[r][c] = s;
        }
      }
    }
  }
}

// acc[r][2u], acc[r][2u + 1] += sum_j w[r][j] * x_j[o0 + 64 u + lane (+ 32)]
// for the warp's rows over the chunk's nb rows of x, staged kSlice
// features at a time into xs (the block's output slice starts at o0).
template <typename T>
__device__ __forceinline__ void weighted_rows(const float* w, const T* x,
                                              int64_t xrow, int nb, int na,
                                              int o0, int d, float* xs,
                                              float acc[kRows][kOutSlots]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kOut / kSlice; ++u) {
    if (o0 + u * kSlice < d) {  // uniform across the block
      __syncthreads();  // xs is free, the weights are written
      stage(x, xrow, xs, nb, o0 + u * kSlice, d);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r * kWarps + warp >= na) break;
        const float* wr = w + r * kChunk;
        float a0 = acc[r][2 * u], a1 = acc[r][2 * u + 1];
        for (int j = 0; j < nb; ++j) {
          a0 = fmaf(wr[j], xs[j * kS + lane], a0);
          a1 = fmaf(wr[j], xs[j * kS + lane + 32], a1);
        }
        acc[r][2 * u] = a0;
        acc[r][2 * u + 1] = a1;
      }
    }
  }
}

// Store a lane's output features o0 + 32 t + lane of the warp's rows.
template <typename T>
__device__ __forceinline__ void store_rows(const Rows<T>& dst, int b, int h,
                                           int d, int row0, int na, int o0,
                                           const float acc[kRows][kOutSlots]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * kWarps + warp;
    if (i >= na) break;
    T* o = dst.at(b, h, d, row0 + i);
#pragma unroll
    for (int t = 0; t < kOutSlots; ++t) {
      const int f = o0 + 32 * t + lane;
      if (f < d) o[f] = narrow<T>(acc[r][t]);
    }
  }
}

// The row max m and sum l of exp(s - m) over all keys for the warp's rows
// of the query tile (sweep 1), merged across the warp.
template <typename T>
__device__ __forceinline__ void row_stats(const T* qh, int64_t qrow, int na,
                                          const T* kh, int64_t krow, int n,
                                          int d, float scale, float* as,
                                          float* bs, float m[kRows],
                                          float l[kRows]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int nb = min(kChunk, n - k0);
    dots(qh, qrow, na, kh + k0 * krow, krow, nb, d, as, bs, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r * kWarps + warp >= na) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (lane + 32 * c >= nb) continue;
        const float x = __fmul_rn(s[r][c], scale);
        if (x > m[r]) {
          l[r] = l[r] * expf(m[r] - x) + 1.f;
          m[r] = x;
        } else {
          l[r] += expf(x - m[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float mr = warp_max(m[r]);
    l[r] = warp_sum(m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mr));
    m[r] = mr;
  }
}

// The statistics scratch: (B, H, 3, npad) f32, the rows' max, sum and rd.
__device__ __forceinline__ float* stats_of(float* stats, int b, int h,
                                           int heads, int npad) {
  return stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
wide_fwd_kernel(const Rows<const T> q, const Rows<const T> k,
                const Rows<const T> v, const Rows<T> out, int n, int heads,
                int d, float scale, int q_tiles) {
  __shared__ float as[kBlockRows * kS];
  __shared__ float bs[kChunk * kS];
  __shared__ float ps[kWarps * kRows * kChunk];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (blockIdx.x % q_tiles) * kBlockRows;
  const int o0 = (blockIdx.x / q_tiles) * kOut;
  const int na = min(kBlockRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qh = q.at(b, h, d, row0);
  const T* kh = k.at(b, h, d, 0);
  const T* vh = v.at(b, h, d, 0);
  float* p = ps + warp * kRows * kChunk;

  float m[kRows], l[kRows];
  row_stats(qh, q.row, na, kh, k.row, n, d, scale, as, bs, m, l);

  float acc[kRows][kOutSlots] = {};
  float s[kRows][2];
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int nb = min(kChunk, n - k0);
    dots(qh, q.row, na, kh + k0 * k.row, k.row, nb, d, as, bs, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r * kWarps + warp >= na) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j >= nb) continue;
        const float e = expf(__fmul_rn(s[r][c], scale) - m[r]) / l[r];
        p[r * kChunk + j] = widen(narrow<T>(e));  // P rounded to T
      }
    }
    weighted_rows(p, vh + k0 * v.row, v.row, nb, na, o0, d, bs, acc);
  }
  store_rows(out, b, h, d, row0, na, o0, acc);
}

// Query tiles: m, l (sweep 1), then rd = sum_j dA P (sweep 2), into the
// statistics scratch.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
wide_bwd_stats_kernel(const Rows<const T> q, const Rows<const T> k,
                      const Rows<const T> v, const Rows<const T> g,
                      float* stats, int n, int heads, int d, float scale) {
  __shared__ float as[kBlockRows * kS];
  __shared__ float bs[kChunk * kS];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kBlockRows;
  const int na = min(kBlockRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qh = q.at(b, h, d, row0);
  const T* gh = g.at(b, h, d, row0);
  const T* kh = k.at(b, h, d, 0);
  const T* vh = v.at(b, h, d, 0);

  float m[kRows], l[kRows], rd[kRows] = {};
  row_stats(qh, q.row, na, kh, k.row, n, d, scale, as, bs, m, l);
  float s[kRows][2], da[kRows][2];
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int nb = min(kChunk, n - k0);
    dots(qh, q.row, na, kh + k0 * k.row, k.row, nb, d, as, bs, s);
    dots(gh, g.row, na, vh + k0 * v.row, v.row, nb, d, as, bs, da);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r * kWarps + warp >= na) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (lane + 32 * c >= nb) continue;
        const float p = expf(__fmul_rn(s[r][c], scale) - m[r]) / l[r];
        rd[r] = fmaf(da[r][c], p, rd[r]);
      }
    }
  }
  const int npad = pad16(n);
  float* st = stats_of(stats, b, h, heads, npad);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float sum = warp_sum(rd[r]);
    const int i = r * kWarps + warp;
    if (i < na && lane == 0) {
      st[row0 + i] = m[r];
      st[npad + row0 + i] = l[r];
      st[2 * npad + row0 + i] = sum;
    }
  }
}

// Query tile x output slice: dq = dS K.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
wide_bwd_dq_kernel(const Rows<const T> q, const Rows<const T> k,
                   const Rows<const T> v, const Rows<const T> g,
                   const Rows<T> dq, const float* stats, int n, int heads,
                   int d, float scale, int q_tiles) {
  __shared__ float as[kBlockRows * kS];
  __shared__ float bs[kChunk * kS];
  __shared__ float ws[kWarps * kRows * kChunk];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (blockIdx.x % q_tiles) * kBlockRows;
  const int o0 = (blockIdx.x / q_tiles) * kOut;
  const int na = min(kBlockRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qh = q.at(b, h, d, row0);
  const T* gh = g.at(b, h, d, row0);
  const T* kh = k.at(b, h, d, 0);
  const T* vh = v.at(b, h, d, 0);
  float* w = ws + warp * kRows * kChunk;

  const int npad = pad16(n);
  const float* st = stats_of(const_cast<float*>(stats), b, h, heads, npad);
  float m[kRows], l[kRows], rd[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(r * kWarps + warp, na - 1);  // rows >= na unused
    m[r] = st[row0 + i];
    l[r] = st[npad + row0 + i];
    rd[r] = st[2 * npad + row0 + i];
  }
  float acc[kRows][kOutSlots] = {};
  float s[kRows][2], da[kRows][2];
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int nb = min(kChunk, n - k0);
    dots(qh, q.row, na, kh + k0 * k.row, k.row, nb, d, as, bs, s);
    dots(gh, g.row, na, vh + k0 * v.row, v.row, nb, d, as, bs, da);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r * kWarps + warp >= na) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j >= nb) continue;
        const float p = expf(__fmul_rn(s[r][c], scale) - m[r]) / l[r];
        w[r * kChunk + j] = p * (da[r][c] - rd[r]) * scale;
      }
    }
    weighted_rows(w, kh + k0 * k.row, k.row, nb, na, o0, d, bs, acc);
  }
  store_rows(dq, b, h, d, row0, na, o0, acc);
}

// Key tile x output slice: dk = dS^T Q and dv = round(P)^T G, sweeping the
// queries with their saved statistics.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
wide_bwd_dkv_kernel(const Rows<const T> q, const Rows<const T> k,
                    const Rows<const T> v, const Rows<const T> g,
                    const Rows<T> dk, const Rows<T> dv, const float* stats,
                    int n, int heads, int d, float scale, int k_tiles) {
  __shared__ float as[kBlockRows * kS];
  __shared__ float bs[kChunk * kS];
  __shared__ float ws[2 * kWarps * kRows * kChunk];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (blockIdx.x % k_tiles) * kBlockRows;
  const int o0 = (blockIdx.x / k_tiles) * kOut;
  const int na = min(kBlockRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* kh = k.at(b, h, d, row0);
  const T* vh = v.at(b, h, d, row0);
  const T* qh = q.at(b, h, d, 0);
  const T* gh = g.at(b, h, d, 0);
  float* wds = ws + warp * kRows * kChunk;                    // dS^T rows
  float* wp = ws + (kWarps + warp) * kRows * kChunk;          // P^ rows

  const int npad = pad16(n);
  const float* st = stats_of(const_cast<float*>(stats), b, h, heads, npad);
  float dk_acc[kRows][kOutSlots] = {};
  float dv_acc[kRows][kOutSlots] = {};
  float s[kRows][2], da[kRows][2];
  for (int q0 = 0; q0 < n; q0 += kChunk) {
    const int nb = min(kChunk, n - q0);
    dots(kh, k.row, na, qh + q0 * q.row, q.row, nb, d, as, bs, s);
    dots(vh, v.row, na, gh + q0 * g.row, g.row, nb, d, as, bs, da);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j >= nb) continue;
      const float mj = st[q0 + j];
      const float lj = st[npad + q0 + j];
      const float rdj = st[2 * npad + q0 + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r * kWarps + warp >= na) break;
        const float p = expf(__fmul_rn(s[r][c], scale) - mj) / lj;
        wds[r * kChunk + j] = p * (da[r][c] - rdj) * scale;
        wp[r * kChunk + j] = widen(narrow<T>(p));
      }
    }
    weighted_rows(wds, qh + q0 * q.row, q.row, nb, na, o0, d, bs, dk_acc);
    weighted_rows(wp, gh + q0 * g.row, g.row, nb, na, o0, d, bs, dv_acc);
  }
  store_rows(dk, b, h, d, row0, na, o0, dk_acc);
  store_rows(dv, b, h, d, row0, na, o0, dv_acc);
}

// Host side. ``strides`` holds (image, row) element strides per operand.
template <typename P>
Rows<P> rows_of(const void* p, const int64_t* strides, int i) {
  return {static_cast<P*>(const_cast<void*>(p)), strides[2 * i],
          strides[2 * i + 1]};
}

// q, k, v -> out (B, N, H*D) contiguous.
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int64_t* strides, void* out, int batch, int n,
                       int heads, int d, float scale, cudaStream_t stream) {
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int64_t out_strides[2] = {n * hd, hd};
  const int q_tiles = tiles(n);
  wide_fwd_kernel<T><<<dim3(q_tiles * out_slices(d), heads, batch),
                       kWarps * 32, 0, stream>>>(
      rows_of<const T>(q, strides, 0), rows_of<const T>(k, strides, 1),
      rows_of<const T>(v, strides, 2), rows_of<T>(out, out_strides, 0), n,
      heads, d, scale, q_tiles);
  return cudaGetLastError();
}

// ptrs: q, k, v, g in, dq, dk, dv out, with 14 strides; stats: the
// (B, H, 3, pad16 N) f32 scratch.
template <typename T>
cudaError_t launch_bwd(const void* const* ptrs, const int64_t* strides,
                       float* stats, int batch, int n, int heads, int d,
                       float scale, cudaStream_t stream) {
  const auto q = rows_of<const T>(ptrs[0], strides, 0);
  const auto k = rows_of<const T>(ptrs[1], strides, 1);
  const auto v = rows_of<const T>(ptrs[2], strides, 2);
  const auto g = rows_of<const T>(ptrs[3], strides, 3);
  const int t = tiles(n);
  const int threads = kWarps * 32;
  wide_bwd_stats_kernel<T><<<dim3(t, heads, batch), threads, 0, stream>>>(
      q, k, v, g, stats, n, heads, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(t * out_slices(d), heads, batch);
  wide_bwd_dq_kernel<T><<<grid, threads, 0, stream>>>(
      q, k, v, g, rows_of<T>(ptrs[4], strides, 4), stats, n, heads, d,
      scale, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_dkv_kernel<T><<<grid, threads, 0, stream>>>(
      q, k, v, g, rows_of<T>(ptrs[5], strides, 5),
      rows_of<T>(ptrs[6], strides, 6), stats, n, heads, d, scale, t);
  return cudaGetLastError();
}

}  // namespace attn_wide
