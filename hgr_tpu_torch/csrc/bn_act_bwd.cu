// Closed-form backward of train-mode BatchNorm(+SiLU): the two passes.
//
// Replaces the TPU kernels of hgr_tpu/ops/bn_act_pallas.py, launched by
// _bwd_pallas :144 under the custom VJP bn_act :215:
//   _reduce_kernel :102  ->  bn_act_reduce (+ bn_act_reduce_finish)
//   _elem_kernel   :129  ->  bn_act_elem
//
// What they compute, on the NHWC activation viewed as (M, C) rows, M =
// B*H*W, with the per-channel f32 vectors mean, r = rsqrt(var + eps),
// gamma, beta (and, for the second pass, T1/M and T2/M) from the host
// wrapper (ops/bn_act.py):
//   xhat = (y - mean) * r,  z = xhat * gamma + beta,
//   dz   = g * s * (1 + z * (1 - s)),  s = 1 / (1 + exp(-z))   (act)
//   dz   = g                                                   (no act)
//   reduce:  T1[c] = sum_m dz,  T2[c] = sum_m dz * xhat
//   elem:    dy = (r * gamma) * (dz - T1/M - xhat * T2/M)
// y and g are bf16 or f32 (templated), read once per pass; all arithmetic
// is f32 in registers (expf, not __expf); dy is written in y's type.
//
// Bound on an H100 SXM: both passes are bytes-bound (~24 f32 operations
// per element against 4-6 bytes). At B=256 in bf16 over the 22 GELAN
// small layers (3.17 M elements per crop), one pullback moves ~8.1 GB:
// ~2.4 ms at 3.35 TB/s.
//
// Design (simple first). The TPU kernel carried one (8, C) accumulator
// across its in-order grid; Hopper's blocks run in no order, so:
// * Both passes launch a grid of (row chunk, channel tile) blocks of 256
//   threads laid out (TX, TY): TX threads span the tile's channels, VEC
//   neighbouring channels each (VEC = 8 bf16 / 4 f32: 16-byte loads, or 1
//   when C or the pointers do not allow it), TY threads walk the chunk's
//   rows. A thread keeps its channels' vectors in registers for the whole
//   chunk. The last chunk is shorter; no host-side padding of M.
// * reduce writes each block's column sums (f32, summed over TY in a fixed
//   order through shared memory) to a (chunks, C) scratch; reduce_finish
//   sums the chunks in a fixed order per channel. Deterministic, no
//   atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// VEC consecutive elements at p (16-byte aligned when VEC * sizeof(T) == 16)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    union {
      uint4 raw;
      T e[VEC];
    } u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(u.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    union {
      uint4 raw;
      T e[VEC];
    } u;
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(v[i], &u.e[i]);
    *reinterpret_cast<uint4*>(p) = u.raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(v[i], &p[i]);
  }
}

// dz and xhat of one element (ops/bn_act.py bn_act_reduce_reference)
struct Chan {
  float mean, r, gamma, beta;
};

__device__ __forceinline__ float dz_of(float y, float g, const Chan& ch,
                                       bool act, float* xhat) {
  const float xh = (y - ch.mean) * ch.r;
  *xhat = xh;
  if (!act) return g;
  const float z = xh * ch.gamma + ch.beta;
  const float s = 1.f / (1.f + expf(-z));
  return g * (s * (1.f + z * (1.f - s)));
}

// Layout of one launch: block (TX, TY) over channel tile blockIdx.y and
// rows [row0, row1) of chunk blockIdx.x.
struct Tile {
  int c0;          // first channel of this thread (>= C: idle)
  int64_t row0, row1;
};

__device__ __forceinline__ Tile tile_of(int vec, int64_t m,
                                        int64_t rows_per_chunk) {
  Tile t;
  t.c0 = (blockIdx.y * blockDim.x + threadIdx.x) * vec;
  t.row0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t end = t.row0 + rows_per_chunk;
  t.row1 = end < m ? end : m;
  return t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_act_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                     const float* __restrict__ vecs,  // (4, C)
                     float* __restrict__ partial,     // (2, chunks, C)
                     int64_t m, int c, int64_t rows_per_chunk, int act) {
  __shared__ float s1[kThreads * VEC];
  __shared__ float s2[kThreads * VEC];
  const Tile t = tile_of(VEC, m, rows_per_chunk);
  float t1[VEC], t2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) t1[i] = t2[i] = 0.f;
  if (t.c0 < c) {
    Chan ch[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ch[i].mean = vecs[t.c0 + i];
      ch[i].r = vecs[c + t.c0 + i];
      ch[i].gamma = vecs[2 * c + t.c0 + i];
      ch[i].beta = vecs[3 * c + t.c0 + i];
    }
    for (int64_t row = t.row0 + threadIdx.y; row < t.row1;
         row += blockDim.y) {
      float yv[VEC], gv[VEC];
      load_vec<T, VEC>(y + row * c + t.c0, yv);
      load_vec<T, VEC>(g + row * c + t.c0, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh;
        const float dz = dz_of(yv[i], gv[i], ch[i], act, &xh);
        t1[i] += dz;
        t2[i] += dz * xh;
      }
    }
  }
  // column sums over threadIdx.y, in a fixed order
  const int cols = blockDim.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[threadIdx.y * cols + threadIdx.x * VEC + i] = t1[i];
    s2[threadIdx.y * cols + threadIdx.x * VEC + i] = t2[i];
  }
  __syncthreads();
  const int lin = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.y * cols + lin;
  if (lin < cols && col < c) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < blockDim.y; ++k) {
      a += s1[k * cols + lin];
      b += s2[k * cols + lin];
    }
    const int64_t chunks = gridDim.x;
    partial[static_cast<int64_t>(blockIdx.x) * c + col] = a;
    partial[(chunks + blockIdx.x) * c + col] = b;
  }
}

// T1, T2 (C,) from the (2, chunks, C) partials: block (32, 8) per 32
// channels, each threadIdx.y sums every 8th chunk, then a fixed-order sum.
__global__ void __launch_bounds__(kThreads)
bn_act_reduce_finish_kernel(const float* __restrict__ partial,
                            float* __restrict__ t1, float* __restrict__ t2,
                            int chunks, int c) {
  __shared__ float s1[8][32];
  __shared__ float s2[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (col < c) {
    for (int k = threadIdx.y; k < chunks; k += 8) {
      a += partial[static_cast<int64_t>(k) * c + col];
      b += partial[(static_cast<int64_t>(chunks) + k) * c + col];
    }
  }
  s1[threadIdx.y][threadIdx.x] = a;
  s2[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a += s1[k][threadIdx.x];
      b += s2[k][threadIdx.x];
    }
    t1[col] = a;
    t2[col] = b;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_act_elem_kernel(const T* __restrict__ y, const T* __restrict__ g,
                   const float* __restrict__ vecs,  // (6, C)
                   T* __restrict__ dy, int64_t m, int c,
                   int64_t rows_per_chunk, int act) {
  const Tile t = tile_of(VEC, m, rows_per_chunk);
  if (t.c0 >= c) return;
  Chan ch[VEC];
  float scale[VEC], t1m[VEC], t2m[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ch[i].mean = vecs[t.c0 + i];
    ch[i].r = vecs[c + t.c0 + i];
    ch[i].gamma = vecs[2 * c + t.c0 + i];
    ch[i].beta = vecs[3 * c + t.c0 + i];
    t1m[i] = vecs[4 * c + t.c0 + i];
    t2m[i] = vecs[5 * c + t.c0 + i];
    scale[i] = ch[i].r * ch[i].gamma;
  }
  for (int64_t row = t.row0 + threadIdx.y; row < t.row1; row += blockDim.y) {
    float yv[VEC], gv[VEC], out[VEC];
    load_vec<T, VEC>(y + row * c + t.c0, yv);
    load_vec<T, VEC>(g + row * c + t.c0, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xh;
      const float dz = dz_of(yv[i], gv[i], ch[i], act, &xh);
      out[i] = scale[i] * (dz - t1m[i] - xh * t2m[i]);
    }
    store_vec<T, VEC>(dy + row * c + t.c0, out);
  }
}

// Block shape and grid of both passes for (m, c) at vector width vec.
struct Plan {
  dim3 block, grid;
  int64_t rows_per_chunk;
};

Plan plan(int64_t m, int c, int vec) {
  const int groups = (c + vec - 1) / vec;  // threads across the channels
  const int tx = groups < 32 ? groups : 32;
  const int ty = kThreads / tx;
  const int tiles = (groups + tx - 1) / tx;
  // ~4 blocks per SM of the 132, each chunk a multiple of ty rows
  int64_t chunks = (528 + tiles - 1) / tiles;
  const int64_t max_chunks = (m + ty - 1) / ty;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  int64_t rows = (m + chunks - 1) / chunks;
  rows = (rows + ty - 1) / ty * ty;
  chunks = (m + rows - 1) / rows;
  Plan p;
  p.block = dim3(tx, ty);
  p.grid = dim3(static_cast<unsigned>(chunks), tiles);
  p.rows_per_chunk = rows;
  return p;
}

template <typename T, int VEC>
cudaError_t reduce_launch(const void* y, const void* g, const float* vecs,
                          float* partial, float* t1, float* t2, int64_t m,
                          int c, int act, cudaStream_t stream) {
  const Plan p = plan(m, c, VEC);
  bn_act_reduce_kernel<T, VEC><<<p.grid, p.block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), vecs, partial, m, c,
      p.rows_per_chunk, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_act_reduce_finish_kernel<<<(c + 31) / 32, dim3(32, 8), 0, stream>>>(
      partial, t1, t2, static_cast<int>(p.grid.x), c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t elem_launch(const void* y, const void* g, const float* vecs,
                        void* dy, int64_t m, int c, int act,
                        cudaStream_t stream) {
  const Plan p = plan(m, c, VEC);
  bn_act_elem_kernel<T, VEC><<<p.grid, p.block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), vecs,
      static_cast<T*>(dy), m, c, p.rows_per_chunk, act);
  return cudaGetLastError();
}

bool bad_args(int64_t m, int c, int dtype, int vectorized) {
  return m < 1 || c < 1 || dtype < 0 || dtype > 1 || vectorized < 0 ||
         vectorized > 1;
}

}  // namespace

extern "C" {

// Chunks of the reduce pass for (m, c): the wrapper sizes the (2, chunks,
// C) f32 scratch with it. vectorized: 1 = 16-byte loads (C divisible by
// 8 for bf16 / 4 for f32 and 16-byte aligned pointers), 0 = one element.
int bn_act_reduce_chunks(int64_t m, int c, int dtype, int vectorized) {
  if (bad_args(m, c, dtype, vectorized)) return -1;
  const int vec = vectorized ? (dtype == 1 ? 8 : 4) : 1;
  return static_cast<int>(plan(m, c, vec).grid.x);
}

// dtype: 0 = float32, 1 = bfloat16 (y and g). vecs: (4, C) f32 mean, r,
// gamma, beta. partial: (2, chunks, C) f32 scratch; t1, t2: (C,) f32.
// Returns cudaGetLastError() after the launches (0 on success).
int bn_act_reduce(const void* y, const void* g, const void* vecs,
                  void* partial, void* t1, void* t2, int64_t m, int c,
                  int dtype, int vectorized, int act, void* stream) {
  if (bad_args(m, c, dtype, vectorized)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vecs);
  float* p = static_cast<float*>(partial);
  float* a = static_cast<float*>(t1);
  float* b = static_cast<float*>(t2);
  cudaError_t err;
  if (dtype == 1) {
    err = vectorized
              ? reduce_launch<__nv_bfloat16, 8>(y, g, v, p, a, b, m, c, act, st)
              : reduce_launch<__nv_bfloat16, 1>(y, g, v, p, a, b, m, c, act,
                                                st);
  } else {
    err = vectorized ? reduce_launch<float, 4>(y, g, v, p, a, b, m, c, act, st)
                     : reduce_launch<float, 1>(y, g, v, p, a, b, m, c, act, st);
  }
  return static_cast<int>(err);
}

// vecs: (6, C) f32 mean, r, gamma, beta, T1/M, T2/M. dy: (M, C) in y's
// type. Returns cudaGetLastError() after the launch (0 on success).
int bn_act_elem(const void* y, const void* g, const void* vecs, void* dy,
                int64_t m, int c, int dtype, int vectorized, int act,
                void* stream) {
  if (bad_args(m, c, dtype, vectorized)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vecs);
  cudaError_t err;
  if (dtype == 1) {
    err = vectorized
              ? elem_launch<__nv_bfloat16, 8>(y, g, v, dy, m, c, act, st)
              : elem_launch<__nv_bfloat16, 1>(y, g, v, dy, m, c, act, st);
  } else {
    err = vectorized ? elem_launch<float, 4>(y, g, v, dy, m, c, act, st)
                     : elem_launch<float, 1>(y, g, v, dy, m, c, act, st);
  }
  return static_cast<int>(err);
}

const char* bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
