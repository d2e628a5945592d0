// Closed-form backward of train-mode BatchNorm(+SiLU): the two passes.
//
// Replaces the TPU kernels of hgr_tpu/ops/bn_act_pallas.py, launched by
// _bwd_pallas :144 under the custom VJP bn_act :215:
//   _reduce_kernel :102  ->  bn_act_reduce
//   _elem_kernel   :129  ->  bn_act_elem
//
// What they compute, on the NHWC activation viewed as (M, C) rows, M =
// B*H*W, with the per-channel f32 vectors mean, r = rsqrt(var + eps),
// gamma, beta (and, for the second pass, T1/M and T2/M) from the host
// wrapper (ops/bn_act.py), each passed by its own pointer:
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
// The TPU kernel carried one (8, C) accumulator across its in-order grid;
// Hopper's blocks run in no order. So:
// * reduce is one launch. Its grid is sized to the card and to (M, C):
//   blocks of 512 threads laid out (TX, TY), TX (1..8, a power of two)
//   threads across a tile of TX * VEC channels, VEC neighbouring channels
//   each (VEC = 8 bf16 / 4 f32: 16-byte loads, or 1 when C or the
//   pointers do not allow them), TY threads down the rows; as many row
//   chunks per channel tile as fill the SMs at the kernel's occupancy,
//   each a whole number of TY * kUnroll rows. A thread walks its chunk's
//   rows kUnroll at a time, all kUnroll rows' loads of y and g issued
//   before their arithmetic (8 16-byte loads in flight a thread), the
//   last rows' loads masked to zero (which adds nothing to the sums).
//   The block sums its threads' partials across the lanes of a warp by
//   shuffles, then across its warps in a fixed order through 8 KB of
//   shared memory, and writes them to a (tile, chunk) slot of a scratch.
//   The last block of each channel tile to finish (elected by a counter,
//   after __threadfence) sums the tile's partials over the chunks in a
//   fixed order of chunks, writes T1 and T2 and resets the counter to 0
//   for the next launch. No atomics on the sums: deterministic.
// * elem keeps its first design: a grid of (row chunk, channel tile)
//   blocks of 256 threads, VEC channels a thread, the thread's channel
//   vectors in registers for the whole chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // elem
constexpr int kReduceThreads = 512;   // reduce
constexpr int kUnroll = 4;            // rows in flight a reduce thread
constexpr int kMaxTx = 8;             // reduce threads across a tile
constexpr int kMaxSms = 64;           // devices cached by reduce_target

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// VEC consecutive elements at p (16- or 8-byte aligned when VEC *
// sizeof(T) is 16 or 8)
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
  } else if constexpr (VEC * sizeof(T) == 8) {
    union {
      uint2 raw;
      T e[VEC];
    } u;
    u.raw = __ldg(reinterpret_cast<const uint2*>(p));
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

// The per-channel f32 vectors, one pointer each.
struct Vecs {
  const float* mean;
  const float* r;
  const float* gamma;
  const float* beta;
};

// dz and xhat of one element (ops/bn_act.py bn_act_reduce_reference)
struct Chan {
  float mean, r, gamma, beta;
};

__device__ __forceinline__ Chan chan_of(const Vecs& v, int ch) {
  return {v.mean[ch], v.r[ch], v.gamma[ch], v.beta[ch]};
}

__device__ __forceinline__ float dz_of(float y, float g, const Chan& ch,
                                       bool act, float* xhat) {
  const float xh = (y - ch.mean) * ch.r;
  *xhat = xh;
  if (!act) return g;
  const float z = xh * ch.gamma + ch.beta;
  const float s = 1.f / (1.f + expf(-z));
  return g * (s * (1.f + z * (1.f - s)));
}

// ---- reduce -----------------------------------------------------------

// partial: per (channel tile, chunk) 2 * TX * VEC floats, T1 then T2 of
// the tile's channels; counters: one per channel tile, 0 between
// launches.
template <typename T, int VEC, bool ACT>
__global__ void __launch_bounds__(kReduceThreads, ACT ? 2 : 1)
bn_act_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                     const Vecs vecs, float* __restrict__ partial,
                     unsigned* __restrict__ counters, float* __restrict__ t1,
                     float* __restrict__ t2, int64_t m, int c, int tx_log2,
                     int64_t rows_per_chunk) {
  __shared__ float red[kReduceThreads / 32][2][kMaxTx * VEC];
  __shared__ float sums[kReduceThreads];
  __shared__ bool last;
  const int tx_n = 1 << tx_log2;
  const int cols = tx_n * VEC;  // channels of the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & (tx_n - 1);
  const int ty = tid >> tx_log2;
  const int ty_n = blockDim.x >> tx_log2;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t end = row0 + rows_per_chunk;
  const int64_t row1 = end < m ? end : m;

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  if (c0 < c) {
    Chan ch[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ch[i].mean = vecs.mean[c0 + i];
      ch[i].r = vecs.r[c0 + i];
      ch[i].gamma = ACT ? vecs.gamma[c0 + i] : 0.f;
      ch[i].beta = ACT ? vecs.beta[c0 + i] : 0.f;
    }
    const int64_t step = static_cast<int64_t>(ty_n) * kUnroll;
    for (int64_t row = row0 + ty; row < row1; row += step) {
      float yv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = row + u * ty_n;
        if (rr < row1) {
          load_vec<T, VEC>(y + rr * c + c0, yv[u]);
          load_vec<T, VEC>(g + rr * c + c0, gv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) yv[u][i] = gv[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xh;
          const float dz = dz_of(yv[u][i], gv[u][i], ch[i], ACT, &xh);
          a1[i] += dz;
          a2[i] += dz * xh;
        }
      }
    }
  }
  // the lanes of a warp that share channels (tx, tx + TX, ...), by shuffles
  for (int o = 16; o >= tx_n; o >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], o);
      a2[i] += __shfl_xor_sync(0xffffffffu, a2[i], o);
    }
  }
  if (lane < tx_n) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[warp][0][lane * VEC + i] = a1[i];
      red[warp][1][lane * VEC + i] = a2[i];
    }
  }
  __syncthreads();
  // the warps, in order: this block's slot of the scratch
  const int warps = blockDim.x >> 5;
  float* tile = partial + static_cast<int64_t>(blockIdx.y) * gridDim.x * 2 *
                              cols;
  for (int idx = tid; idx < 2 * cols; idx += blockDim.x) {
    const int w = idx / cols, col = idx - w * cols;
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += red[k][w][col];
    tile[static_cast<int64_t>(blockIdx.x) * 2 * cols + idx] = s;
  }
  __threadfence();  // the slot is visible before the counter moves
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[blockIdx.y], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the tile's last block: the chunks' partials in a fixed order, split
  // among ``parts`` threads a column, then the parts in order
  const int parts = blockDim.x / (2 * cols);
  const int idx = tid % (2 * cols), part = tid / (2 * cols);
  if (part < parts) {
    // chunks part, part + parts, ... in order; eight loads in flight
    const int chunks = gridDim.x;
    const float* col = tile + idx;
    const int64_t stride = static_cast<int64_t>(parts) * 2 * cols;
    float s = 0.f;
    int k = part;
    for (; k + 7 * parts < chunks; k += 8 * parts) {
      const float* p = col + static_cast<int64_t>(k) * 2 * cols;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + u * stride);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; k < chunks; k += parts) {
      s += __ldcg(col + static_cast<int64_t>(k) * 2 * cols);
    }
    sums[part * 2 * cols + idx] = s;
  }
  __syncthreads();
  if (tid < 2 * cols) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += sums[p * 2 * cols + tid];
    const int w = tid / cols;
    const int ch = blockIdx.y * cols + tid - w * cols;
    if (ch < c) (w == 0 ? t1 : t2)[ch] = s;
  }
  if (tid == 0) counters[blockIdx.y] = 0u;
}

struct ReducePlan {
  int tx_log2;
  int tiles;
  int64_t chunks;
  int64_t rows_per_chunk;
};

// Blocks of the reduce kernel the card holds at once (SMs x occupancy),
// cached per device.
template <typename T, int VEC, bool ACT>
int reduce_target() {
  static int per_sm[kMaxSms] = {};
  static int sms[kMaxSms] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxSms) dev = 0;
  if (per_sm[dev] == 0) {
    int count = 0, occupancy = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy, bn_act_reduce_kernel<T, VEC, ACT>, kReduceThreads, 0);
    sms[dev] = count > 0 ? count : 132;
    per_sm[dev] = occupancy > 0 ? occupancy : 1;
  }
  return sms[dev] * per_sm[dev];
}

ReducePlan reduce_plan(int64_t m, int c, int vec, int target) {
  const int groups = (c + vec - 1) / vec;
  int tx_log2 = 0;
  while ((1 << tx_log2) < groups && (1 << tx_log2) < kMaxTx) ++tx_log2;
  const int tx_n = 1 << tx_log2;
  const int64_t step = static_cast<int64_t>(kReduceThreads / tx_n) * kUnroll;
  ReducePlan p;
  p.tx_log2 = tx_log2;
  p.tiles = (groups + tx_n - 1) / tx_n;
  int64_t chunks = (target + p.tiles - 1) / p.tiles;
  const int64_t most = (m + step - 1) / step;  // one step of rows each
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  int64_t rows = (m + chunks - 1) / chunks;
  rows = (rows + step - 1) / step * step;
  p.rows_per_chunk = rows;
  p.chunks = (m + rows - 1) / rows;
  return p;
}

template <typename T, int VEC, bool ACT>
ReducePlan reduce_plan_for(int64_t m, int c) {
  return reduce_plan(m, c, VEC, reduce_target<T, VEC, ACT>());
}

// One instantiation of the reduce: element type, channels a thread, SiLU.
template <typename T, int VEC, bool ACT>
struct Reduce {
  static ReducePlan plan(int64_t m, int c) {
    return reduce_plan_for<T, VEC, ACT>(m, c);
  }
  static cudaError_t launch(const void* y, const void* g, const Vecs& vecs,
                            float* partial, unsigned* counters, float* t1,
                            float* t2, int64_t m, int c,
                            cudaStream_t stream) {
    const ReducePlan p = plan(m, c);
    bn_act_reduce_kernel<T, VEC, ACT>
        <<<dim3(static_cast<unsigned>(p.chunks), p.tiles), kReduceThreads, 0,
           stream>>>(static_cast<const T*>(y), static_cast<const T*>(g),
                     vecs, partial, counters, t1, t2, m, c, p.tx_log2,
                     p.rows_per_chunk);
    return cudaGetLastError();
  }
  static constexpr int kVec = VEC;
};

// f(Reduce<...>{}) for the instantiation of (dtype, vectorized, act). The
// SiLU's arithmetic (an expf and a division an element) outweighs the
// bytes, so its threads take half as many channels (8-byte loads): fewer
// registers, two blocks an SM.
template <typename F>
auto with_reduce(int dtype, int vectorized, int act, F&& f) {
  using bf16 = __nv_bfloat16;
  if (dtype == 1) {
    if (!vectorized) {
      return act ? f(Reduce<bf16, 1, true>{}) : f(Reduce<bf16, 1, false>{});
    }
    return act ? f(Reduce<bf16, 4, true>{}) : f(Reduce<bf16, 8, false>{});
  }
  if (!vectorized) {
    return act ? f(Reduce<float, 1, true>{}) : f(Reduce<float, 1, false>{});
  }
  return act ? f(Reduce<float, 2, true>{}) : f(Reduce<float, 4, false>{});
}

// ---- elem --------------------------------------------------------------

// Layout of one elem launch: block (TX, TY) over channel tile blockIdx.y
// and rows [row0, row1) of chunk blockIdx.x.
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
bn_act_elem_kernel(const T* __restrict__ y, const T* __restrict__ g,
                   const Vecs vecs, const float* __restrict__ t1m_p,
                   const float* __restrict__ t2m_p, T* __restrict__ dy,
                   int64_t m, int c, int64_t rows_per_chunk, int act) {
  const Tile t = tile_of(VEC, m, rows_per_chunk);
  if (t.c0 >= c) return;
  Chan ch[VEC];
  float scale[VEC], t1m[VEC], t2m[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ch[i] = chan_of(vecs, t.c0 + i);
    t1m[i] = t1m_p[t.c0 + i];
    t2m[i] = t2m_p[t.c0 + i];
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

// Block shape and grid of the elem pass for (m, c) at vector width vec.
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
cudaError_t elem_launch(const void* y, const void* g, const Vecs& vecs,
                        const float* t1m, const float* t2m, void* dy,
                        int64_t m, int c, int act, cudaStream_t stream) {
  const Plan p = plan(m, c, VEC);
  bn_act_elem_kernel<T, VEC><<<p.grid, p.block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), vecs, t1m, t2m,
      static_cast<T*>(dy), m, c, p.rows_per_chunk, act);
  return cudaGetLastError();
}

bool bad_args(int64_t m, int c, int dtype, int vectorized) {
  return m < 1 || c < 1 || dtype < 0 || dtype > 1 || vectorized < 0 ||
         vectorized > 1;
}

Vecs vecs_of(const void* mean, const void* r, const void* gamma,
             const void* beta) {
  return {static_cast<const float*>(mean), static_cast<const float*>(r),
          static_cast<const float*>(gamma), static_cast<const float*>(beta)};
}

}  // namespace

extern "C" {

// The reduce pass's workspace for (m, c) on the current device: the f32
// elements of its partial-sum scratch and the number of channel tiles,
// each of which needs one unsigned counter that is 0 before the launch
// (the kernel leaves it 0). vectorized: 1 = 16-byte loads (C divisible
// by 8 for bf16 / 4 for f32 and 16-byte aligned pointers), 0 = one
// element. act: 1 with the SiLU (its launches take another grid). Returns
// 0, or -1 on bad arguments.
int bn_act_reduce_workspace(int64_t m, int c, int dtype, int vectorized,
                            int act, int64_t* partial_floats,
                            int* counters) {
  if (bad_args(m, c, dtype, vectorized)) return -1;
  with_reduce(dtype, vectorized, act, [&](auto r) {
    const ReducePlan p = r.plan(m, c);
    *partial_floats = static_cast<int64_t>(p.tiles) * p.chunks * 2 *
                      (int64_t{1} << p.tx_log2) * r.kVec;
    *counters = p.tiles;
    return 0;
  });
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (y and g). mean, r, gamma, beta: (C,)
// f32. partial, counters: the workspace (bn_act_reduce_workspace); t1,
// t2: (C,) f32. One launch; returns cudaGetLastError() after it (0 on
// success).
int bn_act_reduce(const void* y, const void* g, const void* mean,
                  const void* r, const void* gamma, const void* beta,
                  void* partial, void* counters, void* t1, void* t2,
                  int64_t m, int c, int dtype, int vectorized, int act,
                  void* stream) {
  if (bad_args(m, c, dtype, vectorized)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vecs v = vecs_of(mean, r, gamma, beta);
  return static_cast<int>(with_reduce(dtype, vectorized, act, [&](auto k) {
    return k.launch(y, g, v, static_cast<float*>(partial),
                    static_cast<unsigned*>(counters),
                    static_cast<float*>(t1), static_cast<float*>(t2), m, c,
                    st);
  }));
}

// mean, r, gamma, beta, t1m (T1/M), t2m (T2/M): (C,) f32. dy: (M, C) in
// y's type. Returns cudaGetLastError() after the launch (0 on success).
int bn_act_elem(const void* y, const void* g, const void* mean,
                const void* r, const void* gamma, const void* beta,
                const void* t1m, const void* t2m, void* dy, int64_t m, int c,
                int dtype, int vectorized, int act, void* stream) {
  if (bad_args(m, c, dtype, vectorized)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vecs v = vecs_of(mean, r, gamma, beta);
  const float* a = static_cast<const float*>(t1m);
  const float* b = static_cast<const float*>(t2m);
  cudaError_t err;
  if (dtype == 1) {
    err = vectorized
              ? elem_launch<__nv_bfloat16, 8>(y, g, v, a, b, dy, m, c, act, st)
              : elem_launch<__nv_bfloat16, 1>(y, g, v, a, b, dy, m, c, act,
                                              st);
  } else {
    err = vectorized ? elem_launch<float, 4>(y, g, v, a, b, dy, m, c, act, st)
                     : elem_launch<float, 1>(y, g, v, a, b, dy, m, c, act, st);
  }
  return static_cast<int>(err);
}

const char* bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
