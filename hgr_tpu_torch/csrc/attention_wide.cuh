// Attention bodies for head widths above 256 (attention_qkv_fwd.cu,
// attention_qkv_bwd.cu route every head_dim > 256 here, packed and split,
// float32 and bfloat16), on Hopper's tensor cores.
//
// Same function as the narrower bodies and as the TPU kernels they
// replace (hgr_tpu/ops/attention_pallas.py:51 _attention_qkv_kernel and
// :175 _attention_qkv_bwd_kernel, which take any static head width):
//   s = (q . k) * scale in f32, keys >= n never enter, f32 softmax,
//   P rounded to the compute type T before P v and in dv = P^T g,
//   dS = P (dA - rowsum(dA P)) scale from the f32 P.
//
// Layout. The head width D is padded with zero features to Dp, a multiple
// of 64. A block is eight warps; its score tiles are A rows (queries) by B
// rows (keys): 64 x 32 in bf16, 64 x 16 (forward) and 32 x 16 (backward)
// in f32, cut into 16 x 16 (bf16) or 16 x 8 (f32) pieces, one a warp (the
// f32 backward's four pieces leave four warps out of the scores). Each
// score tile is computed once per pass over all Dp features, from rows
// staged in shared memory, 512 features a row (1,040 bytes in bf16, 2,064
// in f32: 16 mod 128 bytes, so ldmatrix and the f32 fragment reads meet no
// bank conflict):
//   bf16: mma.sync m16n8k16 with ldmatrix fragments (attention_mma.cuh),
//         the 16-feature steps alternating between two accumulators;
//   f32:  the three-way TF32 split of attention_tf32.cuh, x . y as
//         big_x small_y + small_x big_y + big_x big_y on m16n8k8, big the
//         TF32 rounding of x (integer add and mask) and small = x - big,
//         whose low 13 bits the mma ignores (a truncation of ~2^-21 of x,
//         inside the f32 tolerances); the cross and big terms of even and
//         odd steps in four accumulators, added into the scores every 64
//         features.
// P (or dS), rounded to T (dS in bf16 as three parts, each the rounding of
// what the parts before leave out, as the narrower bf16 bodies), goes to a
// plane in shared memory that all eight warps read: each warp owns the
// 16-feature output blocks w, w + 8, w + 16 and w + 24 of every output row
// of the block (no lane holds more than 128 f32 accumulators) and takes
// the plane as the A operand, the staged rows of V, K, Q or G as the B
// operand (ldmatrix.trans in bf16).
//
// Staging. While Dp <= 512 (the 2 x 384 step and every width chip_smoke
// times), the block's own rows stay staged for the whole kernel and the
// other side's chunks are filled by Hopper's bulk copies (cp.async.bulk,
// one a row, issued by one warp, completing on an mbarrier a buffer),
// the next chunk's copies in flight while the current one's products run:
// the bf16 forward keeps two chunks of K and two of V in four buffers, the
// other kernels alternate their two operands' buffers. A row that is not
// 16-byte aligned is staged element by element. Wider heads stage every
// operand 512 features at a time (cp.async) and sum the scores over the
// groups in the same order; a block writes at most 512 output features
// (grid x = row tiles x output groups), each computing the scores again.
//
// Forward: one kernel, two sweeps over the keys (the rows' max and sum,
// then P normalised in f32, rounded to T and multiplied into V), as the
// key-chunked route of the narrower bodies: P is rounded after the
// normalisation, as the Pallas kernel does, so the output cannot be
// rescaled online. The two warps that share a row each keep the max and
// sum of their keys; the pair is merged after the first sweep.
// Backward: two kernels over the same score tiles, in the same
// orientation (Q and G the A operand, K and V the B operand), pieces and
// product order, so both see the same P bits:
//   wide_bwd_q: per query tile, sweep 0 takes each row's max, sum and rd =
//     sum_j dA P into the (B, H, 3, pad16 N) f32 statistics scratch of the
//     key-chunked route, sweep 1 dq = dS K;
//   wide_bwd_k: per key tile, sweeping the queries a tile at a time with
//     their saved statistics, dk = dS^T Q and dv = round(P)^T G (P^T and
//     dS^T written transposed into their planes).
// Each gradient element is summed by one lane in a fixed order: no
// atomics, deterministic.
//
// Bound: at (B, N, H, D) the function moves its inputs and outputs once,
// (4 B N H D) elements forward, (7 B N H D) backward, against 4 B H N^2 D
// and 10 B H N^2 D operations: bound by the operations from N ~ 100 on.
// These bodies do more: the scores twice in the forward (3 products of
// 2 N^2 D a head against the function's 2), S and dA three times in the
// backward and dS in three bf16 parts into dq and dk (13 products against
// 5; 9 in f32, each three TF32 products); and each 64-query tile reads the
// head's K and V again (twice K in the forward) from L2. On an H100,
// removing one part at a time (PERF.md section 6) put the bf16
// forward at (16, 785, 2 x 512) at ~0.28 ms of scores, ~0.34 of chunk
// copies from L2 (~3 TB/s) and ~0.07 of P V out of 0.78, before the
// forward's four buffers; the f32 bodies are bound by their score
// products' issue (three instructions to split each value a read).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace attn_wide {

using bf16 = __nv_bfloat16;

constexpr int kNarrowest = 257;        // the first head width routed here
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOut = 512;              // output features per block
constexpr int kOwn = 4;                // 16-feature output blocks per warp
constexpr int kSlice = 64;             // Dp is a multiple of it

// Per compute type: elements of a staged row (a group of kGroup features
// and 16 bytes of padding: 1,040 bytes in bf16, 2,064 in f32, both 16 mod
// 128 bytes, so ldmatrix and the f32 fragment reads meet no bank
// conflict), bf16 parts of dS, the padding of a plane's row, the 8-key C
// tiles of a warp's score piece, the score tiles (the forward's queries a
// block, the backward's queries a tile, keys a tile), and the forward's
// buffers of key chunks (K and V). The f32 tiles are smaller, so that the
// block's own rows stay staged at 512 features in one block's shared
// memory; bf16 has room for two chunks of K and of V in flight.
constexpr int kGroup = 512;
template <typename T>
struct Kind;
template <>
struct Kind<bf16> {
  static constexpr int kStride = kGroup + 8;
  static constexpr int kParts = 3;
  static constexpr int kPlanePad = 8;  // ldmatrix rows of 80 or 144 bytes
  static constexpr int kNT = 2;
  static constexpr int kFwdRows = 64;
  static constexpr int kRows = 64;
  static constexpr int kKeys = 32;
  static constexpr int kFwdBuffers = 4;
};
template <>
struct Kind<float> {
  static constexpr int kStride = kGroup + 4;
  static constexpr int kParts = 1;
  static constexpr int kPlanePad = 4;  // a row of 20 or 36 words
  static constexpr int kNT = 1;
  static constexpr int kFwdRows = 64;
  static constexpr int kRows = 32;
  static constexpr int kKeys = 16;
  static constexpr int kFwdBuffers = 2;
};

__host__ __device__ inline int pad_width(int d) {
  return (d + kSlice - 1) / kSlice * kSlice;
}
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of each kernel, bytes: the staged buffers' mbarriers
// (Bars), staged rows, planes, merge space.
constexpr int kBarBytes = 64;  // up to eight
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return Kind<T>::kStride * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int plane_bytes(int rows, int cols) {
  return rows * (cols + Kind<T>::kPlanePad) * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int fwd_smem() {
  return kBarBytes +
         (Kind<T>::kFwdRows + Kind<T>::kFwdBuffers * Kind<T>::kKeys) *
             row_bytes<T>() +
         plane_bytes<T>(Kind<T>::kFwdRows, Kind<T>::kKeys) +
         2 * Kind<T>::kFwdRows * 2 * 4;
}
template <typename T>
__host__ __device__ constexpr int bwd_q_smem() {
  return kBarBytes +
         (2 * Kind<T>::kRows + 2 * Kind<T>::kKeys) * row_bytes<T>() +
         Kind<T>::kParts * plane_bytes<T>(Kind<T>::kRows, Kind<T>::kKeys) +
         2 * Kind<T>::kRows * 3 * 4;
}
template <typename T>
__host__ __device__ constexpr int bwd_k_smem() {
  return kBarBytes +
         (2 * Kind<T>::kRows + 2 * Kind<T>::kKeys) * row_bytes<T>() +
         (1 + Kind<T>::kParts) *
             plane_bytes<T>(Kind<T>::kKeys, Kind<T>::kRows);
}
static_assert(fwd_smem<bf16>() <= 232448 && bwd_q_smem<bf16>() <= 232448 &&
                  bwd_k_smem<bf16>() <= 232448 &&
                  fwd_smem<float>() <= 232448 &&
                  bwd_q_smem<float>() <= 232448 &&
                  bwd_k_smem<float>() <= 232448,
              "one block's shared memory");

// The warp's piece of an A x B score tile: 16 A rows (a0..) by 8 NT B
// rows (b0..); warps from kCount on hold none. The kPB warps of a row
// band (pb = 0..kPB-1) share its rows.
template <int A, int B, int NT>
struct Piece {
  static constexpr int kPA = A / 16;
  static constexpr int kPB = B / (8 * NT);
  static constexpr int kCount = kPA * kPB;
  static_assert(kCount <= kWarps && kPB == 2, "two pieces a row band");
  bool on;
  int a0, b0, pb;
  __device__ __forceinline__ explicit Piece(int warp)
      : on(warp < kCount),
        a0(16 * (warp % kPA)),
        b0(8 * NT * ((warp / kPA) % kPB)),
        pb((warp / kPA) % kPB) {}
};

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

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Stage rows [0, cnt) of src (row stride ``row`` elements), features
// [f0, f0 + width) (width a multiple of kSlice), into dst (Kind<T>::kStride
// elements a row): features at or beyond d and rows cnt..rows-1 are zero,
// so that products over the staged tile see zeros and never stale shared
// memory. A warp a row, its lanes along the row: 16-byte cp.async copies
// where src is 16-byte aligned and the row stride and d are multiples of
// 16 bytes, else element by element. The caller commits, waits and
// synchronises.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t row,
                                      T* dst, int cnt, int rows, int f0,
                                      int width, int d) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kS = Kind<T>::kStride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % kE == 0 &&
      d % kE == 0) {
    const int chunks = width / kE;
    for (int j = warp; j < rows; j += kWarps) {
      T* to = dst + j * kS;
      for (int c = lane; c < chunks; c += 32) {
        const int f = f0 + c * kE;
        if (j < cnt && f < d) {
          attn_mma::cp_async16(to + c * kE, src + j * row + f);
        } else {
          *reinterpret_cast<uint4*>(to + c * kE) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  } else {
    for (int j = warp; j < rows; j += kWarps) {
      T* to = dst + j * kS;
      for (int c = lane; c < width; c += 32) {
        const int f = f0 + c;
        to[c] = j < cnt && f < d ? src[j * row + f] : zero_of<T>();
      }
    }
  }
}

// Hopper's bulk copy (the TMA without a tensor map): ``bytes`` (a multiple
// of 16, both addresses 16-byte aligned) from global src to shared dst,
// completing on the mbarrier ``bar``'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(attn_mma::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(attn_mma::smem_addr(bar))
      : "memory");
}

// Arrive on ``bar`` expecting ``bytes`` of bulk copies on it.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(attn_mma::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The mbarriers of a kernel's staged buffers, one each (arrival count 1:
// the fill's arrive), and the parity each one completes with next.
struct Bars {
  uint64_t* bar;
  unsigned phase = 0;
  __device__ __forceinline__ explicit Bars(void* at)
      : bar(static_cast<uint64_t*>(at)) {}
  // thread 0; the caller synchronises before the first fill
  __device__ __forceinline__ void init(int count) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < count; ++i) attn_mma::mbar_init(bar + i, 1);
      attn_mma::mbar_fence_init();
    }
  }
  __device__ __forceinline__ void wait(int i) {
    attn_mma::mbar_wait(bar + i, (phase >> i) & 1u);
    phase ^= 1u << i;
  }
};
// Zero columns d..Dp-1 of ``rows`` staged rows (once, when the kernel
// starts: fill's bulk copies write columns 0..d-1 only).
template <typename T>
__device__ __forceinline__ void zero_pad(T* dst, int rows, int d, int dp) {
  constexpr int kS = Kind<T>::kStride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < rows; j += kWarps) {
    for (int c = d + lane; c < dp; c += 32) dst[j * kS + c] = zero_of<T>();
  }
}

// Fill staged rows with global rows [0, cnt) of src (all threads call
// it): rows cnt..rows-1 zeroed, then one bulk copy of d elements a row,
// issued by warp 0 on ``bar``. Where the rows do not allow bulk copies
// (16-byte alignment), element by element (stage) and a plain arrive. The
// consumer waits on ``bar`` and synchronises the block (the zero stores).
template <typename T>
__device__ __forceinline__ void fill(const T* __restrict__ src, int64_t row,
                                     T* dst, int cnt, int rows, int d,
                                     uint64_t* bar) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kS = Kind<T>::kStride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % kE == 0 &&
      d % kE == 0) {
    for (int j = cnt + warp; j < rows; j += kWarps) {
      for (int c = lane; c < kS / kE; c += 32) {
        *reinterpret_cast<uint4*>(dst + j * kS + c * kE) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (warp == 0) {
      const unsigned bytes = d * static_cast<unsigned>(sizeof(T));
      if (lane == 0) expect_bytes(bar, bytes * cnt);
      __syncwarp();
      for (int j = lane; j < cnt; j += 32) {
        bulk_copy(dst + j * kS, src + j * row, bytes, bar);
      }
    }
  } else {
    stage(src, row, dst, cnt, rows, 0, pad_width(d), d);
    if (threadIdx.x == 0) attn_mma::mbar_arrive(bar);
  }
}

// ---- Score products: a warp's piece of NT C tiles (16 x 8 each) of A
// rows a0..a0+15 against B rows b0..b0+8NT-1 over ``width`` staged
// features.

// bf16: the 16-feature steps alternate between c0 and c1 (independent mma
// chains), summed when the scores are read.
template <int NT>
struct Scores16 {
  float c0[NT][4], c1[NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c0[j][e] = c1[j][e] = 0.f;
    }
  }
  __device__ __forceinline__ void read(float (&s)[NT][4]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(c0[j][e], c1[j][e]);
    }
  }
};

// f32: the running scores, into which each 64 features' cross and big
// terms are added.
template <int NT>
struct Scores32 {
  float s[NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
  }
  __device__ __forceinline__ void read(float (&out)[NT][4]) const {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j][e] = s[j][e];
    }
  }
};

template <typename T>
struct ScoresOf;
template <>
struct ScoresOf<bf16> {
  using type = Scores16<Kind<bf16>::kNT>;
};
template <>
struct ScoresOf<float> {
  using type = Scores32<Kind<float>::kNT>;
};

// Lane addressing (attention_mma.cuh): A tiles row a0 + lane % 16, column
// 8 (lane / 16); B tiles (rows of B^T's columns) row b0 + lane % 8, column
// 8 (lane / 8), four 8 x 8 matrices = 32 features of 8 rows.
template <int NT>
__device__ __forceinline__ void score_products(Scores16<NT>& acc,
                                               const bf16* a, int a0,
                                               const bf16* b, int b0,
                                               int width, int lane) {
  constexpr int kS = Kind<bf16>::kStride;
  const bf16* pa = a + (a0 + (lane & 15)) * kS + (lane >> 4) * 8;
  const bf16* pb = b + (b0 + (lane & 7)) * kS + (lane >> 3) * 8;
#pragma unroll 2
  for (int f = 0; f < width; f += 32) {
    uint32_t a0f[4], a1f[4], bt[NT][4];
    attn_mma::ldsm_x4(a0f, pa + f);
    attn_mma::ldsm_x4(a1f, pa + f + 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) attn_mma::ldsm_x4(bt[j], pb + 8 * j * kS + f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      attn_mma::mma(acc.c0[j], a0f, bt[j][0], bt[j][1]);
      attn_mma::mma(acc.c1[j], a1f, bt[j][2], bt[j][3]);
    }
  }
}

// x as TF32 big and small parts: big rounded to nearest (the integer add
// and mask, exact for every finite x), small = x - big (exact in f32),
// whose low 13 bits the mma ignores. A NaN of x stays NaN in small.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// f32 (m16n8k8 TF32 fragments, attention_tf32.cuh): A (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (row t, column g) = B row g, feature t.
// The cross and big terms of the even and the odd 8-feature steps go to
// four accumulators (independent mma chains), added into the scores every
// 64 features.
template <int NT>
__device__ __forceinline__ void score_products(Scores32<NT>& acc,
                                               const float* a, int a0,
                                               const float* b, int b0,
                                               int width, int lane) {
  constexpr int kS = Kind<float>::kStride;
  const int g = lane >> 2, t = lane & 3;
  const float* pa = a + (a0 + g) * kS + t;
  const float* pb = b + (b0 + g) * kS + t;
  for (int f0 = 0; f0 < width; f0 += kSlice) {
    float x[2][NT][4] = {}, y[2][NT][4] = {};  // cross, big terms
#pragma unroll
    for (int f = f0; f < f0 + kSlice; f += 8) {
      const int u = (f >> 3) & 1;
      uint32_t ab[4], as[4];
      split(pa[f], ab[0], as[0]);
      split(pa[8 * kS + f], ab[1], as[1]);
      split(pa[f + 4], ab[2], as[2]);
      split(pa[8 * kS + f + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[2], bs[2];
        split(pb[8 * j * kS + f], bb[0], bs[0]);
        split(pb[8 * j * kS + f + 4], bb[1], bs[1]);
        attn_tf32::mma(x[u][j], ab, bs[0], bs[1]);
        attn_tf32::mma(x[u][j], as, bb[0], bb[1]);
        attn_tf32::mma(y[u][j], ab, bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cross = __fadd_rn(x[0][j][e], x[1][j][e]);
        const float big = __fadd_rn(y[0][j][e], y[1][j][e]);
        acc.s[j][e] = __fadd_rn(acc.s[j][e], __fadd_rn(cross, big));
      }
    }
  }
}

// s = raw * scale (__fmul_rn, never contracted into what follows), keys at
// or beyond n at -inf; key0: the piece's first key.
template <int NT>
__device__ __forceinline__ void mask_scale(float (&s)[NT][4], int key0,
                                           int n, float scale, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = key0 + 8 * j + 2 * t;
    s[j][0] = c < n ? __fmul_rn(s[j][0], scale) : -INFINITY;
    s[j][1] = c + 1 < n ? __fmul_rn(s[j][1], scale) : -INFINITY;
    s[j][2] = c < n ? __fmul_rn(s[j][2], scale) : -INFINITY;
    s[j][3] = c + 1 < n ? __fmul_rn(s[j][3], scale) : -INFINITY;
  }
}

// ---- Output products: acc[rt][kk][h] (RT row tiles of 16, the warp's
// output blocks kk, C tiles h of 8 features) += A . X over kRowsK rows of
// the k dimension: A from the plane(s) ``a`` (row stride ``as``), X the
// staged rows ``x`` whose column 0 is output feature v0; only the blocks
// inside [v0, v0 + vw) are taken.

// Whether output block kk of ``warp`` lies in [v0, v0 + vw), and its
// column in the staged rows.
__device__ __forceinline__ bool owned(int warp, int kk, int v0, int vw,
                                      int& col) {
  col = 16 * (warp + kWarps * kk) - v0;
  return col >= 0 && col < vw;
}

// bf16: A fragments of every part (kParts planes, ``plane`` elements
// apart) by ldmatrix, X's B fragments by ldmatrix.trans (16 rows x 16
// features a load), parts in order into each accumulator.
template <int RT, int kParts, int kRowsK>
__device__ __forceinline__ void accumulate(float (&acc)[RT][kOwn][2][4],
                                           const bf16* a, int as, int plane,
                                           const bf16* x, int v0, int vw,
                                           int warp, int lane) {
  constexpr int kS = Kind<bf16>::kStride;
#pragma unroll
  for (int k0 = 0; k0 < kRowsK; k0 += 16) {
    uint32_t af[RT][kParts][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        attn_mma::ldsm_x4(af[rt][p], a + p * plane +
                                         (16 * rt + (lane & 15)) * as + k0 +
                                         (lane >> 4) * 8);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kOwn; ++kk) {
      int col;
      if (owned(warp, kk, v0, vw, col)) {
        uint32_t bt[4];
        attn_mma::ldsm_x4_trans(
            bt, x + (k0 + (lane & 15)) * kS + col + (lane >> 4) * 8);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            attn_mma::mma(acc[rt][kk][0], af[rt][p], bt[0], bt[1]);
            attn_mma::mma(acc[rt][kk][1], af[rt][p], bt[2], bt[3]);
          }
        }
      }
    }
  }
}

// f32: A values (row g / g + 8, column t / t + 4) and X's B values (row
// t / t + 4, feature g) read and split as they load, three TF32 products
// an accumulator (cross terms first, as attention_tf32.cuh's mma3).
template <int RT, int kParts, int kRowsK>
__device__ __forceinline__ void accumulate(float (&acc)[RT][kOwn][2][4],
                                           const float* a, int as, int plane,
                                           const float* x, int v0, int vw,
                                           int warp, int lane) {
  static_assert(kParts == 1, "f32 planes hold dS whole");
  constexpr int kS = Kind<float>::kStride;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kRowsK; k0 += 8) {
    uint32_t ab[RT][4], am[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const float* pa = a + (16 * rt + g) * as + k0 + t;
      split(pa[0], ab[rt][0], am[rt][0]);
      split(pa[8 * as], ab[rt][1], am[rt][1]);
      split(pa[4], ab[rt][2], am[rt][2]);
      split(pa[8 * as + 4], ab[rt][3], am[rt][3]);
    }
#pragma unroll
    for (int kk = 0; kk < kOwn; ++kk) {
      int col;
      if (owned(warp, kk, v0, vw, col)) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* pb = x + (k0 + t) * kS + col + 8 * hh + g;
          uint32_t bb[2], bs[2];
          split(pb[0], bb[0], bs[0]);
          split(pb[4 * kS], bb[1], bs[1]);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            attn_tf32::mma(acc[rt][kk][hh], ab[rt], bs[0], bs[1]);
            attn_tf32::mma(acc[rt][kk][hh], am[rt], bb[0], bb[1]);
            attn_tf32::mma(acc[rt][kk][hh], ab[rt], bb[0], bb[1]);
          }
        }
      }
    }
  }
}

// Store the warp's output blocks of rows 0..RT*16-1 (C layout) to dst
// (row 0 of the block, column 0 = output feature o0): rows at or beyond
// ``rows``, features at or beyond ``cols`` (d - o0) skipped.
template <typename T, int RT>
__device__ __forceinline__ void store_out(
    const float (&acc)[RT][kOwn][2][4], T* dst, int64_t row, int rows,
    int cols, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * rt + g + 8 * half;
      if (i >= rows) continue;
      T* p = dst + i * row;
#pragma unroll
      for (int kk = 0; kk < kOwn; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * (warp + kWarps * kk) + 8 * hh + 2 * t;
          if (col < cols) p[col] = narrow<T>(acc[rt][kk][hh][2 * half]);
          if (col + 1 < cols) {
            p[col + 1] = narrow<T>(acc[rt][kk][hh][2 * half + 1]);
          }
        }
      }
    }
  }
}

// ---- Softmax statistics.

template <typename T>
__device__ __forceinline__ float fwd_exp(float x);
// e^x as 2^(x log2 e) on the SFU in the bf16 forward, whose P is rounded
// to bf16 right after (the narrower bf16 forward's softmax_exp)
template <>
__device__ __forceinline__ float fwd_exp<bf16>(float x) {
  return exp2f(x * 1.4426950408889634f);
}
template <>
__device__ __forceinline__ float fwd_exp<float>(float x) {
  return expf(x);
}

// Rows g and g + 8 of the warp's piece: fold one chunk's scores into the
// running max m and sum l of e(s - m) over the piece's keys (the sum
// rescaled when the chunk raises the max). A row whose keys so far are all
// at or beyond n (a piece past the last key) keeps m = -inf, l = 0.
template <typename T, int NT>
__device__ __forceinline__ void fold(const float (&s)[NT][4], float (&m)[2],
                                     float (&l)[2]) {
  float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
    mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
  }
  mc[0] = attn_mma::quad_max(mc[0]);
  mc[1] = attn_mma::quad_max(mc[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = mc[e >> 1];
      sum[e >> 1] += r == -INFINITY ? 0.f : fwd_exp<T>(s[j][e] - r);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = attn_mma::quad_sum(sum[r]);
    if (mc[r] != -INFINITY) {
      l[r] = l[r] * fwd_exp<T>(m[r] - mc[r]) + total;
      m[r] = mc[r];
    }
  }
}

// The backward's fold (expf): m, l and rd = sum dA e(s - m), both sums
// rescaled when the chunk raises the max.
template <int NT>
__device__ __forceinline__ void fold_bwd(const float (&s)[NT][4],
                                         const float (&da)[NT][4],
                                         float (&m)[2], float (&l)[2],
                                         float (&rd)[2]) {
  float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
    mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
  }
  mc[0] = attn_mma::quad_max(mc[0]);
  mc[1] = attn_mma::quad_max(mc[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = mc[e >> 1];
      const float x = r == -INFINITY ? 0.f : expf(s[j][e] - r);
      sum[e >> 1] += x;
      dot[e >> 1] = fmaf(da[j][e], x, dot[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = attn_mma::quad_sum(sum[r]);
    const float dots = attn_mma::quad_sum(dot[r]);
    if (mc[r] != -INFINITY) {
      const float f = expf(m[r] - mc[r]);
      l[r] = l[r] * f + total;
      rd[r] = rd[r] * f + dots;
      m[r] = mc[r];
    }
  }
}

// dS from P, dA and the row's rd, by the same instructions in both kernels
__device__ __forceinline__ float dscore(float p, float da, float rd,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(da, rd)), scale);
}

// The statistics scratch: (B, H, 3, npad) f32, the rows' max, 1 / sum, rd.
__device__ __forceinline__ float* stats_of(float* stats, int b, int h,
                                           int heads, int npad) {
  return stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
}

// Write two adjacent values of a plane row (bf16: rounded; dS in kParts
// bf16 parts, each plane ``plane`` elements after the one before).
template <int kParts>
__device__ __forceinline__ void put_pair(bf16* at, int plane, float x0,
                                         float x1) {
  uint32_t part[kParts];
  attn_mma::pack_split<kParts>(x0, x1, part);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    *reinterpret_cast<uint32_t*>(at + p * plane) = part[p];
  }
}
template <int kParts>
__device__ __forceinline__ void put_pair(float* at, int, float x0, float x1) {
  *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
}

// The same pair into a transposed plane: x0 at ``at``, x1 one row below.
template <int kParts>
__device__ __forceinline__ void put_pair_t(bf16* at, int stride, int plane,
                                           float x0, float x1) {
  uint32_t part[kParts];
  attn_mma::pack_split<kParts>(x0, x1, part);
  uint16_t* h = reinterpret_cast<uint16_t*>(at);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    h[p * plane] = static_cast<uint16_t>(part[p] & 0xffffu);
    h[p * plane + stride] = static_cast<uint16_t>(part[p] >> 16);
  }
}
template <int kParts>
__device__ __forceinline__ void put_pair_t(float* at, int stride, int,
                                           float x0, float x1) {
  at[0] = x0;
  at[stride] = x1;
}

// Merge the two pieces of each row band (keys 0.. and 8 NT.. of every
// chunk) after a sweep: lanes t == 0 of the warps holding pieces write m,
// l (and rd) of rows g, g + 8; both pieces' warps read both halves in the
// same order. merged: (2, A, kStats) floats.
template <int kStats, int A>
__device__ __forceinline__ void merge_stats(float* merged, bool on, int pb,
                                            int a0, int lane, float (&m)[2],
                                            float (&l)[2], float (&rd)[2],
                                            bool exact) {
  const int g = lane >> 2, t = lane & 3;
  if (on && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* at = merged + (pb * A + a0 + g + 8 * r) * kStats;
      at[0] = m[r];
      at[1] = l[r];
      if (kStats == 3) at[2] = rd[r];
    }
  }
  __syncthreads();
  if (!on) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* a = merged + (a0 + g + 8 * r) * kStats;
    const float* b = merged + (A + a0 + g + 8 * r) * kStats;
    const float mm = fmaxf(a[0], b[0]);  // finite: key 0 is in piece 0
    const float fa = exact ? expf(a[0] - mm)
                           : exp2f((a[0] - mm) * 1.4426950408889634f);
    const float fb = exact ? expf(b[0] - mm)
                           : exp2f((b[0] - mm) * 1.4426950408889634f);
    m[r] = mm;
    l[r] = a[1] * fa + b[1] * fb;
    if (kStats == 3) rd[r] = a[2] * fa + b[2] * fb;
  }
}

// ---- Forward: one block per kFwdRows query rows and output group.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(const Rows<const T> q, const Rows<const T> k,
                const Rows<const T> v, const Rows<T> out, int n, int d,
                float scale, int q_tiles) {
  using K = Kind<T>;
  constexpr int kS = K::kStride;
  constexpr int kA = K::kFwdRows;
  constexpr int kB = K::kKeys;
  constexpr int kNT = K::kNT;
  constexpr int kPS = kB + K::kPlanePad;  // P plane row
  extern __shared__ uint4 wide_smem[];
  Bars bars(wide_smem);
  constexpr int kBuf = K::kFwdBuffers;  // key-chunk buffers
  constexpr int kKV = kBuf / 2;          // of them for K (and for V)
  T* qs = reinterpret_cast<T*>(wide_smem + kBarBytes / 16);
  T* ks = qs + kA * kS;  // buffer i at ks + i kB kS; V's from kKV on
  T* vs = ks + kKV * kB * kS;
  T* ps = ks + kBuf * kB * kS;
  float* merged = reinterpret_cast<float*>(ps + kA * kPS);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % q_tiles) * kA;
  const int o0 = (blockIdx.x / q_tiles) * kOut;
  const int na = min(kA, n - row0);
  const int dp = pad_width(d);
  const int groups = cdiv(dp, kGroup);
  const int ow = min(kOut, dp - o0);
  const Piece<kA, kB, kNT> pc(warp);
  const T* qh = q.at(b, h, d, row0);
  const T* kh = k.at(b, h, d, 0);
  const T* vh = v.at(b, h, d, 0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float rd[2] = {0.f, 0.f};  // unused here (merge_stats' signature)
  float inv[2] = {0.f, 0.f};
  float o[kA / 16][kOwn][2][4] = {};
  float s[kNT][4];
  const int chunks = cdiv(n, kB);
  // K or V rows of chunk c (features f0.., width) into dst
  auto stage_kv = [&](const T* src, int64_t row, T* dst, int c, int f0,
                      int width) {
    stage(src + static_cast<int64_t>(c) * kB * row, row, dst,
          min(kB, n - c * kB), kB, f0, width, d);
  };
  auto fill_kv = [&](const T* src, int64_t row, T* dst, int c, uint64_t* bar) {
    fill(src + static_cast<int64_t>(c) * kB * row, row, dst,
         min(kB, n - c * kB), kB, d, bar);
  };
  // the piece's scores of chunk c
  auto scores = [&](typename ScoresOf<T>::type& acc, int c) {
    acc.read(s);
    mask_scale(s, c * kB + pc.b0, n, scale, lane);
  };
  auto write_p = [&]() {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      T* at = ps + (pc.a0 + g) * kPS + pc.b0 + 8 * j + 2 * t;
      put_pair<1>(at, 0, fwd_exp<T>(s[j][0] - m[0]) * inv[0],
                  fwd_exp<T>(s[j][1] - m[0]) * inv[0]);
      put_pair<1>(at + 8 * kPS, 0, fwd_exp<T>(s[j][2] - m[1]) * inv[1],
                  fwd_exp<T>(s[j][3] - m[1]) * inv[1]);
    }
  };
  auto merge = [&]() {
    merge_stats<2, kA>(merged, pc.on, pc.pb, pc.a0, lane, m, l, rd,
                       sizeof(T) == 4);
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
  };

  if (groups == 1) {
    // Q stays staged (barrier 0), and kBuf buffers of key chunks (barriers
    // 1..kBuf) take the copies of chunks ahead while the products run: the
    // first sweep's K chunks pass through all of them (kBuf - 1 ahead), the
    // second sweep's K and V through kKV each (K(c + kKV) lands during P
    // V(c), V(c + kKV) during the scores of c + 1).
    auto buf = [&](int i) { return ks + i * kB * kS; };
    bars.init(1 + kBuf);
    zero_pad(qs, kA + kBuf * kB, d, dp);
    __syncthreads();
    fill(qh, q.row, qs, na, kA, d, bars.bar);
    for (int c = 0; c < kBuf - 1 && c < chunks; ++c) {
      fill_kv(kh, k.row, buf(c), c, bars.bar + 1 + c);
    }
    bars.wait(0);
    for (int c = 0; c < chunks; ++c) {
      const int u = c % kBuf;
      const int ahead = c + kBuf - 1;
      if (ahead < chunks) {
        fill_kv(kh, k.row, buf(ahead % kBuf), ahead,
                bars.bar + 1 + ahead % kBuf);
      }
      bars.wait(1 + u);
      __syncthreads();
      if (pc.on) {
        typename ScoresOf<T>::type acc;
        acc.zero();
        score_products(acc, qs, pc.a0, buf(u), pc.b0, dp, lane);
        scores(acc, c);
        fold<T>(s, m, l);
      }
      __syncthreads();  // this buffer is free for chunk c + kBuf
    }
    merge();
    for (int c = 0; c < kKV && c < chunks; ++c) {
      fill_kv(kh, k.row, buf(c), c, bars.bar + 1 + c);
      fill_kv(vh, v.row, buf(kKV + c), c, bars.bar + 1 + kKV + c);
    }
    for (int c = 0; c < chunks; ++c) {
      const int u = c % kKV;
      bars.wait(1 + u);  // K(c)
      __syncthreads();
      if (pc.on) {
        typename ScoresOf<T>::type acc;
        acc.zero();
        score_products(acc, qs, pc.a0, buf(u), pc.b0, dp, lane);
        scores(acc, c);
      }
      __syncthreads();  // K(c) read
      if (c + kKV < chunks) {
        fill_kv(kh, k.row, buf(u), c + kKV, bars.bar + 1 + u);
      }
      if (pc.on) write_p();
      bars.wait(1 + kKV + u);  // V(c)
      __syncthreads();
      accumulate<kA / 16, 1, kB>(o, ps, kPS, 0, buf(kKV + u), 0, ow, warp,
                                 lane);
      __syncthreads();  // V(c) and P read
      if (c + kKV < chunks) {
        fill_kv(vh, v.row, buf(kKV + u), c + kKV, bars.bar + 1 + kKV + u);
      }
    }
  } else {
    // wider heads: Q and K staged a feature group at a time for every
    // chunk, V at the block's output features
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int c = 0; c < chunks; ++c) {
        typename ScoresOf<T>::type acc;
        acc.zero();
        for (int f0 = 0; f0 < dp; f0 += kGroup) {
          const int width = min(kGroup, dp - f0);
          __syncthreads();  // the staged rows and the P plane are free
          stage(qh, q.row, qs, na, kA, f0, width, d);
          stage_kv(kh, k.row, ks, c, f0, width);
          attn_mma::cp_async_commit();
          attn_mma::cp_async_wait<0>();
          __syncthreads();
          if (pc.on) score_products(acc, qs, pc.a0, ks, pc.b0, width, lane);
        }
        if (pc.on) scores(acc, c);
        if (sweep == 0) {
          if (pc.on) fold<T>(s, m, l);
          continue;
        }
        if (pc.on) write_p();
        __syncthreads();
        stage_kv(vh, v.row, vs, c, o0, ow);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<0>();
        __syncthreads();  // P written, V staged
        accumulate<kA / 16, 1, kB>(o, ps, kPS, 0, vs, 0, ow, warp, lane);
      }
      if (sweep == 0) merge();
    }
  }
  store_out<T, kA / 16>(o, out.at(b, h, d, row0) + o0, out.row, na, d - o0,
                        warp, lane);
}

// ---- Backward, phase 1: one block per kRows query rows and output group
// -> the rows' max, 1 / sum and rd (output group 0 writes them) and dq.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wide_bwd_q_kernel(const Rows<const T> q, const Rows<const T> k,
                  const Rows<const T> v, const Rows<const T> g_op,
                  const Rows<T> dq, float* __restrict__ stats, int n,
                  int heads, int d, float scale, int q_tiles) {
  using K = Kind<T>;
  constexpr int kS = K::kStride;
  constexpr int kA = K::kRows;
  constexpr int kB = K::kKeys;
  constexpr int kNT = K::kNT;
  constexpr int kPS = kB + K::kPlanePad;
  constexpr int kPlane = kA * kPS;
  extern __shared__ uint4 wide_smem[];
  Bars bars(wide_smem);
  T* qs = reinterpret_cast<T*>(wide_smem + kBarBytes / 16);
  T* gs = qs + kA * kS;
  T* ks = gs + kA * kS;
  T* vs = ks + kB * kS;
  T* ds = vs + kB * kS;  // kParts planes of dS
  float* merged = reinterpret_cast<float*>(ds + K::kParts * kPlane);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % q_tiles) * kA;
  const int o0 = (blockIdx.x / q_tiles) * kOut;
  const int na = min(kA, n - row0);
  const int dp = pad_width(d);
  const int groups = cdiv(dp, kGroup);
  const int ow = min(kOut, dp - o0);
  const Piece<kA, kB, kNT> pc(warp);
  const T* qh = q.at(b, h, d, row0);
  const T* gh = g_op.at(b, h, d, row0);
  const T* kh = k.at(b, h, d, 0);
  const T* vh = v.at(b, h, d, 0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float acc_dq[kA / 16][kOwn][2][4] = {};
  float s[kNT][4], da[kNT][4];
  const int chunks = cdiv(n, kB);
  auto stage_kv = [&](const T* src, int64_t row, T* dst, int c, int f0,
                      int width) {
    stage(src + static_cast<int64_t>(c) * kB * row, row, dst,
          min(kB, n - c * kB), kB, f0, width, d);
  };
  auto fill_kv = [&](const T* src, int64_t row, T* dst, int c, uint64_t* bar) {
    fill(src + static_cast<int64_t>(c) * kB * row, row, dst,
         min(kB, n - c * kB), kB, d, bar);
  };
  // the piece's S and dA read; then the fold (sweep 0) or dS into the
  // planes (sweep 1; keys >= n: P = 0, dA = 0)
  auto finish = [&](const typename ScoresOf<T>::type& sa,
                    const typename ScoresOf<T>::type& dacc, int c,
                    int sweep) {
    sa.read(s);
    dacc.read(da);
    mask_scale(s, c * kB + pc.b0, n, scale, lane);
    if (sweep == 0) {
      fold_bwd(s, da, m, l, rd);
      return;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        x[e] = dscore(expf(s[j][e] - m[r]) * inv[r], da[j][e], rd[r], scale);
      }
      T* at = ds + (pc.a0 + g) * kPS + pc.b0 + 8 * j + 2 * t;
      put_pair<K::kParts>(at, kPlane, x[0], x[1]);
      put_pair<K::kParts>(at + 8 * kPS, kPlane, x[2], x[3]);
    }
  };
  auto merge = [&]() {
    merge_stats<3, kA>(merged, pc.on, pc.pb, pc.a0, lane, m, l, rd, true);
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
    rd[0] *= inv[0];
    rd[1] *= inv[1];
  };

  if (groups == 1) {
    // Q and G stay staged (barriers 0, 1); V(c + 1) lands during Q K^T,
    // dS and dS K of c (barrier 3), K(c + 1) during G V^T of c + 1 (2)
    bars.init(4);
    zero_pad(qs, 2 * kA + 2 * kB, d, dp);
    __syncthreads();
    fill(qh, q.row, qs, na, kA, d, bars.bar);
    fill(gh, g_op.row, gs, na, kA, d, bars.bar + 1);
    bars.wait(0);
    bars.wait(1);
    for (int sweep = 0; sweep < 2; ++sweep) {
      fill_kv(vh, v.row, vs, 0, bars.bar + 3);
      fill_kv(kh, k.row, ks, 0, bars.bar + 2);
      for (int c = 0; c < chunks; ++c) {
        typename ScoresOf<T>::type sa, dacc;
        bars.wait(3);  // V(c)
        __syncthreads();
        if (pc.on) {
          dacc.zero();
          score_products(dacc, gs, pc.a0, vs, pc.b0, dp, lane);
        }
        __syncthreads();  // V(c) read
        if (c + 1 < chunks) fill_kv(vh, v.row, vs, c + 1, bars.bar + 3);
        bars.wait(2);  // K(c)
        __syncthreads();
        if (pc.on) {
          sa.zero();
          score_products(sa, qs, pc.a0, ks, pc.b0, dp, lane);
          finish(sa, dacc, c, sweep);
        }
        if (sweep == 1) {
          __syncthreads();  // dS written
          accumulate<kA / 16, K::kParts, kB>(acc_dq, ds, kPS, kPlane, ks, 0,
                                             ow, warp, lane);
        }
        __syncthreads();  // K(c) and dS read
        if (c + 1 < chunks) fill_kv(kh, k.row, ks, c + 1, bars.bar + 2);
      }
      if (sweep == 0) merge();
    }
  } else {
    // wider heads: every operand staged a feature group at a time for
    // every chunk, K again at the block's output features for dq
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int c = 0; c < chunks; ++c) {
        typename ScoresOf<T>::type sa, dacc;
        sa.zero();
        dacc.zero();
        for (int f0 = 0; f0 < dp; f0 += kGroup) {
          const int width = min(kGroup, dp - f0);
          __syncthreads();  // the staged rows and the dS planes are free
          stage(qh, q.row, qs, na, kA, f0, width, d);
          stage(gh, g_op.row, gs, na, kA, f0, width, d);
          stage_kv(kh, k.row, ks, c, f0, width);
          stage_kv(vh, v.row, vs, c, f0, width);
          attn_mma::cp_async_commit();
          attn_mma::cp_async_wait<0>();
          __syncthreads();
          if (pc.on) {
            score_products(dacc, gs, pc.a0, vs, pc.b0, width, lane);
            score_products(sa, qs, pc.a0, ks, pc.b0, width, lane);
          }
        }
        if (pc.on) finish(sa, dacc, c, sweep);
        if (sweep == 0) continue;
        __syncthreads();  // dS written, the scores' reads of K done
        stage_kv(kh, k.row, ks, c, o0, ow);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<0>();
        __syncthreads();
        accumulate<kA / 16, K::kParts, kB>(acc_dq, ds, kPS, kPlane, ks, 0, ow,
                                           warp, lane);
      }
      if (sweep == 0) merge();
    }
  }
  store_out<T, kA / 16>(acc_dq, dq.at(b, h, d, row0) + o0, dq.row, na,
                        d - o0, warp, lane);
  if (o0 == 0 && pc.on && pc.pb == 0 && t == 0) {
    const int npad = pad16(n);
    float* st = stats_of(stats, b, h, heads, npad);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + pc.a0 + g + 8 * r;
      if (i < npad) {
        st[i] = m[r];
        st[npad + i] = inv[r];
        st[2 * npad + i] = rd[r];
      }
    }
  }
}

// ---- Backward, phase 2: one block per kKeys key rows and output group,
// sweeping the queries kRows at a time with their saved statistics -> dk,
// dv. The score tiles are the query kernel's, Q and G the A operand.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wide_bwd_k_kernel(const Rows<const T> q, const Rows<const T> k,
                  const Rows<const T> v, const Rows<const T> g_op,
                  const Rows<T> dk, const Rows<T> dv,
                  const float* __restrict__ stats, int n, int heads, int d,
                  float scale, int k_tiles) {
  using K = Kind<T>;
  constexpr int kS = K::kStride;
  constexpr int kA = K::kRows;
  constexpr int kB = K::kKeys;
  constexpr int kNT = K::kNT;
  constexpr int kPS = kA + K::kPlanePad;  // P^T and dS^T rows (keys)
  constexpr int kPlane = kB * kPS;
  extern __shared__ uint4 wide_smem[];
  Bars bars(wide_smem);
  T* qs = reinterpret_cast<T*>(wide_smem + kBarBytes / 16);
  T* gs = qs + kA * kS;
  T* ks = gs + kA * kS;
  T* vs = ks + kB * kS;
  T* pt = vs + kB * kS;  // P^T, then kParts planes of dS^T
  T* dt = pt + kPlane;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % k_tiles) * kB;  // the block's keys
  const int o0 = (blockIdx.x / k_tiles) * kOut;
  const int nb = min(kB, n - row0);
  const int dp = pad_width(d);
  const int groups = cdiv(dp, kGroup);
  const int ow = min(kOut, dp - o0);
  const Piece<kA, kB, kNT> pc(warp);
  const T* kh = k.at(b, h, d, row0);
  const T* vh = v.at(b, h, d, row0);
  const T* qh = q.at(b, h, d, 0);
  const T* gh = g_op.at(b, h, d, 0);
  const int npad = pad16(n);
  const float* st = stats_of(const_cast<float*>(stats), b, h, heads, npad);

  float acc_dk[kB / 16][kOwn][2][4] = {}, acc_dv[kB / 16][kOwn][2][4] = {};
  float s[kNT][4], da[kNT][4];
  const int chunks = cdiv(n, kA);
  auto stage_qg = [&](const T* src, int64_t row, T* dst, int c, int f0,
                      int width) {
    stage(src + static_cast<int64_t>(c) * kA * row, row, dst,
          min(kA, n - c * kA), kA, f0, width, d);
  };
  auto fill_qg = [&](const T* src, int64_t row, T* dst, int c, uint64_t* bar) {
    fill(src + static_cast<int64_t>(c) * kA * row, row, dst,
         min(kA, n - c * kA), kA, d, bar);
  };
  // P and dS of the piece from the saved statistics, 0 at queries >= n
  // (the zero pad rows of Q have a softmax of their own), written
  // transposed: row = key (b0 + 8 j + 2 t + e % 2), column = query
  // (a0 + g + 8 (e / 2))
  auto finish = [&](const typename ScoresOf<T>::type& sa,
                    const typename ScoresOf<T>::type& dacc, int c) {
    float rm[2], ri[2], rr[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = c * kA + pc.a0 + g + 8 * r;
      live[r] = i < n;
      rm[r] = live[r] ? st[i] : 0.f;
      ri[r] = live[r] ? st[npad + i] : 0.f;
      rr[r] = live[r] ? st[2 * npad + i] : 0.f;
    }
    sa.read(s);
    dacc.read(da);
    mask_scale(s, row0 + pc.b0, n, scale, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2], x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = live[r] ? expf(s[j][2 * r + e] - rm[r]) * ri[r] : 0.f;
          x[e] = live[r] ? dscore(p[e], da[j][2 * r + e], rr[r], scale)
                         : 0.f;
        }
        const int off = (pc.b0 + 8 * j + 2 * t) * kPS + pc.a0 + g + 8 * r;
        put_pair_t<1>(pt + off, kPS, 0, p[0], p[1]);
        put_pair_t<K::kParts>(dt + off, kPS, kPlane, x[0], x[1]);
      }
    }
  };

  if (groups == 1) {
    // K and V stay staged (barriers 2, 3); G(c + 1) lands during dS^T Q of
    // c (barrier 1), Q(c + 1) during G V^T of c + 1 (barrier 0)
    bars.init(4);
    zero_pad(qs, 2 * kA + 2 * kB, d, dp);
    __syncthreads();
    fill(kh, k.row, ks, nb, kB, d, bars.bar + 2);
    fill(vh, v.row, vs, nb, kB, d, bars.bar + 3);
    fill_qg(gh, g_op.row, gs, 0, bars.bar + 1);
    fill_qg(qh, q.row, qs, 0, bars.bar);
    bars.wait(2);
    bars.wait(3);
    for (int c = 0; c < chunks; ++c) {
      typename ScoresOf<T>::type sa, dacc;
      bars.wait(1);  // G(c)
      __syncthreads();
      if (pc.on) {
        dacc.zero();
        score_products(dacc, gs, pc.a0, vs, pc.b0, dp, lane);
      }
      bars.wait(0);  // Q(c)
      __syncthreads();
      if (pc.on) {
        sa.zero();
        score_products(sa, qs, pc.a0, ks, pc.b0, dp, lane);
        finish(sa, dacc, c);
      }
      __syncthreads();  // the planes written
      accumulate<kB / 16, 1, kA>(acc_dv, pt, kPS, 0, gs, 0, ow, warp, lane);
      __syncthreads();  // G(c) read
      if (c + 1 < chunks) fill_qg(gh, g_op.row, gs, c + 1, bars.bar + 1);
      accumulate<kB / 16, K::kParts, kA>(acc_dk, dt, kPS, kPlane, qs, 0, ow,
                                         warp, lane);
      __syncthreads();  // Q(c) and the planes read
      if (c + 1 < chunks) fill_qg(qh, q.row, qs, c + 1, bars.bar);
    }
  } else {
    // wider heads: every operand staged a feature group at a time for
    // every chunk, Q and G again at the block's output features
    for (int c = 0; c < chunks; ++c) {
      typename ScoresOf<T>::type sa, dacc;
      sa.zero();
      dacc.zero();
      for (int f0 = 0; f0 < dp; f0 += kGroup) {
        const int width = min(kGroup, dp - f0);
        __syncthreads();  // the staged rows and the planes are free
        stage_qg(qh, q.row, qs, c, f0, width);
        stage_qg(gh, g_op.row, gs, c, f0, width);
        stage(kh, k.row, ks, nb, kB, f0, width, d);
        stage(vh, v.row, vs, nb, kB, f0, width, d);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<0>();
        __syncthreads();
        if (pc.on) {
          score_products(dacc, gs, pc.a0, vs, pc.b0, width, lane);
          score_products(sa, qs, pc.a0, ks, pc.b0, width, lane);
        }
      }
      if (pc.on) finish(sa, dacc, c);
      __syncthreads();  // the planes written, the scores' reads done
      stage_qg(qh, q.row, qs, c, o0, ow);
      stage_qg(gh, g_op.row, gs, c, o0, ow);
      attn_mma::cp_async_commit();
      attn_mma::cp_async_wait<0>();
      __syncthreads();
      accumulate<kB / 16, 1, kA>(acc_dv, pt, kPS, 0, gs, 0, ow, warp, lane);
      accumulate<kB / 16, K::kParts, kA>(acc_dk, dt, kPS, kPlane, qs, 0, ow,
                                         warp, lane);
    }
  }
  store_out<T, kB / 16>(acc_dk, dk.at(b, h, d, row0) + o0, dk.row, nb,
                        d - o0, warp, lane);
  store_out<T, kB / 16>(acc_dv, dv.at(b, h, d, row0) + o0, dv.row, nb,
                        d - o0, warp, lane);
}

// Host side. ``strides`` holds (image, row) element strides per operand.
template <typename P>
Rows<P> rows_of(const void* p, const int64_t* strides, int i) {
  return {static_cast<P*>(const_cast<void*>(p)), strides[2 * i],
          strides[2 * i + 1]};
}

// Shared memory one block needs, bytes: forward, and the larger of the
// backward's two kernels (dtype: 0 = float32, 1 = bfloat16).
inline int fwd_smem_bytes(int dtype) {
  return dtype == 1 ? fwd_smem<bf16>() : fwd_smem<float>();
}
inline int bwd_smem_bytes(int dtype) {
  return dtype == 1 ? (bwd_q_smem<bf16>() > bwd_k_smem<bf16>()
                           ? bwd_q_smem<bf16>()
                           : bwd_k_smem<bf16>())
                    : (bwd_q_smem<float>() > bwd_k_smem<float>()
                           ? bwd_q_smem<float>()
                           : bwd_k_smem<float>());
}

inline cudaError_t allow_smem(const void* body, int smem) {
  return cudaFuncSetAttribute(body,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// q, k, v -> out (B, N, H*D) contiguous.
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int64_t* strides, void* out, int batch, int n,
                       int heads, int d, float scale, cudaStream_t stream) {
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const int64_t out_strides[2] = {n * hd, hd};
  constexpr int smem = fwd_smem<T>();
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(wide_fwd_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = cdiv(n, Kind<T>::kFwdRows);
  const int groups = cdiv(pad_width(d), kOut);
  wide_fwd_kernel<T><<<dim3(q_tiles * groups, heads, batch), kThreads, smem,
                       stream>>>(
      rows_of<const T>(q, strides, 0), rows_of<const T>(k, strides, 1),
      rows_of<const T>(v, strides, 2), rows_of<T>(out, out_strides, 0), n,
      d, scale, q_tiles);
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
  constexpr int q_smem = bwd_q_smem<T>();
  constexpr int k_smem = bwd_k_smem<T>();
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(wide_bwd_q_kernel<T>), q_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(wide_bwd_k_kernel<T>),
                   k_smem);
  if (err != cudaSuccess) return err;
  const int groups = cdiv(pad_width(d), kOut);
  const int q_tiles = cdiv(n, Kind<T>::kRows);
  const int k_tiles = cdiv(n, Kind<T>::kKeys);
  wide_bwd_q_kernel<T><<<dim3(q_tiles * groups, heads, batch), kThreads,
                         q_smem, stream>>>(
      q, k, v, g, rows_of<T>(ptrs[4], strides, 4), stats, n, heads, d,
      scale, q_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_k_kernel<T><<<dim3(k_tiles * groups, heads, batch), kThreads,
                         k_smem, stream>>>(
      q, k, v, g, rows_of<T>(ptrs[5], strides, 5),
      rows_of<T>(ptrs[6], strides, 6), stats, n, heads, d, scale, k_tiles);
  return cudaGetLastError();
}

}  // namespace attn_wide
