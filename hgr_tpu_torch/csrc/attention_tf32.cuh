// Tensor-core building blocks of the f32 attention kernels
// (attention_qkv_fwd.cu, attention_qkv_bwd.cu): f32 staging of one head's
// rows into shared memory and the products of f32 operands on Hopper's
// tensor cores by a three-way TF32 operand split, for a padded head width
// Dp in {16, 32, 64, 128, 256} (staged columns d..Dp-1 are zero, so every
// product over Dp features equals the one over d).
//
// One TF32 operand keeps 11 bits of an f32 value's 24: a product of TF32
// roundings misses the f32 product by ~1e-3 relative, far outside the f32
// kernels' 1e-5 (forward) and 1e-4 (gradient) tolerances. So each f32
// operand x is split as it loads,
//   big = rna_tf32(x),  small = cvt.rna.tf32.f32(x - big)
// (rna_tf32: cvt.rna's rounding, see split(); x - big is exact in f32),
// and each product x . y is taken as
//   big_x big_y + big_x small_y + small_x big_y
// on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, accumulated in
// f32: what it leaves out (small_x small_y and small's own rounding) is
// ~2^-22 relative, an f32 product's own error. The roundings are explicit:
// the instruction ignores the low 13 bits of an f32 register, which would
// truncate, not round. The cross terms go first, the big one last, in the
// same order of the two operands whichever of them is the A fragment
// (kAisX), so that S = Q K^T and S^T = K Q^T run the same sequence of
// products (tools/probe_score_bits.py counts the scores whose bits
// differ).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8" .tf32),
// for a lane with group g = lane / 4 and thread-in-group t = lane % 4:
//   A (16 x 8, row-major): a[0] = (g, t),     a[1] = (g + 8, t),
//                          a[2] = (g, t + 4), a[3] = (g + 8, t + 4)
//   B (8 x 8, column n):   b[0] = (row t, column g), b[1] = (t + 4, g)
//   C (16 x 8, f32):       c[0], c[1] = (g, 2t..2t+1),
//                          c[2], c[3] = (g + 8, 2t..2t+1)
// The C layout is not the A layout, so a product that takes a C tile as
// its A operand (P V, dS K, dS^T Q, P^T G) takes the 8 keys of the step in
// a permuted order: A's column t is key 2t and column t + 4 key 2t + 1, so
// the A fragment is {c[0], c[2], c[1], c[3]} with no shuffle, and the B
// fragment of the other operand is read in the same order
// (b[0] = Y[2t][g], b[1] = Y[2t + 1][g]). The sum over the 8 keys is the
// same sum.
//
// A staged row is Dp + 4 floats: the (g, t) reads of a row-g fragment
// (addresses g (Dp + 4) + t) and the (2t, g) reads of a key-permuted one
// (2t (Dp + 4) + g) both hit 32 distinct banks. ldmatrix does not
// transpose 32-bit elements, so every fragment is read by plain 32-bit
// shared loads. The A fragments of a 16-row tile are read from shared
// memory a step of 8 features at a time and split once for every 8-row
// tile of the other side in the call (``products``); holding them split
// in registers would take 2 Dp registers a lane.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace attn_tf32 {

using attn_mma::pad16;

// A staged f32 row: Dp features and 4 of padding (see the note above).
__host__ __device__ constexpr int row_pad(int dp) { return dp + 4; }

// The split of x: big = x rounded to TF32 (nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding), written as the integer add and mask that
// rounding is for every finite value, the low 13 bits cleared so that
// x - big is exact; small = cvt.rna.tf32.f32(x - big) itself. ptxas
// expands the instruction with a NaN guard (compares and selects in the
// SASS); taking it for small only halves that cost and keeps a NaN or an
// infinity of x in the products (small is then NaN). The integer form
// for small too is faster still (tools/tune_attention.py --dtype float32,
// {fwd,bwd}_f32_small=int) but turns CUDA's NaN 0x7fffffff into -0.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  // the mma ignores small's low 13 (don't-care) bits
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// d += a (16 x 8 tf32) . b (8 x 8 tf32), f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 A fragment split into its big and small TF32 parts.
struct AFrag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ AFrag split_a(float x0, float x1, float x2,
                                         float x3) {
  AFrag a;
  split(x0, a.big[0], a.small[0]);
  split(x1, a.big[1], a.small[1]);
  split(x2, a.big[2], a.small[2]);
  split(x3, a.big[3], a.small[3]);
  return a;
}

// B values split into their TF32 parts
struct BFrag {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ BFrag split_b(float y0, float y1) {
  BFrag b;
  split(y0, b.big[0], b.small[0]);
  split(y1, b.big[1], b.small[1]);
  return b;
}

// c[j0 + i] += X . Y_i (i < kG) over one 8-deep step, by three TF32
// products each, from the split A fragment ``a`` and the split B
// fragments ``b``. kAisX: A holds X (else Y). Each accumulator takes big_X
// small_Y, then small_X big_Y, then big_X big_Y; the kG accumulators take
// each term in turn, so that no product waits on the one before it.
template <bool kAisX, int kG, int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], int j0,
                                     const AFrag& a, const BFrag (&b)[kG]) {
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    if constexpr (kAisX) {
      mma(c[j0 + i], a.big, b[i].small[0], b[i].small[1]);
    } else {
      mma(c[j0 + i], a.small, b[i].big[0], b[i].big[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    if constexpr (kAisX) {
      mma(c[j0 + i], a.small, b[i].big[0], b[i].big[1]);
    } else {
      mma(c[j0 + i], a.big, b[i].small[0], b[i].small[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    mma(c[j0 + i], a.big, b[i].big[0], b[i].big[1]);
  }
}

// Tiles whose products one mma3 call interleaves: 4 where NT allows.
__host__ __device__ constexpr int group_of(int nt) {
  return nt % 4 == 0 ? 4 : nt % 2 == 0 ? 2 : 1;
}

// Stage rows 0..n-1 of one head (d features, row stride ``row`` elements)
// into ``dst`` as rows of row_pad(Dp) floats, zero its columns d..Dp-1,
// and zero rows n..npad-1, so that products over the padded tile see zeros
// and never stale shared memory (0 x NaN is NaN). 16-byte cp.async copies
// when the rows allow them (16-byte aligned, row stride and d multiples of
// 4 elements), else one element per thread into the same layout. The
// caller waits (cp_async_wait_all or a group wait) and synchronises.
template <int Dp>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int64_t row, float* dst, int n,
                                           int npad, int d) {
  constexpr int kPad = row_pad(Dp);
  constexpr int kChunks = Dp / 4;  // 16-byte chunks of a staged row
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % 4 == 0 &&
      d % 4 == 0) {
    const int dc = d >> 2;
    for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
      const int j = idx / kChunks;
      const int c = idx - j * kChunks;
      if (c < dc) {
        attn_mma::cp_async16(dst + j * kPad + c * 4, src + j * row + c * 4);
      } else {
        *reinterpret_cast<float4*>(dst + j * kPad + c * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < n * Dp; idx += blockDim.x) {
      const int j = idx / Dp;
      const int f = idx - j * Dp;
      dst[j * kPad + f] = f < d ? src[j * row + f] : 0.f;
    }
  }
  for (int idx = threadIdx.x; idx < (npad - n) * kChunks; idx += blockDim.x) {
    const int j = n + idx / kChunks;
    *reinterpret_cast<float4*>(dst + j * kPad + (idx % kChunks) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// c[j] = A . Y[r0 + 8j .. r0 + 8j + 7]^T for the 16 x Dp A tile of the
// staged rows ``a_rows`` (tile rows a0..a0+15) and NT 8-row tiles of the
// staged rows Y from r0 on, in steps of 8 features: each step's A fragment
// is read and split once for all NT tiles, which go group_of(NT) at a
// time through mma3. A group that starts at or past npad is not computed
// (zero); one that runs past it reads row npad - 1 there, and the caller
// never uses those tiles. kAisX as in mma3.
template <int Dp, int NT, bool kAisX>
__device__ __forceinline__ void products(float (&c)[NT][4],
                                         const float* a_rows, int a0,
                                         const float* rows, int r0, int npad,
                                         int lane) {
  constexpr int kPad = row_pad(Dp);
  constexpr int kG = group_of(NT);
  const int g = lane >> 2, t = lane & 3;
  const float* pa = a_rows + (a0 + g) * kPad + t;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll(Dp <= 64 ? Dp / 8 : 4)
  for (int f = 0; f < Dp; f += 8) {
    const AFrag a = split_a(pa[f], pa[8 * kPad + f], pa[f + 4],
                            pa[8 * kPad + f + 4]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kG) {
      if (r0 + 8 * j0 < npad) {
        BFrag b[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const float* y =
              rows + min(r0 + 8 * (j0 + i) + g, npad - 1) * kPad + t + f;
          b[i] = split_b(y[0], y[4]);
        }
        mma3<kAisX>(c, j0, a, b);
      }
    }
  }
}

// s = the scores of the query tile (staged rows q_rows, tile q0..q0+15)
// against NT 8-key tiles of the staged keys from key0 on: the f32 dot (Q
// the A operand), then __fmul_rn by scale (never contracted into what
// follows); keys at or beyond n, and tiles at or past npad (not
// computed), at -inf. (For a chunk of keys staged on its own, key0 counts
// from the chunk's first key and n is the number of keys left from it.)
template <int Dp, int NT>
__device__ __forceinline__ void masked_scores(float (&s)[NT][4],
                                              const float* q_rows, int q0,
                                              const float* ks, int key0,
                                              int n, int npad, float scale,
                                              int lane) {
  products<Dp, NT, true>(s, q_rows, q0, ks, key0, npad, lane);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k0 = key0 + 8 * j;
    if (k0 < npad) {
      const int c = k0 + 2 * t;
      s[j][0] = c < n ? __fmul_rn(s[j][0], scale) : -INFINITY;
      s[j][1] = c + 1 < n ? __fmul_rn(s[j][1], scale) : -INFINITY;
      s[j][2] = c < n ? __fmul_rn(s[j][2], scale) : -INFINITY;
      s[j][3] = c + 1 < n ? __fmul_rn(s[j][3], scale) : -INFINITY;
    } else {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
    }
  }
}

// acc (16 x Dp, Dp / 8 C tiles of 16 x 8) += X . Y[r0..r0+7] for the
// 16 x 8 C tile x (over rows r0..r0+7 of Y, e.g. P over 8 keys) and the
// staged rows Y, the 8 rows taken in the permuted order of the note at the
// top: A = {x[0], x[2], x[1], x[3]}, B = (Y[r0 + 2t][8f + g],
// Y[r0 + 2t + 1][8f + g]); the output tiles go group_of(Dp / 8) at a time
// through mma3.
template <int Dp>
__device__ __forceinline__ void accumulate(float (&acc)[Dp / 8][4],
                                           const float (&x)[4],
                                           const float* rows, int r0,
                                           int lane) {
  constexpr int kPad = row_pad(Dp);
  constexpr int kG = group_of(Dp / 8);
  const int g = lane >> 2, t = lane & 3;
  const AFrag a = split_a(x[0], x[2], x[1], x[3]);
  const float* p = rows + (r0 + 2 * t) * kPad + g;
#pragma unroll
  for (int f0 = 0; f0 < Dp / 8; f0 += kG) {
    BFrag b[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      b[i] = split_b(p[8 * (f0 + i)], p[kPad + 8 * (f0 + i)]);
    }
    mma3<true>(acc, f0, a, b);
  }
}

// Whether accumulate_tiles sums each call's tiles into a fresh accumulator
// first and adds that to the output with rounding adds. The tensor cores'
// f32 accumulation rounds toward zero at every mma, so a sum over N rows
// taken straight into the output drifts with 3 N / 8 truncations of it
// (the f32 outputs read 3-4x farther from float64 than the CUDA cores'
// sums did); a fresh accumulator truncates only its 32 rows' partial sum.
// Past Dp = 64 the second 16 x Dp tile would not fit the registers.
__host__ __device__ constexpr bool flushes(int dp) { return dp <= 64; }

// acc += X_j . Y[r0 + 8j .. r0 + 8j + 7] over the NT C tiles x[j] (X's
// columns are those 8 rows, e.g. P over 8 keys), tiles at or past npad
// skipped; through a fresh accumulator where flushes(Dp).
template <int Dp, int NT>
__device__ __forceinline__ void accumulate_tiles(float (&acc)[Dp / 8][4],
                                                 const float (&x)[NT][4],
                                                 const float* rows, int r0,
                                                 int npad, int lane) {
  if constexpr (flushes(Dp)) {
    float part[Dp / 8][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (r0 + 8 * j < npad) {
        accumulate<Dp>(part, x[j], rows, r0 + 8 * j, lane);
      }
    }
#pragma unroll
    for (int f = 0; f < Dp / 8; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = __fadd_rn(acc[f][e], part[f][e]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (r0 + 8 * j < npad) {
        accumulate<Dp>(acc, x[j], rows, r0 + 8 * j, lane);
      }
    }
  }
}

// Store columns 0..d-1 of the 16 x Dp f32 tile ``acc`` (rows r0.., C
// layout) as rows of ``dst`` (row stride ``row`` elements), rows at or
// beyond n skipped.
template <int Dp>
__device__ __forceinline__ void store_rows(const float (&acc)[Dp / 8][4],
                                           float* dst, int64_t row, int r0,
                                           int n, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // every column stored in pairs (the model's widths), or one by one
  const bool pairs = reinterpret_cast<uintptr_t>(dst) % 8 == 0 &&
                     row % 2 == 0 && d == Dp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + g + 8 * half;
    if (i >= n) continue;
#pragma unroll
    for (int f = 0; f < Dp / 8; ++f) {
      const int col = 8 * f + 2 * t;
      float* p = dst + i * row + col;
      const float x0 = acc[f][2 * half], x1 = acc[f][2 * half + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      } else {
        if (col < d) p[0] = x0;
        if (col + 1 < d) p[1] = x1;
      }
    }
  }
}

}  // namespace attn_tf32
