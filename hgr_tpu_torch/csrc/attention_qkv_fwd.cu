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
// Head widths above 256 take the bodies of attention_wide.cuh (route
// 2). Up to 256, every body is a template over
// the padded width Dp in {16, 32, 64, 128, 256} (the smallest that holds
// D); the true D is a runtime
// value. Staged features D..Dp-1 are zero, so the dot products over Dp
// features equal those over D, and output columns beyond D are never
// written. At Dp = 256 every length takes the key-chunked route: the
// whole-sequence bodies keep a tile's output (and in bf16 Q's A
// fragments) in registers beside a chunk of scores, which does not fit
// one thread's 255 registers at that width, and at N = 145 the bf16
// body's Q, K and V would not fit one block's shared memory either. The
// chunked kernels read Q's A fragments from shared memory there (bf16:
// attention_mma.cuh, products_smem; f32 always, attention_tf32.cuh) and
// take 32 keys a chunk.
//
// Bound on an H100 SXM at the serving shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 19.0 MB (qkv read once, 14.25 MB; out
// written once, 4.75 MB), 5.7 us at 3.35 TB/s, against 1.38 GFLOP for
// the two products, 1.4 us at 989 TFLOP/s. The kernel is memory-bound.
// In f32 at the --dtype mixed training shape (B=256, N=145): 152.0 MB,
// 45.4 us, against 5.51 GFLOP, 82 us on the CUDA cores (67 TFLOP/s) and
// 33 us as the three TF32 products of this body (3 x 5.51 GFLOP at
// 495 TFLOP/s): on the tensor cores it is memory-bound too.
//
// Two bodies, chosen by the compute type, each with two routes, chosen by
// the sequence length. The whole-sequence route stages the head's whole
// Q, K and V in one block's shared memory and keeps a chunk of scores in
// registers (160 keys at Dp <= 32; 96 at 64, 48 at 128); the key-chunked
// route streams K and V through shared memory in chunks of the same size
// and sweeps the keys twice: the first sweep takes the row max and the
// sum of exp(s - max), the second recomputes S, normalises P in f32,
// rounds it and accumulates P V. (P is rounded after the normalisation,
// as the Pallas kernel does, so the output cannot be rescaled online.)
// Both routes take the same steps in the same order: they give the same
// bits. route() takes the whole-sequence body while one register chunk
// holds the sequence, where it computes S once and the chunked route
// twice, and an SM holds two of its blocks. Past one chunk the whole body
// sweeps twice as well, with one block a head where the chunked route has
// one per 112 queries (64 at Dp = 128 and 256): timed at (64, n, 768)
// bf16 on an H100 (chip_smoke's route sweep), the whole body took 0.025
// ms against the ring body's 0.042 at n = 145 and 0.068 against 0.075 at
// 193, the ring body 0.100 against 0.144 at n = 257 and 0.539 against
// 1.616 at 785 (PERF.md section 6). The same sweep at Dp = 16 (16 heads)
// and 64 (4 heads) puts the crossover at the same place, one register
// chunk: at Dp = 16 the whole body took 0.040 ms against the ring body's
// 0.052 at n = 145 (one 160-key chunk) and 0.124 against 0.106 at 193; at
// Dp = 64 the ring body 0.036 against 0.037 at n = 145 (two 96-key
// chunks) and 0.048 against 0.060 at 193.
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
//   S = Q K^T by mma into registers, a chunk of keys at a time;
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
// Shared memory: 3 (Dp + 8) * 2 bytes per padded row (38,400 at N = 145,
// Dp = 32). A per-element division and expf cost more than the products
// here, hence the reciprocal and the SFU exp.
//
// The key-chunked route is the ring body at every padded width, with
// constants of its own at each (Dp = 32 is the model's width, the 448 px
// path).
// Bound at (B=64, N=785, H=8, D=32, bf16): 102.9 MB moved (qkv read once,
// 77.17 MB; out written once, 25.72 MB), 0.0307 ms at 3.35 TB/s, against
// 4 N^2 D H B = 4.04e10 FLOP, 0.0408 ms at 989 TFLOP/s: bound by its
// operations. The function as the Pallas kernel defines it sets a higher
// floor: P is rounded after it is normalised, so both sweeps compute every
// score and exponentiate it, 6.3e8 exps at N = 785, ~0.15 ms at the SFU's
// 16 a clock an SM. At 16 heads of 16 and 4 of 64 the bound is the same
// (H D = 256) and the exps scale with the heads: ~0.30 ms at Dp = 16,
// where the SFU binds, and ~0.076 at Dp = 64, where the four product
// passes (S three times, P V once) and their ldmatrix reads take most of
// the time. What the body does about the rest:
//   - one block per 16 W queries (W consumer warps, a 16-row tile each):
//     each staged chunk of K and V serves W tiles (7 at N = 785, against 4
//     before), which cuts the L2 stream of K twice and V once per block
//     (8 blocks a head at N = 785 against 13: ~0.62 GB a call);
//   - one producer warp stages the chunks by cp.async into ring_stages(Dp)
//     buffers, each with a full and an empty mbarrier (attention_mma.cuh,
//     Ring): no block barrier in the loop, a warp waits only for the chunk
//     it reads;
//   - the fold's register chunk is taken ring_piece tiles at a time, its
//     max over every piece and then the exps and their sum with the
//     scores computed again: at Dp = 32, 90 registers a thread instead of
//     the whole chunk's ~168, so an SM holds two blocks of eight warps; at
//     Dp = 16, 64 registers and four blocks; at Dp = 64, 125 registers
//     and two blocks (the earlier kernel's 187 held two blocks of four);
//   - lane_exps takes the bare MUFU.EX2 where exp2f's subnormal fix-up
//     does nothing. The pieces are what let it pay: in the earlier
//     kernel, whose fold holds the whole chunk, it took ptxas from 162
//     registers to 168 and 40 bytes of spill, and the forward from 0.56
//     to 0.61 ms at (64, 785, 768) (PERF.md section 6).
// Each warp takes the whole-sequence body's steps in the same order, the
// sums in the same order: the same bits (at Dp = 256, where no
// whole-sequence body is built, those of the two-buffer key-chunked kernel
// the card ran before, which the CPU emulator keeps as its reference:
// tools/emulate/chunked_fwd.cuh). At (64, 785, 768) the ring body took
// 0.69 against that kernel's 0.86 ms at Dp = 16 and 0.48 against 0.51 at
// Dp = 64, in turns (PERF.md section 6).
// At Dp = 128 and 256 (head widths 65 to 256) the exps no longer bind: at
// (B=16, N=785, H=2) the bound is 4 N^2 D H B = 1.01e10 FLOP, 0.0102 ms,
// at D = 128 (25.7 MB, 0.0077 ms by bytes) and 2.02e10, 0.0204 ms, at 256
// (51.4 MB, 0.0154 ms), against ~0.01 ms of exps. What held the body
// there, and what it does about it:
//   - the staging: rows of 256 and 512 bytes, copied 16 bytes a lane by
//     one producer warp, fell behind the consumers (0.36 ms at 2 x 256
//     against the earlier kernel's 0.25, 0.43 at head width 192, whose
//     zero columns doubled the producer's instructions); the producer now
//     issues one bulk copy a row (Hopper's TMA engine: attention_mma.cuh,
//     bulk_rows) and the columns d..Dp-1 are zeroed once;
//   - the products: the first sweep holds a whole chunk's scores (S
//     computed twice in all, not three times), while the output, not yet
//     live, leaves it the registers; the second takes ring_piece tiles
//     beside the output. Q's fragments stay in shared memory (two blocks
//     an SM leave 128 registers at Dp = 128; one block, 230, at 256).
// In turns at (16, 785, 2 x D) against the earlier kernel on an H100
// (PERF.md section 6): 0.1414 -> 0.1002 ms at D = 128, 0.2474 -> 0.1855
// at 256.
// The ring at Dp = 256 is still ~9x its bound: 7 consumer warps an SM
// (registers allow one block), each mma.sync product reading its A and B
// fragments through ldmatrix. tools/tune_attention.py times the bodies at other
// chunk, block, piece and ring sizes.
//
// f32 (cli.export's f32 eval, --dtype mixed's decoder, the check paths):
// the same structure, routes and steps on the tensor cores by a three-way
// TF32 split of every operand (attention_tf32.cuh): each product x . y as
// big_x small_y + small_x big_y + big_x big_y on m16n8k8 TF32 mma, which
// keeps the f32 tolerance of 1e-5 (one TF32 term misses it by ~5e-4).
// Q, K and V are staged as f32 rows of Dp + 4 floats (3 (Dp + 4) * 4 bytes
// per padded row, 69,120 at N = 145) and split in registers as their
// fragments load; Q's A fragments are read from shared memory a step of 8
// features at a time for a whole chunk of keys. P stays f32 (P^ = P): its
// S accumulators are the A fragments of P V with the 8 keys of each step
// taken in a permuted order (A's column t is key 2t, column t + 4 key
// 2t + 1), V's B fragments read in the same order. exp is expf. PERF.md
// section 6 has this body's times beside SDPA's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_wide.cuh"

namespace {

namespace tc = attn_mma;
namespace tf = attn_tf32;

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
// Warps (16-row query tiles) per block of the f32 key-chunked kernel.
constexpr int kLongWarps = 4;
// The bf16 key-chunked route's ring body (Dp = 16, 32 and 64), its
// constants per width, each set fitted by ptxas -v with no spill: most
// consumer warps (16-row query tiles) a block besides its producer warp,
// buffers of the ring, the least blocks an SM must hold (ptxas fits the
// registers to it: blocks of 8 warps leave 128 a thread at two an SM and
// 64 at four; 9 warps two an SM would leave 96), and the 8-key C tiles of
// scores a warp holds at a time: a piece of the register chunk (which
// keeps the fold's 8 chunk_tiles keys), its scores computed twice in the
// first sweep (for the max, then the exps); the whole chunk where the
// piece does not divide it. tools/tune_attention.py times other values
// (PERF.md section 6 has the grids).
// Dp = 16 (bound by its exps: 2 a score): 160-key chunks of 24-element
// rows; three buffers (51,504 bytes a block) so that an SM holds four
// blocks, 28 consumer warps at 64 registers (four buffers and three
// blocks, 72 registers: 5-7% slower).
constexpr int kRingWarps16 = 7;
constexpr int kRingStages16 = 3;
constexpr int kRingBlocks16 = 4;
constexpr int kRingPiece16 = 4;
// Dp = 32 (the model's width): 160-key chunks of 40-element rows.
constexpr int kRingWarps32 = 7;
constexpr int kRingStages32 = 4;
constexpr int kRingBlocks32 = 2;
constexpr int kRingPiece32 = 4;
// Dp = 64: 96-key chunks of 72-element rows; three buffers (99,120 bytes
// a block) so that an SM holds two blocks (four would take 126,784), at
// 125 registers (8 consumer warps, or 3 blocks of 6, spill).
constexpr int kRingWarps64 = 7;
constexpr int kRingStages64 = 3;
constexpr int kRingBlocks64 = 2;
constexpr int kRingPiece64 = 4;
// Dp = 128 and 256 (bound by their products): K and V staged by bulk
// copies, the first sweep holding a whole chunk's scores and the second
// taking kRingPiece tiles at a time beside the output (see the note at the
// top). Dp = 128: 48-key chunks of 136-element rows, three buffers
// (108,848 bytes a block) so that an SM holds two blocks of eight warps at
// 127 registers, Q's fragments read from shared memory (ring_q_smem), the
// second sweep 2 tiles at a time (the whole chunk spilled 12 bytes;
// tools/tune_attention.py --grid ring128, PERF.md section 6).
constexpr int kRingWarps128 = 7;
constexpr int kRingStages128 = 3;
constexpr int kRingBlocks128 = 2;
constexpr int kRingPiece128 = 2;
// Dp = 256: 32-key chunks of 264-element rows, three buffers (160,560
// bytes): one block an SM at 230 registers, the output's 128 accumulators
// and the whole chunk.
constexpr int kRingWarps256 = 7;
constexpr int kRingStages256 = 3;
constexpr int kRingBlocks256 = 1;
constexpr int kRingPiece256 = 4;
__host__ __device__ constexpr int ring_warps(int dp) {
  return dp == 16    ? kRingWarps16
         : dp == 32  ? kRingWarps32
         : dp == 64  ? kRingWarps64
         : dp == 128 ? kRingWarps128
                     : kRingWarps256;
}
__host__ __device__ constexpr int ring_stages(int dp) {
  return dp == 16    ? kRingStages16
         : dp == 32  ? kRingStages32
         : dp == 64  ? kRingStages64
         : dp == 128 ? kRingStages128
                     : kRingStages256;
}
__host__ __device__ constexpr int ring_blocks(int dp) {
  return dp == 16    ? kRingBlocks16
         : dp == 32  ? kRingBlocks32
         : dp == 64  ? kRingBlocks64
         : dp == 128 ? kRingBlocks128
                     : kRingBlocks256;
}
// whether the ring body reads Q's A fragments from shared memory
// (products_smem) at each step instead of holding them in registers: at
// Dp = 128 and 256, where in registers they took no less time on an
// H100 (0.0998 against 0.1005 ms at (16, 785, 2 x 128), 0.1838 against
// 0.1833 at 2 x 256; PERF.md section 6) and the registers they free are
// needed
__host__ __device__ constexpr bool ring_q_smem(int dp) { return dp >= 128; }
template <int Dp>
__host__ __device__ constexpr int ring_piece() {
  constexpr int kPiece = Dp == 16    ? kRingPiece16
                         : Dp == 32  ? kRingPiece32
                         : Dp == 64  ? kRingPiece64
                         : Dp == 128 ? kRingPiece128
                                     : kRingPiece256;
  return chunk_tiles<Dp>() % kPiece == 0 && kPiece % 2 == 0
             ? kPiece
             : chunk_tiles<Dp>();
}
// the ring's barriers (a full and an empty one a buffer) ahead of the
// staged rows, in whole 16-byte units
__host__ __device__ constexpr int ring_header(int dp) {
  return 16 * ((16 * ring_stages(dp) + 15) / 16);
}
// Most warps per block of the f32 whole-sequence body (10 query tiles at
// N = 145 go 3, 3, 2, 2), and the least whole-sequence blocks an SM must
// hold for that route to run (route()).
constexpr int kF32Warps = 4;
constexpr int kWholeBlocks = 2;

// e^x for the softmax, as 2^(x log2 e) on the SFU. P is rounded to bf16
// (8 bits) right after, so this exp's ~1e-6 relative error moves P across
// a rounding boundary about once in 4,000 values and the output by less
// than its own rounding. (The backward keeps expf: its dS stays in f32.)
__device__ __forceinline__ float softmax_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// 2^x by the SFU's bare MUFU.EX2 (flushes subnormal results to zero)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp_scores for the ring body, by lane: where every argument of the lane
// is at least -126, exp2f is the bare ex2.approx.ftz (one MUFU.EX2: its
// subnormal fix-up, a compare and two predicated multiplies, does nothing
// there), so those lanes take that instruction alone; the same bits.
template <int NT>
__device__ __forceinline__ void lane_exps(float (&s)[NT][4],
                                          const float (&m)[2]) {
  float lo = INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // softmax_exp's argument
      s[j][e] = (s[j][e] - m[e >> 1]) * 1.4426950408889634f;
      lo = fminf(lo, s[j][e]);
    }
  }
  if (lo >= -126.f) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_ftz(s[j][e]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e]);
    }
  }
}

// exp for the softmax: the SFU's (softmax_exp) in the bf16 body, expf in
// the f32 one (whose P is not rounded after)
template <bool kExact>
__device__ __forceinline__ float score_exp(float x) {
  if constexpr (kExact) {
    return expf(x);
  } else {
    return softmax_exp(x);
  }
}

// Rows g and g + 8 of a query tile: fold one chunk's scores ``s`` into the
// running max m and sum l of exp(s - m) (the sum rescaled when the chunk
// raises the max). With ``keep`` s becomes exp(s - max).
template <int NT, bool kExact = false>
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
      const float x = score_exp<kExact>(s[j][e] - mc[e >> 1]);
      sum[e >> 1] += x;
      if (keep) s[j][e] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every chunk holds a key below n, so mc is finite; the first
    // chunk's factor is exp(-inf) = 0
    l[r] = l[r] * score_exp<kExact>(m[r] - mc[r]) + tc::quad_sum(sum[r]);
    m[r] = mc[r];
  }
}

template <int NT, bool kExact = false>
__device__ __forceinline__ void exp_scores(float (&s)[NT][4],
                                           const float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = score_exp<kExact>(s[j][e] - m[e >> 1]);
    }
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

// The scores of one step of the ring body: Q's fragments from registers,
// or from the staged rows (kQSmem); the same values.
template <int Dp, int NT, bool kQSmem>
__device__ __forceinline__ void ring_scores(
    float (&s)[NT][4], const uint32_t (&qa)[kQSmem ? 1 : Dp / 16][4],
    const tc::bf16* qs, int q0, const tc::bf16* kb, int key0, int left,
    int npad, float scale, int lane) {
  if constexpr (kQSmem) {
    tc::step_scores_smem<Dp>(s, qs, q0, kb, key0, left, npad, scale, lane);
  } else {
    tc::step_scores<Dp>(s, qa, kb, key0, left, npad, scale, lane);
  }
}

// The bf16 key-chunked route, the ring body: one block per 16 * W queries
// (W consumer warps, a 16-row tile each, and one producer warp), K and
// then K and V streamed a register chunk at a time through the
// ring_stages(Dp) buffers of attention_mma.cuh's Ring. Each warp takes the
// whole-sequence body's steps on its tile in the same order, so it gives
// the same bits (see the note at the top).
template <int Dp>
__global__ void __launch_bounds__(32 * (ring_warps(Dp) + 1), ring_blocks(Dp))
attention_fwd_mma_ring_kernel(const Operand<tc::bf16> q_op,
                              const Operand<tc::bf16> k_op,
                              const Operand<tc::bf16> v_op,
                              tc::bf16* __restrict__ out, int n, int heads,
                              int d, float scale) {
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  constexpr int kBuf = 2 * kChunk * kPad;  // K then V of one chunk
  constexpr int PT = ring_piece<Dp>();
  constexpr int kStages = ring_stages(Dp);
  extern __shared__ uint4 smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);
  tc::Ring ring{bars, bars + kStages};
  const int warps = (blockDim.x >> 5) - 1;  // the last warp stages
  const int rows = 16 * warps;
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(
      reinterpret_cast<char*>(smem_tc) + ring_header(Dp));  // rows rows
  tc::bf16* kv = qs + rows * kPad;  // kStages buffers of kBuf

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * rows;
  const int npad = tc::pad16(n);
  const int tiles = min(warps, (npad - q0) / 16);  // warps with a tile
  // Dp >= 128: K and V staged by bulk copies where their rows allow it
  // (attention_mma.cuh), their columns d..Dp-1 zeroed once here
  constexpr bool kBulkWidth = Dp >= 128;
  bool bulk = false;
  if constexpr (kBulkWidth) {
    bulk = tc::rows_16b(k_op.head(b, h, d), k_op.row, d) &&
           tc::rows_16b(v_op.head(b, h, d), v_op.row, d);
    tc::ring_init(ring, kStages, tiles,
                  bulk ? tc::kRingBulkCount : tc::kRingFullCount);
    if (bulk && d < Dp) {
      tc::ring_zero_columns<Dp>(kv, kStages * 2 * kChunk, d, threadIdx.x,
                                blockDim.x);
    }
  } else {
    tc::ring_init(ring, kStages, tiles);
  }
  tc::stage_rows<Dp>(q_op.head(b, h, d) + q0 * q_op.row, q_op.row, qs,
                     min(rows, n - q0), rows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kChunk - 1) / kChunk;
  if (warp == warps) {  // chunk i < chunks: K for sweep 1; then K and V
    const tc::bf16* kh = k_op.head(b, h, d);
    const tc::bf16* vh = v_op.head(b, h, d);
    for (int i = 0; i < 2 * chunks; ++i) {
      const bool with_v = i >= chunks;
      const int k0 = (with_v ? i - chunks : i) * kChunk;
      const int cnt = min(kChunk, n - k0);
      if constexpr (kBulkWidth) {
        if (bulk) {
          tc::ring_produce_bulk(
              ring, kStages, (with_v ? 4u : 2u) * cnt * d, lane,
              [&](int st, uint64_t* bar) {
                tc::bf16* kb = kv + st * kBuf;
                tc::bulk_rows<Dp>(kh + k0 * k_op.row, k_op.row, kb, cnt,
                                  kChunk, d, bar, lane);
                if (with_v) {
                  tc::bulk_rows<Dp>(vh + k0 * v_op.row, v_op.row,
                                    kb + kChunk * kPad, cnt, kChunk, d, bar,
                                    lane);
                }
              });
          continue;
        }
      }
      tc::ring_produce(ring, kStages, [&](int st) {
        tc::bf16* kb = kv + st * kBuf;
        tc::stage_rows_by<Dp>(kh + k0 * k_op.row, k_op.row, kb, cnt, kChunk,
                              d, lane, 32u);
        if (with_v) {
          tc::stage_rows_by<Dp>(vh + k0 * v_op.row, v_op.row,
                                kb + kChunk * kPad, cnt, kChunk, d, lane,
                                32u);
        }
      });
    }
    tc::cp_async_wait_all();
    return;
  }
  if (warp >= tiles) return;

  // Q's A fragments in registers, or read from the staged rows at each
  // step in the same mma order (ring_q_smem)
  constexpr bool kQSmem = ring_q_smem(Dp);
  uint32_t qa[kQSmem ? 1 : Dp / 16][4];
  if constexpr (!kQSmem) tc::load_a<Dp>(qa, qs, 16 * warp, lane);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  if constexpr (Dp >= 128) {
    // The first sweep holds the whole chunk's scores (S computed once, as
    // fold_chunk takes it), while the output is not yet live; the second
    // takes PT tiles at a time beside the output.
    for (int c = 0; c < chunks; ++c) {
      tc::ring_acquire(ring);
      const tc::bf16* kb = kv + ring.stage * kBuf;
      float sc[NT][4];
      ring_scores<Dp, NT, kQSmem>(sc, qa, qs, 16 * warp, kb, 0,
                                  n - c * kChunk, kChunk, scale, lane);
      tc::ring_release(ring, kStages, lane);
      float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mc[0] = fmaxf(mc[0], fmaxf(sc[j][0], sc[j][1]));
        mc[1] = fmaxf(mc[1], fmaxf(sc[j][2], sc[j][3]));
      }
      mc[0] = tc::quad_max(mc[0]);
      mc[1] = tc::quad_max(mc[1]);
      lane_exps(sc, mc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += sc[j][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every chunk holds a key below n, so mc is finite; the first
        // chunk's factor is exp(-inf) = 0
        l[r] = l[r] * score_exp<false>(m[r] - mc[r]) + tc::quad_sum(sum[r]);
        m[r] = mc[r];
      }
    }
    // P normalised by the rounded reciprocal of the sum
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
    float o[Dp / 8][4] = {};
    for (int c = 0; c < chunks; ++c) {
      tc::ring_acquire(ring);
      const tc::bf16* kb = kv + ring.stage * kBuf;
      const int left = n - c * kChunk;  // keys from the chunk's first
#pragma unroll 1
      for (int key0 = 0; key0 < kChunk; key0 += 8 * PT) {
        float s[PT][4];
        ring_scores<Dp, PT, kQSmem>(s, qa, qs, 16 * warp, kb, key0, left,
                                    kChunk, scale, lane);
        lane_exps(s, m);
        accumulate_pv<Dp>(o, s, inv, kb + kChunk * kPad, key0, kChunk, lane);
      }
      tc::ring_release(ring, kStages, lane);
    }
    tc::store_rows<Dp>(o, out + static_cast<int64_t>(b) * n * heads * d +
                              h * d,
                       static_cast<int64_t>(heads) * d, q0 + 16 * warp, n, d,
                       lane);
  } else {
    float s[PT][4];
    float o[Dp / 8][4] = {};
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int c = 0; c < chunks; ++c) {
        tc::ring_acquire(ring);
        const tc::bf16* kb = kv + ring.stage * kBuf;
        const int left = n - c * kChunk;  // keys from the chunk's first
        if (sweep == 1) {
#pragma unroll 1
          for (int key0 = 0; key0 < kChunk; key0 += 8 * PT) {
            ring_scores<Dp, PT, kQSmem>(s, qa, qs, 16 * warp, kb, key0, left,
                                        kChunk, scale, lane);
            lane_exps(s, m);
            accumulate_pv<Dp>(o, s, inv, kb + kChunk * kPad, key0, kChunk,
                              lane);
          }
        } else {
          // fold_chunk a piece at a time: the chunk's max over every
          // piece's scores, then their exps and sum, the scores recomputed
          float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll 1
          for (int key0 = 0; key0 < kChunk; key0 += 8 * PT) {
            ring_scores<Dp, PT, kQSmem>(s, qa, qs, 16 * warp, kb, key0, left,
                                        kChunk, scale, lane);
#pragma unroll
            for (int j = 0; j < PT; ++j) {
              mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
              mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
            }
          }
          mc[0] = tc::quad_max(mc[0]);
          mc[1] = tc::quad_max(mc[1]);
#pragma unroll 1
          for (int key0 = 0; key0 < kChunk; key0 += 8 * PT) {
            ring_scores<Dp, PT, kQSmem>(s, qa, qs, 16 * warp, kb, key0, left,
                                        kChunk, scale, lane);
            lane_exps(s, mc);
#pragma unroll
            for (int j = 0; j < PT; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[e >> 1] += s[j][e];
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // every chunk holds a key below n, so mc is finite; the first
            // chunk's factor is exp(-inf) = 0
            l[r] = l[r] * score_exp<false>(m[r] - mc[r]) +
                   tc::quad_sum(sum[r]);
            m[r] = mc[r];
          }
        }
        tc::ring_release(ring, kStages, lane);
      }
      // P normalised by the rounded reciprocal of the sum
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
    }
    tc::store_rows<Dp>(o, out + static_cast<int64_t>(b) * n * heads * d +
                              h * d,
                       static_cast<int64_t>(heads) * d, q0 + 16 * warp, n, d,
                       lane);
  }
}

// o += P V over one chunk of keys from key0 on, in f32: P = e * inv from
// the exp'd scores e, each 8-key tile the A operand of a three-term TF32
// product with V, group_of(NT) tiles at a time through a fresh
// accumulator (attention_tf32.cuh, accumulate_tiles); tiles at or past
// npad skipped.
template <int Dp, int NT>
__device__ __forceinline__ void accumulate_pv_f32(float (&o)[Dp / 8][4],
                                                  const float (&s)[NT][4],
                                                  const float (&inv)[2],
                                                  const float* vs, int key0,
                                                  int npad, int lane) {
  constexpr int kG = tf::group_of(NT);
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += kG) {
    if (key0 + 8 * j0 >= npad) break;
    float p[kG][4];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      p[i][0] = s[j0 + i][0] * inv[0];
      p[i][1] = s[j0 + i][1] * inv[0];
      p[i][2] = s[j0 + i][2] * inv[1];
      p[i][3] = s[j0 + i][3] * inv[1];
    }
    tf::accumulate_tiles<Dp>(o, p, vs, key0 + 8 * j0, npad, lane);
  }
}

// The f32 body, whole-sequence route: the bf16 body's structure (one block
// per (head, image), one 16-row query tile per warp at a time, the same
// chunks of keys) with every product on the tensor cores by the three-way
// TF32 split, Q's A fragments read from shared memory, exp by expf, P
// normalised in f32 and not rounded (see the note at the top).
template <int Dp>
__global__ void __launch_bounds__(32 * kF32Warps)
attention_fwd_tf32_kernel(const Operand<float> q_op,
                          const Operand<float> k_op,
                          const Operand<float> v_op, float* __restrict__ out,
                          int n, int heads, int d, float scale) {
  constexpr int kPad = tf::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  extern __shared__ uint4 smem_tc[];
  const int npad = tf::pad16(n);
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* ks = qs + npad * kPad;
  float* vs = ks + npad * kPad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t hd = static_cast<int64_t>(heads) * d;

  tf::stage_rows<Dp>(q_op.head(b, h, d), q_op.row, qs, n, npad, d);
  tf::stage_rows<Dp>(k_op.head(b, h, d), k_op.row, ks, n, npad, d);
  tf::stage_rows<Dp>(v_op.head(b, h, d), v_op.row, vs, n, npad, d);
  tc::cp_async_wait_all();
  __syncthreads();

  float* outh = out + static_cast<int64_t>(b) * n * hd + h * d;
  const int chunks = (npad + kChunk - 1) / kChunk;
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    float s[NT][4];
    // rows g and g + 8 of the tile: max and sum of exp(s - max)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      tf::masked_scores<Dp>(s, qs, r0, ks, c * kChunk, n, npad, scale, lane);
      fold_chunk<NT, true>(s, m, l, chunks == 1);
    }
    // P normalised by the rounded reciprocal of the sum
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    float o[Dp / 8][4] = {};
    for (int c = 0; c < chunks; ++c) {
      const int key0 = c * kChunk;
      if (chunks > 1) {
        tf::masked_scores<Dp>(s, qs, r0, ks, key0, n, npad, scale, lane);
        exp_scores<NT, true>(s, m);
      }
      accumulate_pv_f32<Dp>(o, s, inv, vs, key0, npad, lane);
    }
    tf::store_rows<Dp>(o, outh, hd, r0, n, d, lane);
  }
}

// The f32 key-chunked route: one block per 16 * kLongWarps queries, K and
// V chunks double-buffered by cp.async groups, two block barriers a chunk,
// with the f32 body's arithmetic in the whole-sequence f32 body's order:
// both routes give the same bits.
template <int Dp>
__global__ void __launch_bounds__(kLongWarps * 32)
attention_fwd_tf32_long_kernel(const Operand<float> q_op,
                               const Operand<float> k_op,
                               const Operand<float> v_op,
                               float* __restrict__ out, int n, int heads,
                               int d, float scale) {
  constexpr int kPad = tf::row_pad(Dp);
  constexpr int NT = chunk_tiles<Dp>();
  constexpr int kChunk = 8 * NT;
  constexpr int kRows = 16 * kLongWarps;
  extern __shared__ uint4 smem_tc[];
  float* qs = reinterpret_cast<float*>(smem_tc);  // kRows rows
  float* kv = qs + kRows * kPad;  // 2 buffers of K then V, kChunk rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kRows;
  const int npad = tf::pad16(n);
  const bool active = q0 + 16 * warp < npad;
  const int64_t hd = static_cast<int64_t>(heads) * d;
  const float* kh = k_op.head(b, h, d);
  const float* vh = v_op.head(b, h, d);

  tf::stage_rows<Dp>(q_op.head(b, h, d) + q0 * q_op.row, q_op.row, qs,
                     min(kRows, n - q0), kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kChunk - 1) / kChunk;
  // stage chunk c of K (and of V) into buffer c % 2, as one cp.async group
  auto stage = [&](int c, bool with_v) {
    float* kb = kv + (c & 1) * 2 * kChunk * kPad;
    const int k0 = c * kChunk;
    const int cnt = min(kChunk, n - k0);
    tf::stage_rows<Dp>(kh + k0 * k_op.row, k_op.row, kb, cnt, kChunk, d);
    if (with_v) {
      tf::stage_rows<Dp>(vh + k0 * v_op.row, v_op.row, kb + kChunk * kPad,
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
        const float* kb = kv + (c & 1) * 2 * kChunk * kPad;
        tf::masked_scores<Dp>(s, qs, 16 * warp, kb, 0, n - c * kChunk,
                              kChunk, scale, lane);
        if (!second) {
          fold_chunk<NT, true>(s, m, l, false);
        } else {
          exp_scores<NT, true>(s, m);
          accumulate_pv_f32<Dp>(o, s, inv, kb + kChunk * kPad, 0, kChunk,
                                lane);
        }
      }
      __syncthreads();  // buffer c % 2 is free for chunk c + 2
    }
    // P normalised by the rounded reciprocal of the sum
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
  }
  if (active) {
    tf::store_rows<Dp>(o, out + static_cast<int64_t>(b) * n * hd + h * d,
                       hd, q0 + 16 * warp, n, d, lane);
  }
}

// dtype: 0 = float32, 1 = bfloat16
size_t smem_whole(int n, int dtype, int dp) {
  const size_t rows = 3 * static_cast<size_t>(tc::pad16(n));
  return dtype == 1 ? sizeof(tc::bf16) * rows * tc::row_pad(dp)
                    : sizeof(float) * rows * tf::row_pad(dp);
}

size_t smem_long(int dtype, int dp) {
  if (dtype == 1) {
    return ring_header(dp) +
           sizeof(tc::bf16) * tc::row_pad(dp) *
               (16 * ring_warps(dp) +
                ring_stages(dp) * 2 * 8 * chunk_tiles_for(dp));
  }
  const int rows = 16 * kLongWarps + 4 * 8 * chunk_tiles_for(dp);
  return sizeof(float) * rows * tf::row_pad(dp);
}

// whether the whole-sequence body exists at dp and fits one block at n
bool whole_fits(int n, int dtype, int dp) {
  return !tc::a_in_smem(dp) && smem_whole(n, dtype, dp) <= tc::kSmemLimit;
}

// 0: the whole-sequence route, 1: the key-chunked route (see the note at
// the top): the whole body while one register chunk holds the sequence
// (S computed once) and an SM holds at least kWholeBlocks of its blocks.
int route(int n, int dtype, int dp) {
  if (!whole_fits(n, dtype, dp) || tc::pad16(n) > 8 * chunk_tiles_for(dp)) {
    return 1;
  }
  return tc::blocks_per_sm(smem_whole(n, dtype, dp)) >= kWholeBlocks ? 0 : 1;
}

size_t smem_of(int r, int n, int dtype, int dp) {
  return r == 0 ? smem_whole(n, dtype, dp) : smem_long(dtype, dp);
}

size_t smem_bytes(int n, int dtype, int dp) {
  return smem_of(route(n, dtype, dp), n, dtype, dp);
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

// Launch the bf16 body on route r (0 or 1; the caller checked that r = 0
// fits).
template <int Dp>
cudaError_t launch_mma(const Operands3<tc::bf16>& ops, void* out, int batch,
                       int n, int heads, int d, float scale, int r,
                       cudaStream_t stream) {
  using tc::bf16;
  bf16* o = static_cast<bf16*>(out);
  const size_t smem = smem_of(r, n, 1, Dp);
  if constexpr (!tc::a_in_smem(Dp)) {
    if (r == 0) {
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
      reinterpret_cast<const void*>(attention_fwd_mma_ring_kernel<Dp>), smem);
  if (err != cudaSuccess) return err;
  const int tiles = tc::pad16(n) / 16;
  const int warps = tiles < ring_warps(Dp) ? tiles : ring_warps(Dp);
  attention_fwd_mma_ring_kernel<Dp><<<
      dim3((tiles + warps - 1) / warps, heads, batch), 32 * (warps + 1),
      smem, stream>>>(ops.q, ops.k, ops.v, o, n, heads, d, scale);
  return cudaGetLastError();
}

// Launch the f32 body on route r (as launch_mma).
template <int Dp>
cudaError_t launch_f32(const Operands3<float>& ops, void* out, int batch,
                       int n, int heads, int d, float scale, int r,
                       cudaStream_t stream) {
  float* o = static_cast<float*>(out);
  const size_t smem = smem_of(r, n, 0, Dp);
  if constexpr (!tc::a_in_smem(Dp)) {
    if (r == 0) {
      const cudaError_t err = allow_smem(
          reinterpret_cast<const void*>(attention_fwd_tf32_kernel<Dp>), smem);
      if (err != cudaSuccess) return err;
      const int threads = 32 * tc::warps_for(tc::pad16(n) / 16, kF32Warps);
      attention_fwd_tf32_kernel<Dp><<<dim3(heads, batch), threads, smem,
                                      stream>>>(ops.q, ops.k, ops.v, o, n,
                                                heads, d, scale);
      return cudaGetLastError();
    }
  }
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(attention_fwd_tf32_long_kernel<Dp>),
      smem);
  if (err != cudaSuccess) return err;
  const int blocks = (tc::pad16(n) + 16 * kLongWarps - 1) / (16 * kLongWarps);
  attention_fwd_tf32_long_kernel<Dp><<<dim3(blocks, heads, batch),
                                       32 * kLongWarps, smem, stream>>>(
      ops.q, ops.k, ops.v, o, n, heads, d, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim < 1 || batch < 1 || batch > 65535 ||
         n < 1 || heads < 1 || heads > 65535;
}

// strides: element strides (image, row) of q, k and v, in that order;
// forced: -1 takes the route of route() (the entry points), 0 or 1 that
// route (the internal launch of attention_qkv_fwd_on_route)
int dispatch(const void* q, const void* k, const void* v,
             const int64_t* strides, void* out, int batch, int n, int heads,
             int d, float scale, int dtype, int forced, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d >= attn_wide::kNarrowest) {
    if (forced >= 0) return static_cast<int>(err);
    if (dtype == 1) {
      err = attn_wide::launch_fwd<tc::bf16>(q, k, v, strides, out, batch, n,
                                            heads, d, scale, s);
    } else if (dtype == 0) {
      err = attn_wide::launch_fwd<float>(q, k, v, strides, out, batch, n,
                                         heads, d, scale, s);
    }
    return static_cast<int>(err);
  }
  const int dp = tc::padded_width(d);
  const int r = forced < 0 ? route(n, dtype, dp) : forced;
  if (r > 1 || (r == 0 && !whole_fits(n, dtype, dp))) {
    return static_cast<int>(err);
  }
  if (dtype == 1) {
    const auto ops = operands<tc::bf16>(q, k, v, strides);
    switch (dp) {
      case 16: err = launch_mma<16>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 32: err = launch_mma<32>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 64: err = launch_mma<64>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 128:
        err = launch_mma<128>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      default:
        err = launch_mma<256>(ops, out, batch, n, heads, d, scale, r, s);
    }
  } else if (dtype == 0) {
    const auto ops = operands<float>(q, k, v, strides);
    switch (dp) {
      case 16: err = launch_f32<16>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 32: err = launch_f32<32>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 64: err = launch_f32<64>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      case 128:
        err = launch_f32<128>(ops, out, batch, n, heads, d, scale, r, s);
        break;
      default:
        err = launch_f32<256>(ops, out, batch, n, heads, d, scale, r, s);
    }
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The route the body for ``dtype`` (0 = float32, 1 = bfloat16) takes at
// sequence length n and head width head_dim: 0 = the whole sequence in
// one block's shared memory, 1 = key-chunked, 2 = the body of head
// widths above 256 (attention_wide.cuh).
int attention_qkv_fwd_route(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return 2;
  return route(n, dtype, tc::padded_width(head_dim));
}

// Shared memory one block of that route needs, in bytes (static on
// route 2, dynamic on the others).
int attention_qkv_fwd_smem_bytes(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) {
    return attn_wide::fwd_smem_bytes(dtype);
  }
  return static_cast<int>(smem_bytes(n, dtype, tc::padded_width(head_dim)));
}

// The kernel that runs at that (n, dtype, head_dim), by its name in this
// source (tools and tests read which body a shape takes).
const char* attention_qkv_fwd_body(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return "wide_fwd_kernel";
  const int dp = tc::padded_width(head_dim);
  if (route(n, dtype, dp) == 0) {
    return dtype == 1 ? "attention_fwd_mma_kernel"
                      : "attention_fwd_tf32_kernel";
  }
  return dtype == 1 ? "attention_fwd_mma_ring_kernel"
                    : "attention_fwd_tf32_long_kernel";
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
                  batch, n, heads, head_dim, scale, dtype, -1, stream);
}

// attention_qkv_fwd on the given route (0 whole sequence, 1 key-chunked)
// whatever route() would take: the two routes compared at one length
// (tools and tests; no entry point a user calls). Head widths above 256
// and a whole-sequence route that does not exist or fit there return
// cudaErrorInvalidValue.
int attention_qkv_fwd_on_route(const void* qkv, void* out, int batch, int n,
                               int heads, int head_dim, float scale,
                               int dtype, int route, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1) ||
      route < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * head_dim;
  const int64_t row = 3 * hd;
  const int64_t img = n * row;
  const int64_t strides[6] = {img, row, img, row, img, row};
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  return dispatch(base, base + hd * es, base + 2 * hd * es, strides, out,
                  batch, n, heads, head_dim, scale, dtype, route, stream);
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
                  dtype, -1, stream);
}

const char* attention_qkv_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
