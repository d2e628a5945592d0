// Fused multi-head attention backward, on the packed qkv projection or on
// q, k and v as three operands.
//
// Replaces the TPU kernel hgr_tpu/ops/attention_pallas.py:175
// (_attention_qkv_bwd_kernel, launched by _attention_qkv_bwd_impl :233
// from the custom VJP _bwd :398) through attention_qkv_bwd, and
// _split_bwd_impl :302 (the same kernel fed the concatenation of three
// operands, its output cut in three) through attention_split_bwd. It
// differentiates the forward kernel csrc/attention_qkv_fwd.cu as
// executed, from q, k, v and the output cotangent g (B, N, H*D), without
// any saved N x N tensor.
//
// What it computes, per image b and head h (any head width D), all in
// f32:
//   s[i, j]  = (q_i . k_j) * scale, P = softmax_j(s)   (recomputed)
//   dA[i, j] = g_i . v_j
//   dS[i, j] = P[i, j] * (dA[i, j] - sum_j dA[i, j] P[i, j]) * scale
//   dq_i = sum_j dS[i, j] k_j          dk_j = sum_i dS[i, j] q_i
//   dv_j = sum_i P^[i, j] g_i,  P^ = P rounded to the compute type T and
//                                    widened back (the forward multiplies
//                                    v by that rounded P, :218-225)
// and writes dq, dk and dv once each, in T. The row sum rd = sum_j dA P
// is taken with the f32, unrounded P, as the Pallas kernel takes it
// (:193-208); it is not FlashAttention's rowsum(dO * O), which would come
// from the rounded P and a rounded O.
//
// One kernel body serves both entry points: every operand (q, k, v, g in;
// dq, dk, dv out) is a base pointer with an image stride and a row stride
// in elements. attention_qkv_bwd passes the packed qkv and the packed
// gradient (B, N, 3*H*D) as three thirds each with row stride 3*H*D;
// attention_split_bwd passes its caller's operands as they are. The two
// entry points compute bit-identical gradients on the same data. Head
// widths above 256 take the bodies of attention_wide.cuh (two kernels
// and the chunked route's statistics scratch). Up to 256
// widths are handled as in the forward: bodies templated over the padded
// width Dp in {16, 32, 64, 128, 256}, staged features D..Dp-1 zero, output
// columns beyond D never written. At Dp = 256 every length takes the
// key-chunked route (a warp's A fragments and its 16 x Dp gradient tiles
// do not fit one thread's registers in the whole-sequence bodies): the
// query-tile kernel reads Q's and G's A fragments from shared memory
// (attention_mma.cuh, products_smem) beside its 128 dq accumulators, and
// the key-tile kernel gives each key tile two warps, one summing dk and
// one dv (128 accumulators each, where one warp would need 256); the dv
// warp computes S^T only, the dk warp S^T and dA^T.
//
// Bound on an H100 SXM at the training shape (B=64, N=145, H=8, D=32,
// bf16): the function must move 33.26 MB (qkv 14.25 MB and g 4.75 MB read
// once, the gradient 14.25 MB written once), 9.9 us at 3.35 TB/s, against
// 10 N^2 D H B = 3.44 GFLOP for the five products, 3.5 us at 989 TFLOP/s.
// The kernel is memory-bound. In f32 at the --dtype mixed training shape
// (B=256, N=145): 266 MB, 79 us, against 13.8 GFLOP, 206 us on the CUDA
// cores and 83.5 us as the three TF32 products of this body (3 x 13.8
// GFLOP at 495 TFLOP/s): on the tensor cores it is bound by its
// operations.
//
// Two bodies, chosen by the compute type, no atomics anywhere, so the
// result is deterministic, and both in two phases: query rows give dq and
// the rows' softmax statistics (max, 1 / sum, rd), then key rows give dk
// and dv from those statistics. While an SM holds four blocks that stage
// the head's whole Q, K, V and G in bf16 at Dp = 32 (n <= 160), two in
// f32 and at other bf16 widths (n <= 192 at D = 32 in f32), both
// phases run in one block per (head, image) with the statistics in
// shared memory. Past that, the key-chunked route runs the
// phases as two kernels: one over query tiles (dq and the statistics, K
// and V streamed through shared memory in chunks), then one over key
// tiles (dk and dv, Q, G and the statistics streamed likewise); the
// statistics pass through a (B, H, 3, pad16(N)) f32 scratch that the
// wrapper allocates. Each gradient element is still summed by one thread
// in a fixed order, and both routes take the same steps in the same
// order: they give the same bits. The rule is the measured crossover:
// timed at (64, n, 768) bf16 on an H100 (chip_smoke's route sweep), the
// whole body took 0.085 ms against the ring pair's 0.117 at n = 145 (four
// blocks an SM), 0.134 against 0.130 at n = 161 and 0.214 against 0.160
// at n = 193 (three) (PERF.md section 6), at D = 32; f32 keeps the
// two-block rule measured for its bodies, and so do the other bf16
// widths, whose crossover was not swept.
//
// bf16 (every train path): Hopper's tensor cores through
// mma.sync.aligned.m16n8k16 bf16 -> f32 (attention_mma.cuh). The block
// stages the head's Q, K, V and G as bf16 rows of (Dp + 8) * 2 bytes with
// 16-byte cp.async copies (element by element where an operand is not
// 16-byte aligned or its row stride or D is not a multiple of 8), the row
// count padded to a multiple of 16 with zero rows: 332 bytes of shared
// memory per padded row at Dp = 32 (53,120 at N = 145). Each warp owns
// one 16-row tile at a time and sweeps the other side 16 rows at a time.
//   1. query tile: S = Q K^T (masked at keys >= n) and dA = G V^T; the
//      row max m, the sum l of exp(s - m) and sum dA exp(s - m) in one
//      sweep (the sums rescaled when a later chunk raises m), so
//      rd = sum dA P after it; then, sweeping again, P = exp(s - m) / l
//      (by the rounded reciprocal of l), dS = P (dA - rd) scale and
//      dq = dS K. m, 1 / l and rd go to shared memory.
//   2. key tile: S^T = K Q^T and dA^T = V G^T, P^T from the saved m and
//      1 / l, dS^T likewise, zeroed at query rows >= n (the zero pad rows
//      of Q have a softmax of their own); dk = dS^T Q, dv = round(P^T) G.
// P and dS enter the tensor cores as A fragments repacked from the
// accumulators; K, Q and G (the B operands of dq, dk, dv) through
// ldmatrix.trans. dS is an f32 value that one bf16 would cut to 8 bits;
// it goes in as three bf16 terms (kSplit; each the rounding of what the
// ones before leave out), whose products sum to dS's f32 product within
// an f32 product's own error. Two terms (hi + lo) miss by ~5e-6
// (tests/test_torch_attention.py), enough to flip now and then the bf16
// rounding of a gradient near 1 over a B = 256 batch.
// The bf16 inputs and the rounded P are exact operands. Both phases
// round the scaled score with __fmul_rn and take P and dS by the same
// instructions; the tensor cores give Q K^T and K Q^T the same bits
// (tools/probe_score_bits.py), so the two phases see the same P. The
// key-chunked kernels take the same 16-row steps in the same order, so
// they compute the same bits as the whole-sequence body would.
//
// The key-chunked route is the pair of ring bodies at every padded width
// (Dp = 32: the 448 px path). Bound at (B=64, N=785, H=8, D=32, bf16):
// 180.1 MB moved (qkv and g read, dqkv written once), 0.0537 ms at 3.35
// TB/s, against 10 N^2 D H B = 1.01e11 FLOP, 0.102 ms at 989 TFLOP/s:
// bound by its operations. The bits ask for more work than that: S and dA
// twice in phase 1 and once in phase 2, dS into dq and dk as kSplit bf16
// terms, 13 products of 2 N^2 D a head (2.62e11 FLOP, 0.27 ms even at the
// peak), and three expf a score (~0.23 ms at the SFU's 16 a clock an SM).
// What the bodies do about the rest:
//   - one block per 16 W rows (W = ring_warps(Dp) consumer warps, fewer
//     for a shorter head), the other side streamed through
//     attention_mma.cuh's Ring (one producer warp, ring_stages(Dp) buffers
//     of ring_rows(Dp) rows with a full and an empty mbarrier each): no
//     block barrier in the loop, and each staged chunk serves 7 tiles
//     where the earlier kernels' served 4 (8 blocks a head at N = 785
//     against 13: ~1.3 GB through L2 a call against ~2.1);
//   - each warp step spans 8 * ring_tiles() keys (phase 1) or queries
//     (phase 2) instead of 16: the products, maxima, exps and shuffles of
//     its 16-row sub-steps are issued side by side, then folded
//     (fold_steps) and accumulated (accumulate_steps,
//     key_accumulate_steps) in the 16-row order, so that m, l, rd, dq, dk
//     and dv keep their bits.
// At Dp = 128 and 256 (head widths 65 to 256) the bound at (B=16, N=785,
// H=2) is 2.52e10 FLOP, 0.0255 ms, at D = 128 (45.0 MB, 0.0134 ms by
// bytes) and 5.05e10, 0.0510 ms, at 256 (90.0 MB, 0.0269 ms); the bits'
// 13 products a head 0.033 and 0.133 ms at the peak. The earlier pair
// there (two cp.async buffers, two block barriers a chunk, 16-row steps;
// the CPU emulator keeps it as the ring pair's bit reference,
// tools/emulate/chunked_bwd.cuh) ran its query kernel at Dp = 256 one
// block of 4 warps an SM. The ring pair there:
//   - stages the other side a row per bulk copy (attention_mma.cuh,
//     bulk_rows), its columns d..Dp-1 zeroed once;
//   - reads the A tiles from shared memory (products_smem) beside the
//     Dp / 2 accumulators of dq (or dk, dv);
//   - at Dp = 256 takes 4-tile steps (a whole 32-row chunk: each A
//     fragment read once for 32 rows) with 7 working warps an SM, and
//     gives each key tile two warps, one for dk and one for dv;
//   - at Dp = 128 runs two query blocks of 8 warps an SM and one key
//     block of 7 tiles, each warp summing dk and dv of its tile.
// In turns at (16, 785, 2 x D) against the earlier pair on an H100
// (PERF.md section 6): 0.557 -> 0.343 ms at D = 128, 1.540 ->
// 0.627 at 256.
//
// f32 (--dtype mixed's decoder, the check paths; gradients held at 1e-4):
// the bf16 body's phases, routes and order on the tensor cores by a
// three-way TF32 split of every operand of the five products
// (attention_tf32.cuh): x . y as big_x small_y + small_x big_y +
// big_x big_y on m16n8k8 TF32 mma (one TF32 term misses the gradients by
// ~1e-3). Q, K, V and G are staged as f32 rows of Dp + 4 floats (4 (Dp +
// 4) * 4 + 12 bytes per padded row, 94,080 at N = 145) and split in
// registers as their fragments load; the A tiles (Q and G, then K and V)
// are read from shared memory a step of 8 features at a time for 4 tiles
// (32 rows) of the other side. dS and P stay f32 (dv = P^T G with P
// unrounded, as the forward multiplies V by it); as A operands they are
// the S and dA accumulators, the 8 queries or keys of each step taken in
// the permuted order of attention_tf32.cuh. Phase 2's S^T = K Q^T and
// dA^T = V G^T take the cross terms in the order of phase 1's S = Q K^T
// and dA = G V^T, so the tensor cores give both phases the same score bits
// (tools/probe_score_bits.py --dtype float32: none differ) and the same P
// and dS. PERF.md section 6 has this body's times beside SDPA's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_wide.cuh"

namespace {

namespace tc = attn_mma;
namespace tf = attn_tf32;

// One (B, N, H*D) operand: element strides between images and rows.
template <typename P>
struct Operand {
  P* p;
  int64_t img;
  int64_t row;
  // the head's columns of image b: element (i, f) is at [i * row + f]
  __device__ __forceinline__ P* head(int b, int h, int d) const {
    return p + b * img + h * d;
  }
};

template <typename T>
struct Operands {
  Operand<const T> q, k, v, g;
  Operand<T> dq, dk, dv;
};

// The statistics scratch of the key-chunked routes: (B, H, 3, npad) f32,
// the rows' max, 1 / sum and rd.
__device__ __forceinline__ float* stats_of(float* stats, int b, int h,
                                           int heads, int npad) {
  return stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
}

// 8-row C tiles of S and dA a warp holds at a time (16 rows, ~100
// registers a thread at Dp = 32)
constexpr int kBwdTiles = 2;
constexpr int kStep = 8 * kBwdTiles;  // rows of the other side per step
// ... and in the f32 bodies, whose products take 4 tiles at a time
// (attention_tf32.cuh, group_of)
constexpr int kF32Tiles = 4;
constexpr int kF32Step = 8 * kF32Tiles;
// Most warps per block of the f32 whole-sequence body: 10 tiles at N =
// 145 go 2 to each of 5 warps (tools/tune_attention.py --dtype float32
// times 4)
constexpr int kF32Warps = 8;
// Most warps per block: 4 blocks of 4 fill an SM's shared memory (53 KB
// each at N = 145) with 16 warps. tools/tune_attention.py times other
// sizes.
constexpr int kBwdWarps = 4;
// bf16 parts that carry dS into the tensor cores (3: all of f32's bits)
constexpr int kSplit = 3;
// Key-chunked route: 16-row tiles (warps) per block of the f32 kernels,
// and rows of the other side per staged chunk (the f32 kernels', and the
// bf16 ring bodies' at Dp <= 64).
constexpr int kLongWarps = 4;
constexpr int kLongRows = 64;
// Warps per key tile in the f32 key-chunked route's key kernel: two at
// Dp = 256 (dk and dv each in a warp of its own), else one (both).
__host__ __device__ constexpr int key_roles(int dp) {
  return tc::a_in_smem(dp) ? 2 : 1;
}
// The f32 key-chunked kernels: tiles (warps) per block and rows of the
// other side per staged chunk; at Dp = 256 half of each, so that two
// f32 tiles and two double-buffered chunks fit one block's shared memory.
__host__ __device__ constexpr int f32_long_warps(int dp) {
  return tc::a_in_smem(dp) ? kLongWarps / 2 : kLongWarps;
}
__host__ __device__ constexpr int f32_long_rows(int dp) {
  return tc::a_in_smem(dp) ? kLongRows / 2 : kLongRows;
}
// Least whole-sequence blocks an SM must hold for that route to run
// (route()), and for the bf16 body at Dp = 32, the only width whose
// crossover with the ring pair was swept: 4, N <= 160 (chip_smoke's route
// sweep: the ring pair won from n = 161 on). Other widths keep 2.
constexpr int kWholeBlocks = 2;
constexpr int kWholeBlocksRing = 4;
// The key-chunked route's ring bodies, their constants per padded width:
// most consumer warps (16-row tiles) a block of the query kernel besides
// the producer warp, buffers of the ring (ring_rows(Dp) rows of the other
// side each), the least blocks an SM must hold (ptxas fits the registers
// to it: blocks of 8 warps, two an SM, leave 128 a thread; 9 would leave
// 96 and spill), and the 8-row C tiles of S and dA a warp takes a step.
// Dp <= 64: 64-row chunks, 4 tiles a step at Dp <= 32 (2 at 64); the key
// kernel's blocks are the query kernel's.
// tools/tune_attention.py times other values.
constexpr int kRingWarps = 7;
constexpr int kRingStages = 3;
constexpr int kRingBlocks = 2;
constexpr int kRingTiles = 4;
// Dp = 128 and 256 stage the other side by bulk copies (attention_mma.cuh) and
// read the A tiles (Q and G, K and V) from shared memory (products_smem). Times
// below: (16, 785, 2 heads) on an H100, tools/tune_attention.py --grid ring128
// / ring256 (PERF.md section 6). Dp = 128: 32-row chunks of 136-element rows,
// three buffers (114,352 bytes a block): the query kernel two blocks an SM of 8
// warps at 128 registers (dq's 64 accumulators); the key kernel one block of 7
// key tiles at 210 registers, one warp summing both dk and dv of a tile
// (kRingRoles128 = 1: 128 accumulators; two warps a tile, dk and dv apart, at
// two blocks of 3 tiles took 1.24x as long; 4-tile steps with the query kernel
// at one block 1.10x).
constexpr int kRingWarps128 = 7;
constexpr int kRingKeyTiles128 = 7;
constexpr int kRingRoles128 = 1;
constexpr int kRingStages128 = 3;
constexpr int kRingRows128 = 32;
constexpr int kRingTiles128 = 2;
constexpr int kRingBlocks128 = 2;
constexpr int kRingKeyBlocks128 = 1;
// Dp = 256: 32-row chunks of 264-element rows, three buffers (220,848 bytes;
// 0.6225 ms against two buffers' 0.6462): one block an SM. dq, dk and dv take
// 128 accumulators each, so the key kernel always gives a key tile two warps
// (dk, dv): 3 tiles, 7 warps, 235 registers (4 tiles make 9 warps, which cap
// ptxas at 168 and spilled). 4-tile steps (a whole chunk) read each A fragment
// once for 32 rows: 0.65 ms against 0.97 with 2-tile steps at (16, 785, 2 x
// 256).
constexpr int kRingWarps256 = 7;
constexpr int kRingKeyTiles256 = 3;
constexpr int kRingStages256 = 3;
constexpr int kRingRows256 = 32;
constexpr int kRingTiles256 = 4;
__host__ __device__ constexpr int ring_warps(int dp) {
  return dp <= 64 ? kRingWarps : dp == 128 ? kRingWarps128 : kRingWarps256;
}
__host__ __device__ constexpr int ring_key_tiles(int dp) {
  return dp <= 64 ? kRingWarps
                  : dp == 128 ? kRingKeyTiles128 : kRingKeyTiles256;
}
// warps a key tile of the key kernel: one sums dk and dv, or two (dk, dv)
__host__ __device__ constexpr int ring_roles(int dp) {
  return dp <= 64 ? 1 : dp == 128 ? kRingRoles128 : 2;
}
__host__ __device__ constexpr int ring_stages(int dp) {
  return dp <= 64 ? kRingStages : dp == 128 ? kRingStages128 : kRingStages256;
}
__host__ __device__ constexpr int ring_rows(int dp) {
  return dp <= 64 ? kLongRows : dp == 128 ? kRingRows128 : kRingRows256;
}
__host__ __device__ constexpr int ring_blocks(int dp) {
  return dp <= 64 ? kRingBlocks : dp == 128 ? kRingBlocks128 : 1;
}
__host__ __device__ constexpr int ring_key_blocks(int dp) {
  return dp <= 64 ? kRingBlocks : dp == 128 ? kRingKeyBlocks128 : 1;
}
template <int Dp>
__host__ __device__ constexpr int ring_tiles() {
  return Dp == 128  ? kRingTiles128
         : Dp == 256 ? kRingTiles256
         : Dp <= 32 || kRingTiles <= 2 ? kRingTiles : kRingTiles / 2;
}
static_assert(kLongRows % (8 * kRingTiles) == 0, "whole steps a chunk");
static_assert(kRingRows128 % (8 * kRingTiles128) == 0 &&
                  kRingRows256 % (8 * kRingTiles256) == 0 &&
                  kRingTiles128 % 2 == 0 && kRingTiles256 % 2 == 0,
              "whole 16-row steps a chunk");
// the ring's barriers (a full and an empty one a buffer) ahead of the
// staged rows, in whole 16-byte units
__host__ __device__ constexpr int ring_header(int dp) {
  return 16 * ((16 * ring_stages(dp) + 15) / 16);
}

// dS from P, dA and the row's sum rd, in the same instructions in both
// phases
__device__ __forceinline__ float dscore(float p, float da, float rd,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(da, rd)), scale);
}

// acc += X . rows[r0..r0+15] for x (16 x 16, C tiles x0 and x1 of 8
// columns each) in f32, as the sum of the products of its kSplit bf16
// parts
template <int Dp>
__device__ __forceinline__ void accumulate_split(float (&acc)[Dp / 8][4],
                                                 const float (&x0)[4],
                                                 const float (&x1)[4],
                                                 const tc::bf16* rows, int r0,
                                                 int lane) {
  uint32_t part[4][kSplit], a[kSplit][4];
  tc::pack_split(x0[0], x0[1], part[0]);
  tc::pack_split(x0[2], x0[3], part[1]);
  tc::pack_split(x1[0], x1[1], part[2]);
  tc::pack_split(x1[2], x1[3], part[3]);
#pragma unroll
  for (int k = 0; k < kSplit; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[k][r] = part[r][k];
  }
  tc::accumulate<Dp, kSplit>(acc, a, rows, r0, lane);
}

// Phase 1, one step of keys: fold the step's scores s and dA into the
// running max m, sum l of exp(s - m) and rd = sum dA exp(s - m) of rows
// g and g + 8 (both sums rescaled when the step raises m).
template <int NT>
__device__ __forceinline__ void fold_step(const float (&s)[NT][4],
                                          const float (&da)[NT][4],
                                          float (&m)[2], float (&l)[2],
                                          float (&rd)[2]) {
  float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
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
      const float x = expf(s[j][e] - mc[e >> 1]);
      sum[e >> 1] += x;
      dot[e >> 1] = fmaf(da[j][e], x, dot[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every step holds a key below n, so mc is finite; the first
    // step's factor is exp(-inf) = 0
    const float f = expf(m[r] - mc[r]);
    l[r] = l[r] * f + tc::quad_sum(sum[r]);
    rd[r] = rd[r] * f + tc::quad_sum(dot[r]);
    m[r] = mc[r];
  }
}

// Phase 1, second sweep: s becomes dS = P (dA - rd) scale, P = exp(s - m)
// times the rounded reciprocal of l. Keys >= n: P = 0 and dA = 0 (zero V
// rows), so dS = 0.
template <int NT>
__device__ __forceinline__ void query_dscores(float (&s)[NT][4],
                                              const float (&da)[NT][4],
                                              const float (&m)[2],
                                              const float (&inv)[2],
                                              const float (&rd)[2],
                                              float scale) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
      s[j][e] = dscore(p, da[j][e], rd[e >> 1], scale);
    }
  }
}

// Phase 2, one step of queries from q0 on: s (raw K Q^T) becomes P^T and
// da (V G^T) dS^T, from the rows' saved max, 1 / sum and rd (indexed from
// q0 as the step is); queries at or beyond ``limit`` give 0. kAll: every
// query of the step lies below limit (no compares and selects).
template <int NT, bool kAll = false>
__device__ __forceinline__ void key_pds(float (&s)[NT][4],
                                        float (&da)[NT][4], int q0,
                                        int limit, const float* row_max,
                                        const float* row_inv,
                                        const float* row_dot, float scale,
                                        int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + 8 * j + 2 * t + (e & 1);  // the query
      float p = 0.f, ds = 0.f;
      if (kAll || i < limit) {
        p = expf(__fmul_rn(s[j][e], scale) - row_max[i]) * row_inv[i];
        ds = dscore(p, da[j][e], row_dot[i], scale);
      }
      s[j][e] = p;
      da[j][e] = ds;
    }
  }
}

// Phase 1, a step of NT / 2 16-key sub-steps: fold each into the running
// max m, sum l and rd of rows g and g + 8 as fold_step folds one, in the
// same order, with the same values: the sub-steps' maxima, exps and sums
// are taken side by side (a max is exact in any order), then applied one
// after the other. Sub-steps from ``live`` on hold no key below n and are
// left out, as the 16-key loop left them.
template <int NT>
__device__ __forceinline__ void fold_steps(const float (&s)[NT][4],
                                           const float (&da)[NT][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&rd)[2], int live) {
  constexpr int K = NT / 2;
  // mc[k]: the running max after sub-step k
  float mc[K][2], sum[K][2], dot[K][2], f[K][2];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 2 * k; j < 2 * k + 2; ++j) {
      x[0] = fmaxf(x[0], fmaxf(s[j][0], s[j][1]));
      x[1] = fmaxf(x[1], fmaxf(s[j][2], s[j][3]));
    }
    mc[k][0] = tc::quad_max(x[0]);
    mc[k][1] = tc::quad_max(x[1]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float before = k == 0 ? m[r] : mc[k - 1][r];
      mc[k][r] = fmaxf(before, mc[k][r]);
      // the first sub-step's factor is exp(-inf) = 0
      f[k][r] = expf(before - mc[k][r]);
      sum[k][r] = 0.f;
      dot[k][r] = 0.f;
    }
#pragma unroll
    for (int j = 2 * k; j < 2 * k + 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - mc[k][e >> 1]);
        sum[k][e >> 1] += x;
        dot[k][e >> 1] = fmaf(da[j][e], x, dot[k][e >> 1]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[k][r] = tc::quad_sum(sum[k][r]);
      dot[k][r] = tc::quad_sum(dot[k][r]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * f[k][r] + sum[k][r];
        rd[r] = rd[r] * f[k][r] + dot[k][r];
        m[r] = mc[k][r];
      }
    }
  }
}

// acc += X . rows over a step's 16-row sub-steps from r0 on, in order, as
// accumulate_split takes one (X: the step's NT C tiles in f32); sub-steps
// from ``live`` on are left out. The step with every sub-step live takes
// no branch between them, so that their products interleave.
template <int Dp, int NT>
__device__ __forceinline__ void accumulate_steps(float (&acc)[Dp / 8][4],
                                                 const float (&x)[NT][4],
                                                 const tc::bf16* rows, int r0,
                                                 int live, int lane) {
  if (live >= NT / 2) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      accumulate_split<Dp>(acc, x[2 * p], x[2 * p + 1], rows, r0 + 16 * p,
                           lane);
    }
  } else {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      if (p < live) {
        accumulate_split<Dp>(acc, x[2 * p], x[2 * p + 1], rows, r0 + 16 * p,
                             lane);
      }
    }
  }
}

// Phase 2, a step: dk += dS^T Q and dv += round(P^T) G over its 16-query
// sub-steps from q0 on (P^T rounded to bf16, as the forward multiplied V
// by it), in order; sub-steps from ``live`` on are left out (as
// accumulate_steps).
template <int Dp, int NT>
__device__ __forceinline__ void key_accumulate_steps(
    float (&dk)[Dp / 8][4], float (&dv)[Dp / 8][4], const float (&s)[NT][4],
    const float (&da)[NT][4], const tc::bf16* qs, const tc::bf16* gs, int q0,
    int live, int lane) {
  auto one = [&](int p) {
    accumulate_split<Dp>(dk, da[2 * p], da[2 * p + 1], qs, q0 + 16 * p,
                         lane);
    // P^T rounded to bf16, as the forward multiplied V by it
    const uint32_t pa[1][4] = {{
        tc::pack(s[2 * p][0], s[2 * p][1]),
        tc::pack(s[2 * p][2], s[2 * p][3]),
        tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
        tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
    tc::accumulate<Dp, 1>(dv, pa, gs, q0 + 16 * p, lane);
  };
  if (live >= NT / 2) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) one(p);
  } else {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      if (p < live) one(p);
    }
  }
}

// The bf16 body, whole-sequence route (see the note at the top). kD > 0
// fixes the head width at compile time (the model's 32: the staging and
// the stores then fold their width checks away). Its phases are written
// out rather than through the step helpers the chunked kernels share:
// nvcc schedules this form ~5% faster at the model's shapes (timed on the
// card against the helper form, bits equal).
template <int Dp, int kD>
__global__ void __launch_bounds__(tc::kMaxWarps * 32)
attention_bwd_mma_kernel(const Operands<tc::bf16> ops, int n, int d_arg,
                         float scale) {
  const int d = kD > 0 ? kD : d_arg;
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  extern __shared__ uint4 smem_tc[];
  const int npad = tc::pad16(n);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + npad * kPad;
  bf16* vs = ks + npad * kPad;
  bf16* gs = vs + npad * kPad;
  float* row_max = reinterpret_cast<float*>(gs + npad * kPad);
  float* row_inv = row_max + npad;  // 1 / the row's sum
  float* row_dot = row_inv + npad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  tc::stage_rows<Dp>(ops.q.head(b, h, d), ops.q.row, qs, n, npad, d);
  tc::stage_rows<Dp>(ops.k.head(b, h, d), ops.k.row, ks, n, npad, d);
  tc::stage_rows<Dp>(ops.v.head(b, h, d), ops.v.row, vs, n, npad, d);
  tc::stage_rows<Dp>(ops.g.head(b, h, d), ops.g.row, gs, n, npad, d);
  tc::cp_async_wait_all();
  __syncthreads();

  float s[kBwdTiles][4], da[kBwdTiles][4];

  // ---- phase 1: query tiles -> dq, row statistics
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    uint32_t qa[Dp / 16][4], ga[Dp / 16][4];
    tc::load_a<Dp>(qa, qs, r0, lane);
    tc::load_a<Dp>(ga, gs, r0, lane);
    // rows g and g + 8 of the tile: the max m, the sum l of exp(s - m)
    // and rd = sum dA exp(s - m), both rescaled when a later chunk raises
    // m, then rd / l = sum dA P
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          rd[2] = {0.f, 0.f};
    for (int key0 = 0; key0 < npad; key0 += kStep) {
      tc::masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
      tc::products<Dp>(da, ga, vs, key0, npad, lane);
      float mc[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
        mc[0] = fmaxf(mc[0], fmaxf(s[j][0], s[j][1]));
        mc[1] = fmaxf(mc[1], fmaxf(s[j][2], s[j][3]));
      }
      mc[0] = tc::quad_max(mc[0]);
      mc[1] = tc::quad_max(mc[1]);
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[j][e] - mc[e >> 1]);
          sum[e >> 1] += x;
          dot[e >> 1] = fmaf(da[j][e], x, dot[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every chunk holds a key below n, so mc is finite; the first
        // chunk's factor is exp(-inf) = 0
        const float f = expf(m[r] - mc[r]);
        l[r] = l[r] * f + tc::quad_sum(sum[r]);
        rd[r] = rd[r] * f + tc::quad_sum(dot[r]);
        m[r] = mc[r];
      }
    }
    // P = exp(s - m) * inv: normalised by the rounded reciprocal of l
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    rd[0] *= inv[0];
    rd[1] *= inv[1];

    float dq[Dp / 8][4] = {};
    for (int key0 = 0; key0 < npad; key0 += kStep) {
      tc::masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
      tc::products<Dp>(da, ga, vs, key0, npad, lane);
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys >= n: P = 0 and dA = 0 (zero V rows), so dS = 0
          const float p = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
          s[j][e] = dscore(p, da[j][e], rd[e >> 1], scale);
        }
      }
#pragma unroll
      for (int p = 0; p < kBwdTiles / 2; ++p) {
        if (key0 + 16 * p >= npad) continue;
        accumulate_split<Dp>(dq, s[2 * p], s[2 * p + 1], ks, key0 + 16 * p,
                             lane);
      }
    }
    tc::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[r0 + g + 8 * r] = m[r];
        row_inv[r0 + g + 8 * r] = inv[r];
        row_dot[r0 + g + 8 * r] = rd[r];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key tiles -> dk, dv
  for (int c0 = 16 * warp; c0 < npad; c0 += 16 * warps) {
    uint32_t ka[Dp / 16][4], va[Dp / 16][4];
    tc::load_a<Dp>(ka, ks, c0, lane);
    tc::load_a<Dp>(va, vs, c0, lane);
    float dk[Dp / 8][4] = {}, dv[Dp / 8][4] = {};
    for (int q0 = 0; q0 < npad; q0 += kStep) {
      tc::products<Dp>(s, ka, qs, q0, npad, lane);   // S^T
      tc::products<Dp>(da, va, gs, q0, npad, lane);  // dA^T
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + 8 * j + 2 * t + (e & 1);  // the query
          float p = 0.f, ds = 0.f;
          if (i < n) {
            p = expf(__fmul_rn(s[j][e], scale) - row_max[i]) * row_inv[i];
            ds = dscore(p, da[j][e], row_dot[i], scale);
          }
          s[j][e] = p;
          da[j][e] = ds;
        }
      }
#pragma unroll
      for (int p = 0; p < kBwdTiles / 2; ++p) {
        const int k0 = q0 + 16 * p;
        if (k0 >= npad) continue;
        accumulate_split<Dp>(dk, da[2 * p], da[2 * p + 1], qs, k0, lane);
        // P^T rounded to bf16, as the forward multiplied V by it
        const uint32_t pa[1][4] = {{
            tc::pack(s[2 * p][0], s[2 * p][1]),
            tc::pack(s[2 * p][2], s[2 * p][3]),
            tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
            tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
        tc::accumulate<Dp, 1>(dv, pa, gs, k0, lane);
      }
    }
    tc::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d, lane);
    tc::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d, lane);
  }
}

// bf16 key-chunked route, phase 1, the ring body: one block per 16 * W
// query rows (W = ring_warps(Dp) consumer warps, a 16-row tile each, and
// one producer warp), K and V streamed ring_rows(Dp) rows at a time
// through the ring_stages(Dp) buffers of attention_mma.cuh's Ring, twice
// (sweep 0 takes m, l and rd; sweep 1 dq), 8 * ring_tiles() keys a warp
// step -> dq and the rows' max, 1 / sum and rd in ``stats``. The 16-key
// sub-steps keep the whole-sequence body's order: the same bits.
template <int Dp>
__global__ void __launch_bounds__(32 * (ring_warps(Dp) + 1), ring_blocks(Dp))
attention_bwd_mma_ring_q_kernel(const Operands<tc::bf16> ops,
                                float* __restrict__ stats, int n, int heads,
                                int d, float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = ring_tiles<Dp>();
  constexpr int kRows = ring_rows(Dp);
  constexpr int kStages = ring_stages(Dp);
  constexpr int kBuf = 2 * kRows * kPad;  // K then V of one chunk
  extern __shared__ uint4 smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);
  tc::Ring ring{bars, bars + kStages};
  const int warps = (blockDim.x >> 5) - 1;  // the last warp stages
  const int rows = 16 * warps;
  bf16* qs = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem_tc) +
                                     ring_header(Dp));  // rows rows each
  bf16* gs = qs + rows * kPad;
  bf16* kv = gs + rows * kPad;  // kStages buffers of kBuf

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = tc::pad16(n);
  const int q0 = blockIdx.x * rows;
  const int tiles = min(warps, (npad - q0) / 16);  // warps with a tile
  // Dp >= 128: K and V staged by bulk copies where their rows allow it
  // (attention_mma.cuh), their columns d..Dp-1 zeroed once here
  constexpr bool kBulkWidth = Dp >= 128;
  bool bulk = false;
  if constexpr (kBulkWidth) {
    bulk = tc::rows_16b(ops.k.head(b, h, d), ops.k.row, d) &&
           tc::rows_16b(ops.v.head(b, h, d), ops.v.row, d);
    tc::ring_init(ring, kStages, tiles,
                  bulk ? tc::kRingBulkCount : tc::kRingFullCount);
    if (bulk && d < Dp) {
      tc::ring_zero_columns<Dp>(kv, kStages * 2 * kRows, d, threadIdx.x,
                                blockDim.x);
    }
  } else {
    tc::ring_init(ring, kStages, tiles);
  }
  const int cnt = min(rows, n - q0);
  tc::stage_rows<Dp>(ops.q.head(b, h, d) + q0 * ops.q.row, ops.q.row, qs,
                     cnt, rows, d);
  tc::stage_rows<Dp>(ops.g.head(b, h, d) + q0 * ops.g.row, ops.g.row, gs,
                     cnt, rows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kRows - 1) / kRows;
  if (warp == warps) {  // K and V chunk by chunk, once a sweep
    const bf16* kh = ops.k.head(b, h, d);
    const bf16* vh = ops.v.head(b, h, d);
    for (int i = 0; i < 2 * chunks; ++i) {
      const int k0 = (i < chunks ? i : i - chunks) * kRows;
      const int kc = min(kRows, n - k0);
      if constexpr (kBulkWidth) {
        if (bulk) {
          tc::ring_produce_bulk(
              ring, kStages, 4u * kc * d, lane, [&](int st, uint64_t* bar) {
                bf16* kb = kv + st * kBuf;
                tc::bulk_rows<Dp>(kh + k0 * ops.k.row, ops.k.row, kb, kc,
                                  kRows, d, bar, lane);
                tc::bulk_rows<Dp>(vh + k0 * ops.v.row, ops.v.row,
                                  kb + kRows * kPad, kc, kRows, d, bar, lane);
              });
          continue;
        }
      }
      tc::ring_produce(ring, kStages, [&](int st) {
        bf16* kb = kv + st * kBuf;
        tc::stage_rows_by<Dp>(kh + k0 * ops.k.row, ops.k.row, kb, kc, kRows,
                              d, lane, 32u);
        tc::stage_rows_by<Dp>(vh + k0 * ops.v.row, ops.v.row,
                              kb + kRows * kPad, kc, kRows, d, lane, 32u);
      });
    }
    tc::cp_async_wait_all();
    return;
  }
  if (warp >= tiles) return;

  const int r0 = q0 + 16 * warp;  // this warp's query tile
  // Q's and G's A fragments in registers at Dp <= 64, else read from the
  // staged rows at each step in the same mma order (products_smem): beside
  // dq's Dp / 2 accumulators they would not fit the registers
  constexpr bool kASmem = Dp >= 128;
  uint32_t qa[kASmem ? 1 : Dp / 16][4], ga[kASmem ? 1 : Dp / 16][4];
  if constexpr (!kASmem) {
    tc::load_a<Dp>(qa, qs, 16 * warp, lane);
    tc::load_a<Dp>(ga, gs, 16 * warp, lane);
  }
  float s[NT][4], da[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float dq[Dp / 8][4] = {};
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int c = 0; c < chunks; ++c) {
      tc::ring_acquire(ring);
      const bf16* kb = kv + ring.stage * kBuf;
      const bf16* vb = kb + kRows * kPad;
      const int left = n - c * kRows;  // keys from the chunk's first
      for (int key0 = 0; key0 < kRows && key0 < left; key0 += 8 * NT) {
        // the step's 16-key sub-steps that hold a key below n
        const int live = min(NT / 2, (left - key0 + 15) / 16);
        if constexpr (kASmem) {
          tc::step_scores_smem<Dp>(s, qs, 16 * warp, kb, key0, left, kRows,
                                   scale, lane);
          tc::products_smem<Dp>(da, gs, 16 * warp, vb, key0, kRows, lane);
        } else {
          tc::step_scores<Dp>(s, qa, kb, key0, left, kRows, scale, lane);
          tc::products<Dp>(da, ga, vb, key0, kRows, lane);
        }
        if (sweep == 0) {
          fold_steps(s, da, m, l, rd, live);
        } else {
          query_dscores(s, da, m, inv, rd, scale);
          accumulate_steps<Dp>(dq, s, kb, key0, live, lane);
        }
      }
      tc::ring_release(ring, kStages, lane);
    }
    if (sweep == 0) {
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
      rd[0] *= inv[0];
      rd[1] *= inv[1];
    }
  }
  tc::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
  if (t == 0) {
    float* st = stats_of(stats, b, h, heads, npad);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st[r0 + g + 8 * r] = m[r];
      st[npad + r0 + g + 8 * r] = inv[r];
      st[2 * npad + r0 + g + 8 * r] = rd[r];
    }
  }
}

// Phase 2, a step of the dv warp of a key tile with two warps: dv +=
// round(P^T) G over its 16-query sub-steps from q0 on, in order, as
// key_accumulate_steps sums dv; sub-steps from ``live`` on are left out.
template <int Dp, int NT>
__device__ __forceinline__ void key_dv_steps(float (&dv)[Dp / 8][4],
                                             const float (&s)[NT][4],
                                             const tc::bf16* gs, int q0,
                                             int live, int lane) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    if (p < live) {
      // P^T rounded to bf16, as the forward multiplied V by it
      const uint32_t pa[1][4] = {{
          tc::pack(s[2 * p][0], s[2 * p][1]),
          tc::pack(s[2 * p][2], s[2 * p][3]),
          tc::pack(s[2 * p + 1][0], s[2 * p + 1][1]),
          tc::pack(s[2 * p + 1][2], s[2 * p + 1][3])}};
      tc::accumulate<Dp, 1>(dv, pa, gs, q0 + 16 * p, lane);
    }
  }
}

// bf16 key-chunked route, phase 2, the ring body: one block per 16 * W
// key rows (W = ring_key_tiles(Dp) tiles, ring_roles(Dp) consumer warps
// each, and one producer warp), Q, G and the rows' statistics streamed
// ring_rows(Dp) rows at a time through the ring, 8 * ring_tiles() queries
// a warp step -> dk, dv, in the whole-sequence body's 16-query order.
// With two roles the first warp of a tile sums dk (S^T and dA^T), the
// second dv (S^T only).
template <int Dp>
__global__ void __launch_bounds__(
    32 * (ring_roles(Dp) * ring_key_tiles(Dp) + 1), ring_key_blocks(Dp))
attention_bwd_mma_ring_k_kernel(const Operands<tc::bf16> ops,
                                const float* __restrict__ stats, int n,
                                int heads, int d, float scale) {
  using tc::bf16;
  constexpr int kPad = tc::row_pad(Dp);
  constexpr int NT = ring_tiles<Dp>();
  constexpr int kRows = ring_rows(Dp);
  constexpr int kStages = ring_stages(Dp);
  constexpr int kRoles = ring_roles(Dp);
  // Q then G of one chunk, then its 3 x kRows statistics (f32)
  constexpr int kBuf = 2 * kRows * kPad + 6 * kRows;
  extern __shared__ uint4 smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);
  tc::Ring ring{bars, bars + kStages};
  // key tiles a block; the last warp stages
  const int warps = ((blockDim.x >> 5) - 1) / kRoles;
  const int rows = 16 * warps;
  bf16* ks = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem_tc) +
                                     ring_header(Dp));  // rows rows each
  bf16* vs = ks + rows * kPad;
  bf16* qg = vs + rows * kPad;  // kStages buffers of kBuf

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npad = tc::pad16(n);
  const int k0 = blockIdx.x * rows;
  const int tiles = min(warps, (npad - k0) / 16);  // key tiles with rows
  // Dp >= 128: Q, G and the statistics staged by bulk copies where their
  // rows allow it (attention_mma.cuh), Q's and G's columns d..Dp-1 zeroed
  // once here
  constexpr bool kBulkWidth = Dp >= 128;
  bool bulk = false;
  if constexpr (kBulkWidth) {
    bulk = tc::rows_16b(ops.q.head(b, h, d), ops.q.row, d) &&
           tc::rows_16b(ops.g.head(b, h, d), ops.g.row, d) &&
           reinterpret_cast<uintptr_t>(stats) % 16 == 0;
    tc::ring_init(ring, kStages, kRoles * tiles,
                  bulk ? tc::kRingBulkCount : tc::kRingFullCount);
    if (bulk && d < Dp) {
      for (int st = 0; st < kStages; ++st) {
        tc::ring_zero_columns<Dp>(qg + st * kBuf, 2 * kRows, d, threadIdx.x,
                                  blockDim.x);
      }
    }
  } else {
    tc::ring_init(ring, kStages, kRoles * tiles);
  }
  const int cnt = min(rows, n - k0);
  tc::stage_rows<Dp>(ops.k.head(b, h, d) + k0 * ops.k.row, ops.k.row, ks,
                     cnt, rows, d);
  tc::stage_rows<Dp>(ops.v.head(b, h, d) + k0 * ops.v.row, ops.v.row, vs,
                     cnt, rows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kRows - 1) / kRows;
  if (warp == kRoles * warps) {  // Q, G and the statistics chunk by chunk
    const bf16* qh = ops.q.head(b, h, d);
    const bf16* gh = ops.g.head(b, h, d);
    const float* sh = stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
    for (int c = 0; c < chunks; ++c) {
      const int q0 = c * kRows;
      const int qc = min(kRows, n - q0);
      if constexpr (kBulkWidth) {
        if (bulk) {
          // the rows' statistics below npad: three copies of sr floats
          const int sr = min(kRows, npad - q0);
          tc::ring_produce_bulk(
              ring, kStages, 4u * qc * d + 12u * sr, lane,
              [&](int st, uint64_t* bar) {
                bf16* qb = qg + st * kBuf;
                tc::bulk_rows<Dp>(qh + q0 * ops.q.row, ops.q.row, qb, qc,
                                  kRows, d, bar, lane);
                tc::bulk_rows<Dp>(gh + q0 * ops.g.row, ops.g.row,
                                  qb + kRows * kPad, qc, kRows, d, bar, lane);
                if (lane < 3) {
                  tc::bulk_row(reinterpret_cast<float*>(qb + 2 * kRows * kPad) +
                                   lane * kRows,
                               sh + lane * npad + q0, 4u * sr, bar);
                }
              });
          continue;
        }
      }
      tc::ring_produce(ring, kStages, [&](int st) {
        bf16* qb = qg + st * kBuf;
        tc::stage_rows_by<Dp>(qh + q0 * ops.q.row, ops.q.row, qb, qc, kRows,
                              d, lane, 32u);
        tc::stage_rows_by<Dp>(gh + q0 * ops.g.row, ops.g.row,
                              qb + kRows * kPad, qc, kRows, d, lane, 32u);
        // the rows' max, 1 / sum and rd below npad (the pad rows past n
        // are never read: key_pds gives their queries 0)
        float* sb = reinterpret_cast<float*>(qb + 2 * kRows * kPad);
        const int sr = min(kRows, npad - q0);
        if (reinterpret_cast<uintptr_t>(sh) % 16 == 0) {
          for (int idx = lane; idx < 3 * (sr / 4); idx += 32) {
            const int w = idx / (sr / 4), i = 4 * (idx - w * (sr / 4));
            tc::cp_async16(sb + w * kRows + i, sh + w * npad + q0 + i);
          }
        } else {
          for (int idx = lane; idx < 3 * sr; idx += 32) {
            const int w = idx / sr, i = idx - w * sr;
            sb[w * kRows + i] = sh[w * npad + q0 + i];
          }
        }
      });
    }
    tc::cp_async_wait_all();
    return;
  }
  // the warp's key tile, and with two roles whether it sums dk (0) or dv
  const int tile = kRoles == 1 ? warp : warp % warps;
  const int role = kRoles == 1 ? 0 : warp / warps;
  if (tile >= tiles) return;

  const int c0 = k0 + 16 * tile;  // this warp's key tile
  // K's and V's A fragments in registers at Dp = 16, else read from the
  // staged rows at each step in the same mma order (products_smem), which
  // keeps the registers within the 128 a thread that two blocks an SM
  // leave
  constexpr bool kASmem = Dp >= 32;
  uint32_t ka[kASmem ? 1 : Dp / 16][4], va[kASmem ? 1 : Dp / 16][4];
  if constexpr (!kASmem) {
    tc::load_a<Dp>(ka, ks, 16 * tile, lane);
    tc::load_a<Dp>(va, vs, 16 * tile, lane);
  }
  float s[NT][4], da[NT][4];
  // with two roles dk holds the warp's one gradient, dk or dv
  float dk[Dp / 8][4] = {}, dv[kRoles == 1 ? Dp / 8 : 1][4] = {};
  for (int c = 0; c < chunks; ++c) {
    tc::ring_acquire(ring);
    const bf16* qb = qg + ring.stage * kBuf;
    const bf16* gb = qb + kRows * kPad;
    const float* st = reinterpret_cast<const float*>(gb + kRows * kPad);
    const int left = n - c * kRows;  // queries from the chunk's first
    for (int q0 = 0; q0 < kRows && q0 < left; q0 += 8 * NT) {
      // the step's 16-query sub-steps that hold a query below n
      const int live = min(NT / 2, (left - q0 + 15) / 16);
      if constexpr (kASmem) {  // S^T, dA^T (the dv warp: S^T only)
        tc::products_smem<Dp>(s, ks, 16 * tile, qb, q0, kRows, lane);
        if (role == 0) {
          tc::products_smem<Dp>(da, vs, 16 * tile, gb, q0, kRows, lane);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
          }
        }
      } else {
        tc::products<Dp>(s, ka, qb, q0, kRows, lane);
        tc::products<Dp>(da, va, gb, q0, kRows, lane);
      }
      if (q0 + 8 * NT <= left) {
        key_pds<NT, true>(s, da, q0, left, st, st + kRows, st + 2 * kRows,
                          scale, lane);
      } else {
        key_pds(s, da, q0, left, st, st + kRows, st + 2 * kRows, scale,
                lane);
      }
      if constexpr (kRoles == 1) {
        key_accumulate_steps<Dp>(dk, dv, s, da, qb, gb, q0, live, lane);
      } else if (role == 0) {
        accumulate_steps<Dp>(dk, da, qb, q0, live, lane);
      } else {
        key_dv_steps<Dp>(dk, s, gb, q0, live, lane);
      }
    }
    tc::ring_release(ring, kStages, lane);
  }
  if constexpr (kRoles == 1) {
    tc::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d, lane);
    tc::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d, lane);
  } else {
    const Operand<bf16>& o = role == 0 ? ops.dk : ops.dv;
    tc::store_rows<Dp>(dk, o.head(b, h, d), o.row, c0, n, d, lane);
  }
}

// The f32 body, whole-sequence route: the bf16 body's two phases and
// steps with every product on the tensor cores by the three-way TF32 split
// (attention_tf32.cuh), the A tiles read from shared memory, dS and P in
// f32 (dv = P^T G with P unrounded: the forward multiplies V by the f32
// P). S^T = K Q^T and dA^T = V G^T take the cross terms in the order of
// S = Q K^T and dA = G V^T (kAisX false), so that both phases see the same
// P and dS.
template <int Dp>
__global__ void __launch_bounds__(tc::kMaxWarps * 32)
attention_bwd_tf32_kernel(const Operands<float> ops, int n, int d,
                          float scale) {
  constexpr int kPad = tf::row_pad(Dp);
  extern __shared__ uint4 smem_tc[];
  const int npad = tf::pad16(n);
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* ks = qs + npad * kPad;
  float* vs = ks + npad * kPad;
  float* gs = vs + npad * kPad;
  float* row_max = gs + npad * kPad;
  float* row_inv = row_max + npad;  // 1 / the row's sum
  float* row_dot = row_inv + npad;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  tf::stage_rows<Dp>(ops.q.head(b, h, d), ops.q.row, qs, n, npad, d);
  tf::stage_rows<Dp>(ops.k.head(b, h, d), ops.k.row, ks, n, npad, d);
  tf::stage_rows<Dp>(ops.v.head(b, h, d), ops.v.row, vs, n, npad, d);
  tf::stage_rows<Dp>(ops.g.head(b, h, d), ops.g.row, gs, n, npad, d);
  tc::cp_async_wait_all();
  __syncthreads();

  float s[kF32Tiles][4], da[kF32Tiles][4];

  // ---- phase 1: query tiles -> dq, row statistics
  for (int r0 = 16 * warp; r0 < npad; r0 += 16 * warps) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          rd[2] = {0.f, 0.f};
    for (int key0 = 0; key0 < npad; key0 += kF32Step) {
      tf::masked_scores<Dp>(s, qs, r0, ks, key0, n, npad, scale, lane);
      tf::products<Dp, kF32Tiles, true>(da, gs, r0, vs, key0, npad, lane);
      fold_step(s, da, m, l, rd);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    rd[0] *= inv[0];
    rd[1] *= inv[1];

    float dq[Dp / 8][4] = {};
    for (int key0 = 0; key0 < npad; key0 += kF32Step) {
      tf::masked_scores<Dp>(s, qs, r0, ks, key0, n, npad, scale, lane);
      tf::products<Dp, kF32Tiles, true>(da, gs, r0, vs, key0, npad, lane);
      query_dscores(s, da, m, inv, rd, scale);
      tf::accumulate_tiles<Dp>(dq, s, ks, key0, npad, lane);
    }
    tf::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[r0 + g + 8 * r] = m[r];
        row_inv[r0 + g + 8 * r] = inv[r];
        row_dot[r0 + g + 8 * r] = rd[r];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key tiles -> dk, dv
  for (int c0 = 16 * warp; c0 < npad; c0 += 16 * warps) {
    float dk[Dp / 8][4] = {}, dv[Dp / 8][4] = {};
    for (int q0 = 0; q0 < npad; q0 += kF32Step) {
      tf::products<Dp, kF32Tiles, false>(s, ks, c0, qs, q0, npad, lane);
      tf::products<Dp, kF32Tiles, false>(da, vs, c0, gs, q0, npad, lane);
      key_pds(s, da, q0, n, row_max, row_inv, row_dot, scale, lane);
      tf::accumulate_tiles<Dp>(dk, da, qs, q0, npad, lane);
      tf::accumulate_tiles<Dp>(dv, s, gs, q0, npad, lane);
    }
    tf::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d, lane);
    tf::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d, lane);
  }
}

// f32 key-chunked route, phase 1: one block per 16 * f32_long_warps(Dp)
// query rows, K and V f32_long_rows(Dp) rows at a time (double-buffered
// cp.async groups) -> dq and the rows' max, 1 / sum and rd in ``stats``;
// the whole-sequence f32 body's 16-key steps in its order (the same bits).
template <int Dp>
__global__ void __launch_bounds__(f32_long_warps(Dp) * 32)
attention_bwd_tf32_q_kernel(const Operands<float> ops,
                            float* __restrict__ stats, int n, int heads,
                            int d, float scale) {
  constexpr int kPad = tf::row_pad(Dp);
  constexpr int kRows = 16 * f32_long_warps(Dp);
  constexpr int kChunk = f32_long_rows(Dp);
  extern __shared__ uint4 smem_tc[];
  float* qs = reinterpret_cast<float*>(smem_tc);  // kRows rows each
  float* gs = qs + kRows * kPad;
  float* kv = gs + kRows * kPad;  // 2 buffers of K then V, kChunk rows

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = tf::pad16(n);
  const int q0 = blockIdx.x * kRows;
  const int r0 = q0 + 16 * warp;  // this warp's query tile
  const bool active = r0 < npad;
  const float* kh = ops.k.head(b, h, d);
  const float* vh = ops.v.head(b, h, d);
  const int rows = min(kRows, n - q0);

  tf::stage_rows<Dp>(ops.q.head(b, h, d) + q0 * ops.q.row, ops.q.row, qs,
                     rows, kRows, d);
  tf::stage_rows<Dp>(ops.g.head(b, h, d) + q0 * ops.g.row, ops.g.row, gs,
                     rows, kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kChunk - 1) / kChunk;
  auto stage = [&](int c) {
    float* kb = kv + (c & 1) * 2 * kChunk * kPad;
    const int k0 = c * kChunk;
    const int cnt = min(kChunk, n - k0);
    tf::stage_rows<Dp>(kh + k0 * ops.k.row, ops.k.row, kb, cnt, kChunk, d);
    tf::stage_rows<Dp>(vh + k0 * ops.v.row, ops.v.row, kb + kChunk * kPad,
                       cnt, kChunk, d);
    tc::cp_async_commit();
  };

  float s[kF32Tiles][4], da[kF32Tiles][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float dq[Dp / 8][4] = {};
  for (int sweep = 0; sweep < 2; ++sweep) {
    stage(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage(c + 1);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float* kb = kv + (c & 1) * 2 * kChunk * kPad;
        const float* vb = kb + kChunk * kPad;
        const int left = n - c * kChunk;  // keys from the chunk's first
        for (int key0 = 0; key0 < kChunk && key0 < left; key0 += kF32Step) {
          tf::masked_scores<Dp>(s, qs, 16 * warp, kb, key0, left, kChunk,
                                scale, lane);
          tf::products<Dp, kF32Tiles, true>(da, gs, 16 * warp, vb, key0,
                                            kChunk, lane);
          if (sweep == 0) {
            fold_step(s, da, m, l, rd);
          } else {
            query_dscores(s, da, m, inv, rd, scale);
            tf::accumulate_tiles<Dp>(dq, s, kb, key0, kChunk, lane);
          }
        }
      }
      __syncthreads();  // buffer c % 2 is free for chunk c + 2
    }
    if (sweep == 0) {
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
      rd[0] *= inv[0];
      rd[1] *= inv[1];
    }
  }
  if (active) {
    tf::store_rows<Dp>(dq, ops.dq.head(b, h, d), ops.dq.row, r0, n, d, lane);
    if (t == 0) {
      float* st = stats_of(stats, b, h, heads, npad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        st[r0 + g + 8 * r] = m[r];
        st[npad + r0 + g + 8 * r] = inv[r];
        st[2 * npad + r0 + g + 8 * r] = rd[r];
      }
    }
  }
}

// f32 key-chunked route, phase 2: one block per 16 * f32_long_warps(Dp)
// key rows (two warps a key tile at Dp = 256, dk and dv), Q, G and the
// rows' statistics f32_long_rows(Dp) rows at a time -> dk, dv.
template <int Dp>
__global__ void __launch_bounds__(f32_long_warps(Dp) * 32 * key_roles(Dp))
attention_bwd_tf32_k_kernel(const Operands<float> ops,
                            const float* __restrict__ stats, int n,
                            int heads, int d, float scale) {
  constexpr int kPad = tf::row_pad(Dp);
  constexpr int kWarpsK = f32_long_warps(Dp);
  constexpr int kRows = 16 * kWarpsK;
  constexpr int kChunk = f32_long_rows(Dp);
  constexpr int kBuf = 2 * kChunk * kPad;  // Q then G of one chunk
  constexpr int kRoles = key_roles(Dp);
  extern __shared__ uint4 smem_tc[];
  float* ks = reinterpret_cast<float*>(smem_tc);  // kRows rows each
  float* vs = ks + kRows * kPad;
  float* qg = vs + kRows * kPad;                  // 2 buffers of kBuf
  float* sts = qg + 2 * kBuf;                     // 2 x 3 kChunk

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  // the warp's key tile, and with two roles whether it sums dk (0) or dv
  const int warp = kRoles == 1 ? threadIdx.x >> 5
                               : (threadIdx.x >> 5) % kWarpsK;
  const int role = kRoles == 1 ? 0 : (threadIdx.x >> 5) / kWarpsK;
  const int npad = tf::pad16(n);
  const int k0 = blockIdx.x * kRows;
  const int c0 = k0 + 16 * warp;  // this warp's key tile
  const bool active = c0 < npad;
  const float* qh = ops.q.head(b, h, d);
  const float* gh = ops.g.head(b, h, d);
  const float* sh = stats + (static_cast<int64_t>(b) * heads + h) * 3 * npad;
  const int rows = min(kRows, n - k0);

  tf::stage_rows<Dp>(ops.k.head(b, h, d) + k0 * ops.k.row, ops.k.row, ks,
                     rows, kRows, d);
  tf::stage_rows<Dp>(ops.v.head(b, h, d) + k0 * ops.v.row, ops.v.row, vs,
                     rows, kRows, d);
  tc::cp_async_wait_all();
  __syncthreads();

  const int chunks = (n + kChunk - 1) / kChunk;
  auto stage = [&](int c) {
    float* qb = qg + (c & 1) * kBuf;
    float* st = sts + (c & 1) * 3 * kChunk;
    const int q0 = c * kChunk;
    const int cnt = min(kChunk, n - q0);
    tf::stage_rows<Dp>(qh + q0 * ops.q.row, ops.q.row, qb, cnt, kChunk, d);
    tf::stage_rows<Dp>(gh + q0 * ops.g.row, ops.g.row, qb + kChunk * kPad,
                       cnt, kChunk, d);
    tc::cp_async_commit();
    for (int idx = threadIdx.x; idx < 3 * kChunk; idx += blockDim.x) {
      const int w = idx / kChunk, i = idx - w * kChunk;
      st[idx] = q0 + i < npad ? sh[w * npad + q0 + i] : 0.f;
    }
  };

  float s[kF32Tiles][4], da[kF32Tiles][4];
  // with two roles dk holds the warp's one gradient, dk or dv
  float dk[Dp / 8][4] = {}, dv[kRoles == 1 ? Dp / 8 : 1][4] = {};
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* qb = qg + (c & 1) * kBuf;
      const float* gb = qb + kChunk * kPad;
      const float* st = sts + (c & 1) * 3 * kChunk;
      const int left = n - c * kChunk;  // queries from the chunk's first
      for (int q0 = 0; q0 < kChunk && q0 < left; q0 += kF32Step) {
        tf::products<Dp, kF32Tiles, false>(s, ks, 16 * warp, qb, q0, kChunk,
                                           lane);  // S^T
        if (role == 0) {
          tf::products<Dp, kF32Tiles, false>(da, vs, 16 * warp, gb, q0,
                                             kChunk, lane);  // dA^T
        } else {
#pragma unroll
          for (int j = 0; j < kF32Tiles; ++j) {
            da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
          }
        }
        key_pds(s, da, q0, left, st, st + kChunk, st + 2 * kChunk, scale,
                lane);
        if constexpr (kRoles == 1) {
          tf::accumulate_tiles<Dp>(dk, da, qb, q0, kChunk, lane);
          tf::accumulate_tiles<Dp>(dv, s, gb, q0, kChunk, lane);
        } else if (role == 0) {
          tf::accumulate_tiles<Dp>(dk, da, qb, q0, kChunk, lane);
        } else {
          tf::accumulate_tiles<Dp>(dk, s, gb, q0, kChunk, lane);
        }
      }
    }
    __syncthreads();  // buffer c % 2 is free for chunk c + 2
  }
  if (active) {
    if constexpr (kRoles == 1) {
      tf::store_rows<Dp>(dk, ops.dk.head(b, h, d), ops.dk.row, c0, n, d,
                         lane);
      tf::store_rows<Dp>(dv, ops.dv.head(b, h, d), ops.dv.row, c0, n, d,
                         lane);
    } else {
      const Operand<float>& o = role == 0 ? ops.dk : ops.dv;
      tf::store_rows<Dp>(dk, o.head(b, h, d), o.row, c0, n, d, lane);
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16
size_t smem_whole(int n, int dtype, int dp) {
  const size_t npad = tc::pad16(n);
  const size_t row = dtype == 1 ? tc::row_pad(dp) * sizeof(tc::bf16)
                                : tf::row_pad(dp) * sizeof(float);
  return npad * (4 * row + 3 * sizeof(float));
}

size_t smem_long(int dtype, int dp) {
  // the ring bodies: 2 tiles of 16 W rows (W the larger of the two
  // kernels' tiles a block) and S buffers of 2 R rows, plus the key
  // kernel's 3 R statistics a buffer
  if (dtype == 1) {
    const int w = ring_warps(dp) > ring_key_tiles(dp) ? ring_warps(dp)
                                                      : ring_key_tiles(dp);
    return ring_header(dp) +
           (2 * 16 * w + ring_stages(dp) * 2 * ring_rows(dp)) *
               tc::row_pad(dp) * sizeof(tc::bf16) +
           ring_stages(dp) * 3 * ring_rows(dp) * sizeof(float);
  }
  // 2 tiles of 16 W rows and 2 buffers of 2 R rows, plus the k kernel's
  // 2 x 3 R statistics (W warps a block, R rows a chunk)
  return ((2 * 16 * f32_long_warps(dp) + 4 * f32_long_rows(dp)) *
              tf::row_pad(dp) +
          6 * f32_long_rows(dp)) *
         sizeof(float);
}

// whether the whole-sequence body exists at dp and fits one block at n
bool whole_fits(int n, int dtype, int dp) {
  return !tc::a_in_smem(dp) && smem_whole(n, dtype, dp) <= tc::kSmemLimit;
}

// 0: the whole-sequence route, 1: the key-chunked route. The whole body
// runs while an SM holds at least kWholeBlocks of its blocks (see the
// note at the top for the measured crossover).
int route(int n, int dtype, int dp) {
  if (!whole_fits(n, dtype, dp)) return 1;
  const int least = dtype == 1 && dp == 32 ? kWholeBlocksRing : kWholeBlocks;
  return tc::blocks_per_sm(smem_whole(n, dtype, dp)) >= least ? 0 : 1;
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
Operands<T> operands(const void* const* ptrs, const int64_t* strides) {
  auto in = [&](int i) {
    return Operand<const T>{static_cast<const T*>(ptrs[i]), strides[2 * i],
                            strides[2 * i + 1]};
  };
  auto out = [&](int i) {
    return Operand<T>{static_cast<T*>(const_cast<void*>(ptrs[i])),
                      strides[2 * i], strides[2 * i + 1]};
  };
  return {in(0), in(1), in(2), in(3), out(4), out(5), out(6)};
}

// Launch the whole-sequence body (r = 0; the caller checked that it
// fits), or the key-chunked pair (Q then K) with the statistics in
// ``stats``.
template <typename T, int Dp>
cudaError_t launch(const Operands<T>& ops, float* stats, int batch, int n,
                   int heads, int d, float scale, int r,
                   cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, tc::bf16>::value;
  constexpr int dtype = kMma ? 1 : 0;
  const size_t smem = smem_of(r, n, dtype, Dp);
  const void *qk, *kk;
  if constexpr (kMma) {
    qk = reinterpret_cast<const void*>(attention_bwd_mma_ring_q_kernel<Dp>);
    kk = reinterpret_cast<const void*>(attention_bwd_mma_ring_k_kernel<Dp>);
  } else {
    qk = reinterpret_cast<const void*>(attention_bwd_tf32_q_kernel<Dp>);
    kk = reinterpret_cast<const void*>(attention_bwd_tf32_k_kernel<Dp>);
  }
  cudaError_t err;
  if constexpr (!tc::a_in_smem(Dp)) {
    if (r == 0) {
      const void* whole;
      if constexpr (kMma) {
        whole = d == Dp ? reinterpret_cast<const void*>(
                              attention_bwd_mma_kernel<Dp, Dp>)
                        : reinterpret_cast<const void*>(
                              attention_bwd_mma_kernel<Dp, 0>);
      } else {
        whole = reinterpret_cast<const void*>(attention_bwd_tf32_kernel<Dp>);
      }
      if ((err = allow_smem(whole, smem)) != cudaSuccess) return err;
      const dim3 grid(heads, batch);
      const int threads = 32 * tc::warps_for(tc::pad16(n) / 16,
                                             kMma ? kBwdWarps : kF32Warps);
      if constexpr (kMma) {
        if (d == Dp) {
          attention_bwd_mma_kernel<Dp, Dp><<<grid, threads, smem, stream>>>(
              ops, n, d, scale);
        } else {
          attention_bwd_mma_kernel<Dp, 0><<<grid, threads, smem, stream>>>(
              ops, n, d, scale);
        }
      } else {
        attention_bwd_tf32_kernel<Dp><<<grid, threads, smem, stream>>>(
            ops, n, d, scale);
      }
      return cudaGetLastError();
    }
  }
  if ((err = allow_smem(qk, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(kk, smem)) != cudaSuccess) return err;
  if constexpr (kMma) {
    const int tiles = tc::pad16(n) / 16;
    const int qw = tiles < ring_warps(Dp) ? tiles : ring_warps(Dp);
    const int kw = tiles < ring_key_tiles(Dp) ? tiles : ring_key_tiles(Dp);
    attention_bwd_mma_ring_q_kernel<Dp>
        <<<dim3((tiles + qw - 1) / qw, heads, batch), 32 * (qw + 1), smem,
           stream>>>(ops, stats, n, heads, d, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attention_bwd_mma_ring_k_kernel<Dp>
        <<<dim3((tiles + kw - 1) / kw, heads, batch),
           32 * (ring_roles(Dp) * kw + 1), smem, stream>>>(ops, stats, n,
                                                           heads, d, scale);
  } else {
    constexpr int kW = f32_long_warps(Dp);
    const dim3 grid((tc::pad16(n) + 16 * kW - 1) / (16 * kW), heads, batch);
    attention_bwd_tf32_q_kernel<Dp><<<grid, 32 * kW, smem, stream>>>(
        ops, stats, n, heads, d, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attention_bwd_tf32_k_kernel<Dp>
        <<<grid, 32 * kW * key_roles(Dp), smem, stream>>>(ops, stats, n,
                                                          heads, d, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* const* ptrs, const int64_t* strides,
                         float* stats, int batch, int n, int heads, int d,
                         float scale, int r, cudaStream_t stream) {
  const Operands<T> ops = operands<T>(ptrs, strides);
  switch (tc::padded_width(d)) {
    case 16:
      return launch<T, 16>(ops, stats, batch, n, heads, d, scale, r, stream);
    case 32:
      return launch<T, 32>(ops, stats, batch, n, heads, d, scale, r, stream);
    case 64:
      return launch<T, 64>(ops, stats, batch, n, heads, d, scale, r, stream);
    case 128:
      return launch<T, 128>(ops, stats, batch, n, heads, d, scale, r,
                            stream);
    default:
      return launch<T, 256>(ops, stats, batch, n, heads, d, scale, r,
                            stream);
  }
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim < 1 || batch < 1 || batch > 65535 ||
         n < 1 || heads < 1 || heads > 65535;
}

// forced: -1 takes the route of route() (the entry points), 0 or 1 that
// route (the internal launch of attention_qkv_bwd_on_route)
int dispatch(const void* const* ptrs, const int64_t* strides, void* scratch,
             int batch, int n, int heads, int d, float scale, int dtype,
             int forced, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(scratch);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return invalid;
  if (d >= attn_wide::kNarrowest) {
    if (forced >= 0 || stats == nullptr) return invalid;
    return static_cast<int>(
        dtype == 0 ? attn_wide::launch_bwd<float>(ptrs, strides, stats,
                                                  batch, n, heads, d, scale,
                                                  s)
                   : attn_wide::launch_bwd<tc::bf16>(ptrs, strides, stats,
                                                     batch, n, heads, d,
                                                     scale, s));
  }
  const int dp = tc::padded_width(d);
  const int r = forced < 0 ? route(n, dtype, dp) : forced;
  if (r > 1 || (r == 0 && !whole_fits(n, dtype, dp)) ||
      (r == 1 && stats == nullptr)) {
    return invalid;
  }
  return static_cast<int>(
      dtype == 0 ? launch_width<float>(ptrs, strides, stats, batch, n, heads,
                                       d, scale, r, s)
                 : launch_width<tc::bf16>(ptrs, strides, stats, batch, n,
                                          heads, d, scale, r, s));
}

}  // namespace

extern "C" {

// The route the body for ``dtype`` (0 = float32, 1 = bfloat16) takes at
// sequence length n and head width head_dim: 0 = one block per (head,
// image) with the whole sequence in shared memory, 1 = key-chunked (two
// kernels and a statistics scratch), 2 = the bodies of head widths above
// 256 (attention_wide.cuh: two kernels and the same scratch).
int attention_qkv_bwd_route(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return 2;
  return route(n, dtype, tc::padded_width(head_dim));
}

// Shared memory one block of that route needs, in bytes (static on
// route 2, dynamic on the others).
int attention_qkv_bwd_smem_bytes(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) {
    return attn_wide::bwd_smem_bytes(dtype);
  }
  return static_cast<int>(smem_bytes(n, dtype, tc::padded_width(head_dim)));
}

// The kernels that run at that (n, dtype, head_dim), by their names in
// this source (tools and tests read which body a shape takes): one name
// on the whole-sequence route, the pair as "..._{q,k}_kernel" on the
// others.
const char* attention_qkv_bwd_body(int n, int dtype, int head_dim) {
  if (head_dim >= attn_wide::kNarrowest) return "wide_bwd_{q,k}_kernel";
  if (route(n, dtype, tc::padded_width(head_dim)) == 0) {
    return dtype == 1 ? "attention_bwd_mma_kernel"
                      : "attention_bwd_tf32_kernel";
  }
  return dtype == 1 ? "attention_bwd_mma_ring_{q,k}_kernel"
                    : "attention_bwd_tf32_{q,k}_kernel";
}

// f32 elements of the statistics scratch the launch needs (0 on the
// whole-sequence route): B * H * 3 * pad16(n).
long long attention_qkv_bwd_scratch_floats(int batch, int n, int heads,
                                           int head_dim, int dtype) {
  if (head_dim < attn_wide::kNarrowest &&
      route(n, dtype, tc::padded_width(head_dim)) == 0) {
    return 0;
  }
  return static_cast<long long>(batch) * heads * 3 * tc::pad16(n);
}

// qkv (B, N, 3*H*D) and g (B, N, H*D), contiguous -> the packed gradient
// dqkv (B, N, 3*H*D). dtype: 0 = float32, 1 = bfloat16. scratch: the f32
// statistics scratch (attention_qkv_bwd_scratch_floats; may be null when
// that is 0). Returns cudaGetLastError() after the launches (0 on
// success); the caller has checked shapes and pointers.
int attention_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                      void* scratch, int batch, int n, int heads,
                      int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * head_dim;
  const int64_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* x = static_cast<const char*>(qkv);
  const char* dx = static_cast<const char*>(dqkv);
  const void* ptrs[7] = {x, x + hd * es, x + 2 * hd * es, g,
                         dx, dx + hd * es, dx + 2 * hd * es};
  const int64_t row = 3 * hd, img = n * row;
  const int64_t strides[14] = {img, row, img, row, img, row, n * hd, hd,
                               img, row, img, row, img, row};
  return dispatch(ptrs, strides, scratch, batch, n, heads, head_dim, scale,
                  dtype, -1, stream);
}

// attention_qkv_bwd on the given route (0 whole sequence, 1 key-chunked,
// whose scratch is B * H * 3 * pad16(n) floats) whatever route() would
// take: the two routes compared at one length (tools and tests; no entry
// point a user calls). Head widths above 256 and a whole-sequence route
// that does not exist or fit there return cudaErrorInvalidValue.
int attention_qkv_bwd_on_route(const void* qkv, const void* g, void* dqkv,
                               void* scratch, int batch, int n, int heads,
                               int head_dim, float scale, int dtype,
                               int route, void* stream) {
  if (bad_shape(batch, n, heads, head_dim) || (dtype != 0 && dtype != 1) ||
      route < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t hd = static_cast<int64_t>(heads) * head_dim;
  const int64_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* x = static_cast<const char*>(qkv);
  const char* dx = static_cast<const char*>(dqkv);
  const void* ptrs[7] = {x, x + hd * es, x + 2 * hd * es, g,
                         dx, dx + hd * es, dx + 2 * hd * es};
  const int64_t row = 3 * hd, img = n * row;
  const int64_t strides[14] = {img, row, img, row, img, row, n * hd, hd,
                               img, row, img, row, img, row};
  return dispatch(ptrs, strides, scratch, batch, n, heads, head_dim, scale,
                  dtype, route, stream);
}

// q, k, v, g in and dq, dk, dv out: seven (B, N, H*D) operands with unit
// feature stride, their pointers in ``ptrs`` and their (image, row)
// element strides in ``strides`` (14 values), in that order; scratch as
// for attention_qkv_bwd.
int attention_split_bwd(const void* const* ptrs, const int64_t* strides,
                        void* scratch, int batch, int n, int heads,
                        int head_dim, float scale, int dtype, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(ptrs, strides, scratch, batch, n, heads, head_dim, scale,
                  dtype, -1, stream);
}

const char* attention_qkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
