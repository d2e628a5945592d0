// Tensor-core building blocks of the bf16 attention kernels
// (attention_qkv_fwd.cu, attention_qkv_bwd.cu): cp.async staging of one
// head's rows into shared memory, ldmatrix fragment loads, and the
// mma.sync.aligned.m16n8k16 bf16 -> f32 product, for a padded head width
// Dp in {16, 32, 64, 128, 256} (the true width d <= Dp is a runtime value;
// staged columns d..Dp-1 are zero, so every product over Dp features
// equals the one over d).
//
// At Dp = 256 a warp's 16 x Dp output tile alone takes 128 f32 registers a
// lane, and the 16 x Dp A fragments another 64: together past what one
// thread may hold. There the A tile stays in shared memory (it is staged
// there anyway) and ldmatrix brings 32 of its features at a time into the
// product (products_smem), in the same mma order as the register form.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for a
// lane with group g = lane / 4 and thread-in-group t = lane % 4:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                           a[2] = (g, 2t+8..),   a[3] = (g + 8, 2t+8..)
//   B (16 x 8, column n):   b[0] = (rows 2t..2t+1, column g),
//                           b[1] = (rows 2t+8..2t+9, column g)
//   C (16 x 8, f32):        c[0], c[1] = (g, 2t..2t+1),
//                           c[2], c[3] = (g + 8, 2t..2t+1)
// so the four lanes of a quad hold one row of C between them (a row
// reduction is two xor shuffles), and the C tiles of 16 consecutive
// columns, rounded to bf16 in pairs, are the A fragment of a product over
// those 16 columns without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

// A staged row: Dp bf16 features and 8 of padding. ldmatrix reads 8 rows
// of 16 bytes at a time; at (Dp + 8) * 2 bytes a row (48, 80, 144 or 272)
// those start in 8 distinct 16-byte bank groups (at Dp * 2 bytes a row
// they would conflict up to 8 ways).
__host__ __device__ constexpr int row_pad(int dp) { return dp + 8; }
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Shared memory one H100 block may use; one SM's (228 KB), of which each
// resident block reserves 1 KB.
constexpr size_t kSmemLimit = 232448;
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemReservedPerBlock = 1024;

// Blocks with ``smem`` bytes of dynamic shared memory that one SM holds
// (the attention kernels' route rules count them).
inline int blocks_per_sm(size_t smem) {
  return static_cast<int>(kSmemPerSm / (smem + kSmemReservedPerBlock));
}

// The padded head width of the bodies for a head width d (1..256).
__host__ __device__ inline int padded_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Whether the bodies at padded width Dp read their A tiles from shared
// memory (products_smem) instead of holding them in registers; at those
// widths only the key-chunked kernels exist (the whole-sequence bodies
// keep a tile's fragments in registers).
__host__ __device__ constexpr bool a_in_smem(int dp) { return dp > 128; }

// Warps per block for ``tiles`` 16-row tiles: at most ``most`` (up to
// kMaxWarps), and as few as give every warp the same number of rounds.
inline int warps_for(int tiles, int most) {
  const int rounds = (tiles + most - 1) / most;
  return (tiles + rounds - 1) / rounds;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// commits and waits for every cp.async of this thread
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// closes this thread's group of cp.async copies issued since the last one
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most ``kPending`` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows 0..n-1 of one head (d features, row stride ``row`` elements)
// into ``dst`` as rows of row_pad(Dp) bf16, zero its columns d..Dp-1, and
// zero rows n..npad-1, so that products over the padded tile see zeros and
// never stale shared memory (0 x NaN is NaN). 16-byte cp.async copies when
// the rows allow them (16-byte aligned, row stride and d multiples of 8
// elements), else one element per thread into the same layout; thread
// ``tid`` of the ``threads`` that stage takes every threads-th piece. The
// caller waits (cp_async_wait_all, a group wait, or an mbarrier that the
// copies arrive on) and synchronises the threads that read.
template <int Dp>
__device__ __forceinline__ void stage_rows_by(const bf16* __restrict__ src,
                                              int64_t row, bf16* dst, int n,
                                              int npad, int d, unsigned tid,
                                              unsigned threads) {
  constexpr int kPad = row_pad(Dp);
  constexpr int kChunks = Dp / 8;  // 16-byte chunks of a staged row
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % 8 == 0 &&
      d % 8 == 0) {
    const int dc = d >> 3;
    for (int idx = tid; idx < n * kChunks; idx += threads) {
      const int j = idx / kChunks;
      const int c = idx - j * kChunks;
      if (c < dc) {
        cp_async16(dst + j * kPad + c * 8, src + j * row + c * 8);
      } else {
        *reinterpret_cast<uint4*>(dst + j * kPad + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < n * Dp; idx += threads) {
      const int j = idx / Dp;
      const int f = idx - j * Dp;
      dst[j * kPad + f] = f < d ? src[j * row + f] : zero;
    }
  }
  for (int idx = tid; idx < (npad - n) * kChunks; idx += threads) {
    const int j = n + idx / kChunks;
    *reinterpret_cast<uint4*>(dst + j * kPad + (idx % kChunks) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---- The staged ring of the bf16 key-chunked bodies (the forward's and
// the backward's, at every padded width).
// Chunks of the other side pass through kStages buffers in shared memory.
// One producer warp stages chunk i into buffer i % kStages by cp.async and
// arrives on that buffer's ``full`` barrier twice a lane: once when its
// copies have landed (cp.async.mbarrier.arrive.noinc) and once after its
// plain zero stores (mbarrier.arrive, a release); the consumer warps wait
// on ``full`` for the buffer they read, and each arrives once on its
// ``empty`` barrier when done, which the producer waits on before it
// stages chunk i + kStages there. No warp waits for the block: a fast warp
// runs up to kStages - 1 chunks ahead of the slowest.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stage = 0;
  unsigned phase = 0;
  // the next chunk's buffer
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// 32 producer lanes, each arriving twice a chunk
constexpr unsigned kRingFullCount = 64;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrives on ``bar`` once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits for the completion of the barrier's phase of parity ``parity``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra RING_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Thread 0 initialises the ring's barriers (``consumers`` warps release a
// buffer); the caller synchronises the block before their first use.
__device__ __forceinline__ void ring_init(const Ring& ring, int stages,
                                          int consumers,
                                          unsigned full = kRingFullCount) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + s, full);
      mbar_init(ring.empty + s, static_cast<unsigned>(consumers));
    }
    mbar_fence_init();
  }
}

// The producer lane's side of one chunk: wait until the buffer is free,
// ``stage()`` issues the lane's copies and zero stores, then arrive.
template <typename F>
__device__ __forceinline__ void ring_produce(Ring& ring, int stages,
                                             F&& stage) {
  mbar_wait(ring.empty + ring.stage, ring.phase ^ 1u);
  stage(ring.stage);
  mbar_arrive_copies(ring.full + ring.stage);
  mbar_arrive(ring.full + ring.stage);
  ring.advance(stages);
}

// A consumer warp: wait for the current buffer to be full ...
__device__ __forceinline__ void ring_acquire(const Ring& ring) {
  mbar_wait(ring.full + ring.stage, ring.phase);
}

// ... and release it when every lane is done reading it
__device__ __forceinline__ void ring_release(Ring& ring, int stages,
                                             int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty + ring.stage);
  ring.advance(stages);
}

// ---- Bulk staging of the ring at Dp >= 128. There a chunk's rows are
// long (256 or 512 bytes) and one producer warp issuing a 16-byte
// cp.async per lane for each of them falls behind the consumers; Hopper's
// bulk copy (the TMA engine) moves a whole row per instruction. The
// producer's lane 0 arrives on the buffer's ``full`` barrier expecting
// the chunk's bytes, every lane issues its rows' copies (which complete
// their bytes on that barrier) and its zero stores, then arrives (a
// release): kRingBulkCount arrivals a phase. The copies write columns
// 0..d-1 only: columns d..Dp-1 of every buffer are zeroed once, before
// the ring starts (ring_zero_columns).
constexpr unsigned kRingBulkCount = 33;

// whether rows at ``src`` (row stride ``row`` elements, d features) allow
// 16-byte copies: the cp.async and bulk paths' condition
__device__ __forceinline__ bool rows_16b(const bf16* src, int64_t row,
                                         int d) {
  return reinterpret_cast<uintptr_t>(src) % 16 == 0 && row % 8 == 0 &&
         d % 8 == 0;
}

__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// arrives on ``bar`` expecting ``bytes`` of bulk copies on it
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Zero columns d..Dp-1 of ``rows`` staged rows from ``dst`` (thread tid
// of ``threads``); the caller synchronises the block before the ring runs.
template <int Dp>
__device__ __forceinline__ void ring_zero_columns(bf16* dst, int rows, int d,
                                                  unsigned tid,
                                                  unsigned threads) {
  constexpr int kChunks = Dp / 8;
  const int dc = d >> 3, cols = kChunks - dc;
  for (int idx = tid; idx < rows * cols; idx += threads) {
    const int j = idx / cols;
    *reinterpret_cast<uint4*>(dst + j * row_pad(Dp) +
                              (dc + idx - j * cols) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The producer lane's part of one chunk on the bulk path: rows 0..n-1 of
// ``src`` into ``dst`` (a row a copy, completing on ``bar``), rows
// n..npad-1 zeroed whole.
template <int Dp>
__device__ __forceinline__ void bulk_rows(const bf16* __restrict__ src,
                                          int64_t row, bf16* dst, int n,
                                          int npad, int d, uint64_t* bar,
                                          int lane) {
  constexpr int kChunks = Dp / 8;
  for (int j = lane; j < n; j += 32) {
    bulk_row(dst + j * row_pad(Dp), src + j * row,
             static_cast<unsigned>(d) * 2u, bar);
  }
  for (int idx = lane; idx < (npad - n) * kChunks; idx += 32) {
    const int j = n + idx / kChunks;
    *reinterpret_cast<uint4*>(dst + j * row_pad(Dp) + (idx % kChunks) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The producer warp's side of one chunk on the bulk path: wait until the
// buffer is free, lane 0 arrives expecting ``bytes``, ``stage(buffer,
// bar)`` issues the lane's copies and zero stores, then every lane
// arrives.
template <typename F>
__device__ __forceinline__ void ring_produce_bulk(Ring& ring, int stages,
                                                  unsigned bytes, int lane,
                                                  F&& stage) {
  mbar_wait(ring.empty + ring.stage, ring.phase ^ 1u);
  uint64_t* bar = ring.full + ring.stage;
  if (lane == 0) mbar_arrive_expect(bar, bytes);
  __syncwarp();
  stage(ring.stage, bar);
  mbar_arrive(bar);
  ring.advance(stages);
}

template <int Dp>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src,
                                           int64_t row, bf16* dst, int n,
                                           int npad, int d) {
  stage_rows_by<Dp>(src, row, dst, n, npad, d, threadIdx.x, blockDim.x);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two 8 x 8 matrices, addressed by lanes 0..15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16 bf16) . b (16 x 8 bf16), f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), x0 in the low half
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as K bf16 pairs whose sum carries 8 K bits of each value: each
// part the rounding of what the parts before it leave out (differences
// exact in f32). K = 3 holds all 24 bits of an f32 value.
template <int K>
__device__ __forceinline__ void pack_split(float x0, float x1,
                                           uint32_t (&part)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    part[k] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// The A fragments of the 16 x Dp tile of staged rows r0..r0+15: a[s] for
// features 16s..16s+15. Lane l addresses row r0 + l % 16, column
// 8 * (l / 16): its four 8 x 8 matrices are a[s][0..3] in order.
template <int Dp>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dp / 16][4],
                                       const bf16* rows, int r0, int lane) {
  const bf16* p =
      rows + (r0 + (lane & 15)) * row_pad(Dp) + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < Dp / 16; ++s) ldsm_x4(a[s], p + 16 * s);
}

// c = A . X[r0..r0+7]^T for the 16 x Dp A tile ``a`` and staged rows X:
// the B fragments of X^T are X's rows as stored (lane l addresses row
// r0 + l % 8, features 8 * (l / 8)), one matrix per 8 features, four at a
// time (two at Dp = 16), all loaded before the products run.
template <int Dp>
__device__ __forceinline__ void product_t(float (&c)[4],
                                          const uint32_t (&a)[Dp / 16][4],
                                          const bf16* rows, int r0,
                                          int lane) {
  const bf16* p = rows + (r0 + (lane & 7)) * row_pad(Dp) + (lane >> 3) * 8;
  uint32_t b[Dp / 32 + (Dp % 32 != 0)][4];
#pragma unroll
  for (int s = 0; s + 32 <= Dp; s += 32) ldsm_x4(b[s / 32], p + s);
  if constexpr (Dp % 32 != 0) {
    uint32_t h[2];
    ldsm_x2(h, p + Dp - 16);
    b[Dp / 32][0] = h[0];
    b[Dp / 32][1] = h[1];
  }
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int s = 0; s + 32 <= Dp; s += 32) {
    mma(c, a[s / 16], b[s / 32][0], b[s / 32][1]);
    mma(c, a[s / 16 + 1], b[s / 32][2], b[s / 32][3]);
  }
  if constexpr (Dp % 32 != 0) {
    mma(c, a[Dp / 16 - 1], b[Dp / 32][0], b[Dp / 32][1]);
  }
}

// products<Dp, NT> with the 16 x Dp A tile read from the staged rows
// ``a_rows`` (tile rows a0..a0+15) 32 features at a time, for Dp = 256:
// each C tile takes its mma steps in the register form's order.
template <int Dp, int NT>
__device__ __forceinline__ void products_smem(float (&c)[NT][4],
                                              const bf16* a_rows, int a0,
                                              const bf16* rows, int r0,
                                              int npad, int lane) {
  static_assert(Dp % 32 == 0, "32 features a step");
  const bf16* pa = a_rows + (a0 + (lane & 15)) * row_pad(Dp) + (lane >> 4) * 8;
  const bf16* pb = rows + (r0 + (lane & 7)) * row_pad(Dp) + (lane >> 3) * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int f = 0; f < Dp; f += 32) {
    uint32_t a0f[4], a1f[4];
    ldsm_x4(a0f, pa + f);
    ldsm_x4(a1f, pa + f + 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (r0 + 8 * j < npad) {
        uint32_t b[4];
        ldsm_x4(b, pb + 8 * j * row_pad(Dp) + f);
        mma(c[j], a0f, b[0], b[1]);
        mma(c[j], a1f, b[2], b[3]);
      }
    }
  }
}

// masked_scores<Dp, NT> with the query tile read from the staged rows
// ``q_rows`` (tile rows q0..q0+15), for Dp = 256.
template <int Dp, int NT>
__device__ __forceinline__ void masked_scores_smem(float (&s)[NT][4],
                                                   const bf16* q_rows, int q0,
                                                   const bf16* ks, int key0,
                                                   int n, int npad,
                                                   float scale, int lane) {
  products_smem<Dp>(s, q_rows, q0, ks, key0, npad, lane);
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

// c[j] = A . X[r0 + 8j .. r0 + 8j + 7]^T, the raw f32 products of the
// 16 x Dp A tile ``a`` with NT 8-row tiles of staged rows X from r0 on;
// tiles at or past npad are not computed (zero).
template <int Dp, int NT>
__device__ __forceinline__ void products(float (&c)[NT][4],
                                         const uint32_t (&a)[Dp / 16][4],
                                         const bf16* rows, int r0, int npad,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (r0 + 8 * j < npad) {
      product_t<Dp>(c[j], a, rows, r0 + 8 * j, lane);
    } else {
      c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    }
  }
}

// s = the scores of the query tile ``qa`` against NT 8-key tiles of the
// staged keys from key0 on: the f32 dot, then __fmul_rn by scale (never
// contracted into what follows); keys at or beyond n, and tiles at or
// past npad (not computed), at -inf. (For a chunk of keys staged on its
// own, key0 counts from the chunk's first key and n is the number of keys
// left from it.)
template <int Dp, int NT>
__device__ __forceinline__ void masked_scores(float (&s)[NT][4],
                                              const uint32_t (&qa)[Dp / 16][4],
                                              const bf16* ks, int key0,
                                              int n, int npad, float scale,
                                              int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k0 = key0 + 8 * j;
    if (k0 < npad) {
      product_t<Dp>(s[j], qa, ks, k0, lane);
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

// masked_scores for a step of the ring bodies: where every key of the
// step lies below n, the same scaled products without the mask's compares
// and selects.
template <int Dp, int NT>
__device__ __forceinline__ void step_scores(float (&s)[NT][4],
                                            const uint32_t (&qa)[Dp / 16][4],
                                            const bf16* ks, int key0, int n,
                                            int npad, float scale, int lane) {
  if (key0 + 8 * NT <= n && key0 + 8 * NT <= npad) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      product_t<Dp>(s[j], qa, ks, key0 + 8 * j, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    }
  } else {
    masked_scores<Dp>(s, qa, ks, key0, n, npad, scale, lane);
  }
}

// step_scores with the query tile read from the staged rows ``q_rows``
// (tile rows q0..q0+15; products_smem), for the ring bodies at the widths
// whose Q fragments stay in shared memory: the same values.
template <int Dp, int NT>
__device__ __forceinline__ void step_scores_smem(float (&s)[NT][4],
                                                 const bf16* q_rows, int q0,
                                                 const bf16* ks, int key0,
                                                 int n, int npad, float scale,
                                                 int lane) {
  if (key0 + 8 * NT <= n && key0 + 8 * NT <= npad) {
    products_smem<Dp>(s, q_rows, q0, ks, key0, npad, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    }
  } else {
    masked_scores_smem<Dp>(s, q_rows, q0, ks, key0, n, npad, scale, lane);
  }
}

// acc (16 x Dp, Dp / 8 C tiles of 16 x 8) += (A_0 + ... + A_{K-1}) .
// X[r0..r0+15] for the K 16 x 16 A fragments ``a`` (over rows r0..r0+15
// of X) and staged rows X: the B fragments come through ldmatrix.trans
// once for all K, lane l addressing row r0 + l % 16, features
// f0 + 8 * (l / 16).
template <int Dp, int K>
__device__ __forceinline__ void accumulate(float (&acc)[Dp / 8][4],
                                           const uint32_t (&a)[K][4],
                                           const bf16* rows, int r0,
                                           int lane) {
  const bf16* p =
      rows + (r0 + (lane & 15)) * row_pad(Dp) + (lane >> 4) * 8;
#pragma unroll
  for (int f = 0; f < Dp / 16; ++f) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + 16 * f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mma(acc[2 * f], a[k], b[0], b[1]);
      mma(acc[2 * f + 1], a[k], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Store columns 0..d-1 of the 16 x Dp f32 tile ``acc`` (rows r0.., C
// layout) as bf16 rows of ``dst`` (row stride ``row`` elements), rows at
// or beyond n skipped.
template <int Dp>
__device__ __forceinline__ void store_rows(const float (&acc)[Dp / 8][4],
                                           bf16* dst, int64_t row, int r0,
                                           int n, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // every column stored in pairs (the model's widths), or one by one
  const bool pairs = reinterpret_cast<uintptr_t>(dst) % 4 == 0 &&
                     row % 2 == 0 && d == Dp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + g + 8 * half;
    if (i >= n) continue;
#pragma unroll
    for (int f = 0; f < Dp / 8; ++f) {
      const int col = 8 * f + 2 * t;
      bf16* p = dst + i * row + col;
      const float x0 = acc[f][2 * half], x1 = acc[f][2 * half + 1];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(p) = pack(x0, x1);
      } else {
        if (col < d) p[0] = __float2bfloat16(x0);
        if (col + 1 < d) p[1] = __float2bfloat16(x1);
      }
    }
  }
}

}  // namespace attn_mma
