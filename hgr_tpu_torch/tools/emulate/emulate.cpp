// Runs attention kernels on the host: csrc/attention_wide.cuh's, and the
// bf16 key-chunked bodies of csrc/attention_qkv_fwd.cu and
// csrc/attention_qkv_bwd.cu (the ring bodies, and the two-buffer kernels
// of chunked_fwd.cuh and chunked_bwd.cuh, their bit references). One
// fiber (ucontext) per CUDA thread, scheduled in turns; __syncthreads,
// __syncwarp and the warp collectives (ldmatrix, mma, shuffles) as
// barriers over the block or the warp, a
// collective's operands exchanged through per-warp slots; an mbarrier wait
// yields until its phase completes (mma_primitives.h). A block's shared
// memory starts as NaN, so a read of anything not staged shows. Built and
// driven by hgr_tpu_torch/tools/emulate_wide.py:
//   emulate <f32|bf16|ring|chunked|ring_bwd|chunked_bwd> B N H D scale
//           <packed|split> <dir>
// reads dir/qkv.bin (B, N, 3 H D) and dir/g.bin (B, N, H D) as float32,
// runs the kernels on the packed operands or on three contiguous copies,
// and writes dir/out_<layout>.bin (and, for the wide bodies, f32 or bf16,
// whose backward kernels run too, dir/dqkv_<layout>.bin) as float32;
// ring and chunked run the bf16 forward's ring body or its two-buffer
// kernel, ring_bwd and chunked_bwd the backward's pairs (dqkv), at the
// padded head width of D (16 .. 256).
#include <ucontext.h>

#include <cstdio>
#include <cstdlib>
#include <functional>
#include <string>
#include <vector>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "cuda_runtime.h"

EmuIdx emu_block_idx, emu_block_dim, emu_grid_dim;

namespace {
struct Fiber {
  ucontext_t ctx;
  EmuIdx tid;
  bool done;
  std::vector<char> stack;
};
std::vector<Fiber> fibers;
ucontext_t scheduler;
int current = -1;
long progress = 0;  // barriers passed, mbarrier arrivals, fibers finished
std::function<void()> body;

void yield_fiber() { swapcontext(&fibers[current].ctx, &scheduler); }

void entry() {
  body();
  fibers[current].done = true;
  ++progress;
  swapcontext(&fibers[current].ctx, &scheduler);
}

int block_arrived = 0, block_gen = 0;

struct WarpState {
  int arrived = 0, gen = 0;
  uint32_t slots[32][8];
};
WarpState warps[32];

void warp_barrier() {
  WarpState& w = warps[current / 32];
  const int gen = w.gen;
  if (++w.arrived == 32) {
    w.arrived = 0;
    ++w.gen;
    ++progress;
  } else {
    while (w.gen == gen) yield_fiber();
  }
}
}  // namespace

EmuIdx& emu_thread_idx() { return fibers[current].tid; }

void __syncthreads() {
  const int gen = block_gen;
  if (++block_arrived == static_cast<int>(fibers.size())) {
    block_arrived = 0;
    ++block_gen;
    ++progress;
  } else {
    while (block_gen == gen) yield_fiber();
  }
}

void __syncwarp() { warp_barrier(); }

namespace emu {
void post(const uint32_t* v, int n) {
  memcpy(warps[current / 32].slots[current % 32], v, n * 4);
  warp_barrier();
}
const uint32_t* slot(int l) { return warps[current / 32].slots[l]; }
void done() { warp_barrier(); }
int lane() { return current % 32; }
void yield() { yield_fiber(); }
void progressed() { ++progress; }
}  // namespace emu

float __shfl_xor_sync(unsigned, float v, int mask) {
  const uint32_t w = __float_as_uint(v);
  emu::post(&w, 1);
  const float r = __uint_as_float(emu::slot(emu::lane() ^ mask)[0]);
  emu::done();
  return r;
}

// the bulk copies complete at once: the expecting arrival completes the
// barrier's phase by itself
namespace attn_wide {
inline void bulk_copy(void* dst, const void* src, unsigned bytes,
                      uint64_t*) {
  memcpy(dst, src, bytes);
}
inline void expect_bytes(uint64_t* bar, unsigned) {
  attn_mma::mbar_arrive(bar);
}
}  // namespace attn_wide

#include "attention_wide_dev.cuh"

namespace attn_wide {
alignas(16) uint4 wide_smem[232448 / 16];
}

// the forward's dynamic shared memory (extern __shared__ smem_tc in its
// kernels), and its bare SFU exp
namespace {
alignas(16) uint4 smem_tc[232448 / 16];
inline float ex2_ftz(float x) { return exp2f(x); }
}  // namespace

#include "attention_qkv_fwd_dev.cuh"
#include "chunked_fwd.cuh"

// the backward's bf16 kernels and their dynamic shared memory, in a
// namespace of their own (their helpers share the forward's names)
namespace emu_bwd {
alignas(16) uint4 smem_tc[232448 / 16];
}  // namespace emu_bwd

#include "attention_qkv_bwd_dev.cuh"
#include "chunked_bwd.cuh"

namespace {
template <size_t kN>
void run_block(int threads, uint4 (&smem)[kN],
               const std::function<void()>& fn) {
  for (auto& u : smem) {
    u = {0x7fc00000u, 0x7fc00000u, 0x7fc00000u, 0x7fc00000u};
  }
  body = fn;
  fibers.assign(threads, Fiber());
  for (int i = 0; i < threads; ++i) {
    Fiber& f = fibers[i];
    f.tid = {unsigned(i), 0, 0};
    f.done = false;
    f.stack.resize(1 << 18);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.data();
    f.ctx.uc_stack.ss_size = f.stack.size();
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, entry, 0);
  }
  for (auto& w : warps) w.arrived = w.gen = 0;
  block_arrived = 0;
  emu_block_dim = {unsigned(threads), 1, 1};
  while (true) {
    bool any = false;
    const long before = progress;
    for (int i = 0; i < threads; ++i) {
      if (fibers[i].done) continue;
      any = true;
      current = i;
      swapcontext(&scheduler, &fibers[i].ctx);
    }
    if (!any) break;
    if (progress == before) {
      fprintf(stderr, "deadlock in block (%u, %u, %u)\n", emu_block_idx.x,
              emu_block_idx.y, emu_block_idx.z);
      exit(3);
    }
  }
}

template <size_t kN, typename Fn>
void grid(int gx, int gy, int gz, int threads, uint4 (&smem)[kN], Fn fn) {
  emu_grid_dim = {unsigned(gx), unsigned(gy), unsigned(gz)};
  for (int z = 0; z < gz; ++z) {
    for (int y = 0; y < gy; ++y) {
      for (int x = 0; x < gx; ++x) {
        emu_block_idx = {unsigned(x), unsigned(y), unsigned(z)};
        run_block(threads, smem, fn);
      }
    }
  }
}

// the wide kernels' grids (launch_fwd, launch_bwd)
template <typename Fn>
void wide_grid(int gx, int gy, int gz, Fn fn) {
  grid(gx, gy, gz, attn_wide::kThreads, attn_wide::wide_smem, fn);
}

std::vector<float> read_floats(const std::string& path, size_t n) {
  std::vector<float> v(n);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f || fread(v.data(), 4, n, f) != n) {
    fprintf(stderr, "cannot read %s\n", path.c_str());
    exit(2);
  }
  fclose(f);
  return v;
}

void write_floats(const std::string& path, const std::vector<float>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

template <typename T>
T from_float(float x);
template <>
float from_float<float>(float x) {
  return x;
}
template <>
__nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
float to_float(float x) { return x; }
float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// q, k, v of the (B, N, 3 H D) packed rows: views of the packed rows, or
// three contiguous copies (split); the element strides of an image and a
// row
template <typename T>
struct Layout {
  std::vector<T> sq, sk, sv;
  const T *q, *k, *v;
  int64_t img, row;
  Layout(const std::vector<T>& qkv, int B, int N, int64_t hd, bool split) {
    if (split) {
      sq.resize(size_t(B) * N * hd);
      sk = sq;
      sv = sq;
      for (int64_t r = 0; r < int64_t(B) * N; ++r) {
        for (int64_t f = 0; f < hd; ++f) {
          sq[r * hd + f] = qkv[r * 3 * hd + f];
          sk[r * hd + f] = qkv[r * 3 * hd + hd + f];
          sv[r * hd + f] = qkv[r * 3 * hd + 2 * hd + f];
        }
      }
      q = sq.data();
      k = sk.data();
      v = sv.data();
      img = N * hd;
      row = hd;
    } else {
      q = qkv.data();
      k = q + hd;
      v = q + 2 * hd;
      img = N * 3 * hd;
      row = 3 * hd;
    }
  }
};

template <typename T>
std::vector<T> read_as(const std::string& path, size_t n) {
  const auto f = read_floats(path, n);
  std::vector<T> t(n);
  for (size_t i = 0; i < n; ++i) t[i] = from_float<T>(f[i]);
  return t;
}

template <typename T>
void write_as_floats(const std::string& path, const std::vector<T>& t) {
  std::vector<float> f(t.size());
  for (size_t i = 0; i < t.size(); ++i) f[i] = to_float(t[i]);
  write_floats(path, f);
}

template <typename T>
void run(int B, int N, int H, int D, float scale, bool split,
         const std::string& dir) {
  using namespace attn_wide;
  const int64_t hd = int64_t(H) * D;
  const auto qkv = read_as<T>(dir + "/qkv.bin", size_t(B) * N * 3 * hd);
  const auto gg = read_as<T>(dir + "/g.bin", size_t(B) * N * hd);
  const Layout<T> ops(qkv, B, N, hd, split);
  const int64_t img = ops.img, row = ops.row;
  const std::string tag = split ? "split" : "packed";
  const int groups = cdiv(pad_width(D), kOut);
  // the launches' grids (launch_fwd, launch_bwd)
  std::vector<T> out(size_t(B) * N * hd, from_float<T>(NAN));
  const Rows<const T> rq{ops.q, img, row}, rk{ops.k, img, row},
      rv{ops.v, img, row};
  const Rows<T> ro{out.data(), N * hd, hd};
  const int f_tiles = cdiv(N, Kind<T>::kFwdRows);
  wide_grid(f_tiles * groups, H, B,
            [&] { wide_fwd_kernel<T>(rq, rk, rv, ro, N, D, scale, f_tiles); });
  write_as_floats(dir + "/out_" + tag + ".bin", out);

  std::vector<T> dq(size_t(B) * N * hd, from_float<T>(NAN)), dk = dq,
                                                             dv = dq;
  const Rows<const T> rg{gg.data(), N * hd, hd};
  const Rows<T> rdq{dq.data(), N * hd, hd}, rdk{dk.data(), N * hd, hd},
      rdv{dv.data(), N * hd, hd};
  std::vector<float> stats(size_t(B) * H * 3 * pad16(N), NAN);
  const int q_tiles = cdiv(N, Kind<T>::kRows);
  const int k_tiles = cdiv(N, Kind<T>::kKeys);
  wide_grid(q_tiles * groups, H, B, [&] {
    wide_bwd_q_kernel<T>(rq, rk, rv, rg, rdq, stats.data(), N, H, D, scale,
                         q_tiles);
  });
  wide_grid(k_tiles * groups, H, B, [&] {
    wide_bwd_k_kernel<T>(rq, rk, rv, rg, rdk, rdv, stats.data(), N, H, D,
                         scale, k_tiles);
  });
  std::vector<float> dqkv(size_t(B) * N * 3 * hd);
  for (int64_t r = 0; r < int64_t(B) * N; ++r) {
    for (int64_t f = 0; f < hd; ++f) {
      dqkv[r * 3 * hd + f] = to_float(dq[r * hd + f]);
      dqkv[r * 3 * hd + hd + f] = to_float(dk[r * hd + f]);
      dqkv[r * 3 * hd + 2 * hd + f] = to_float(dv[r * hd + f]);
    }
  }
  write_floats(dir + "/dqkv_" + tag + ".bin", dqkv);
}

// The bf16 key-chunked forward at padded width Dp on the grid its launch
// gives (attention_qkv_fwd.cu, launch_mma): the ring body, or the
// two-buffer kernel.
template <int Dp>
void run_chunked(bool ring, int B, int N, int H, int D, float scale,
                 bool split, const std::string& dir) {
  using bf16 = __nv_bfloat16;
  const int64_t hd = int64_t(H) * D;
  const auto qkv = read_as<bf16>(dir + "/qkv.bin", size_t(B) * N * 3 * hd);
  const Layout<bf16> ops(qkv, B, N, hd, split);
  const Operand<bf16> q{ops.q, ops.img, ops.row}, k{ops.k, ops.img, ops.row},
      v{ops.v, ops.img, ops.row};
  std::vector<bf16> out(size_t(B) * N * hd, from_float<bf16>(NAN));
  const int tiles = attn_mma::pad16(N) / 16;
  if (ring) {
    const int warps = tiles < ring_warps(Dp) ? tiles : ring_warps(Dp);
    grid((tiles + warps - 1) / warps, H, B, 32 * (warps + 1), smem_tc, [&] {
      attention_fwd_mma_ring_kernel<Dp>(q, k, v, out.data(), N, H, D, scale);
    });
  } else {
    grid((tiles + kChunkedWarps - 1) / kChunkedWarps, H, B,
         32 * kChunkedWarps, smem_tc, [&] {
           attention_fwd_mma_long_kernel<Dp>(q, k, v, out.data(), N, H, D,
                                             scale);
         });
  }
  write_as_floats(dir + "/out_" + std::string(split ? "split" : "packed") +
                      ".bin",
                  out);
}

// The bf16 key-chunked backward at padded width Dp on the grids its launch
// gives (attention_qkv_bwd.cu, launch): the ring pair, or the two-buffer
// pair; dq, dk and dv written packed as dqkv (B, N, 3 H D).
template <int Dp>
void run_chunked_bwd(bool ring, int B, int N, int H, int D, float scale,
                     bool split, const std::string& dir) {
  using bf16 = __nv_bfloat16;
  using namespace emu_bwd;
  const int64_t hd = int64_t(H) * D;
  const auto qkv = read_as<bf16>(dir + "/qkv.bin", size_t(B) * N * 3 * hd);
  const auto gg = read_as<bf16>(dir + "/g.bin", size_t(B) * N * hd);
  const Layout<bf16> in(qkv, B, N, hd, split);
  std::vector<bf16> dq(size_t(B) * N * hd, from_float<bf16>(NAN)), dk = dq,
                                                                   dv = dq;
  const Operands<bf16> ops{{in.q, in.img, in.row},      {in.k, in.img, in.row},
                           {in.v, in.img, in.row},      {gg.data(), N * hd, hd},
                           {dq.data(), N * hd, hd},     {dk.data(), N * hd, hd},
                           {dv.data(), N * hd, hd}};
  std::vector<float> stats(size_t(B) * H * 3 * attn_mma::pad16(N), NAN);
  const int tiles = attn_mma::pad16(N) / 16;
  if (ring) {
    const int qw = tiles < ring_warps(Dp) ? tiles : ring_warps(Dp);
    const int kw = tiles < ring_key_tiles(Dp) ? tiles : ring_key_tiles(Dp);
    grid((tiles + qw - 1) / qw, H, B, 32 * (qw + 1), smem_tc, [&] {
      attention_bwd_mma_ring_q_kernel<Dp>(ops, stats.data(), N, H, D, scale);
    });
    grid((tiles + kw - 1) / kw, H, B, 32 * (ring_roles(Dp) * kw + 1), smem_tc,
         [&] {
           attention_bwd_mma_ring_k_kernel<Dp>(ops, stats.data(), N, H, D,
                                               scale);
         });
  } else {
    const int blocks = (tiles + kChunkedWarps - 1) / kChunkedWarps;
    grid(blocks, H, B, 32 * kChunkedWarps, smem_tc, [&] {
      attention_bwd_mma_q_kernel<Dp>(ops, stats.data(), N, H, D, scale);
    });
    grid(blocks, H, B, 32 * kChunkedWarps * key_roles(Dp), smem_tc, [&] {
      attention_bwd_mma_k_kernel<Dp>(ops, stats.data(), N, H, D, scale);
    });
  }
  std::vector<float> dqkv(size_t(B) * N * 3 * hd);
  for (int64_t r = 0; r < int64_t(B) * N; ++r) {
    for (int64_t f = 0; f < hd; ++f) {
      dqkv[r * 3 * hd + f] = to_float(dq[r * hd + f]);
      dqkv[r * 3 * hd + hd + f] = to_float(dk[r * hd + f]);
      dqkv[r * 3 * hd + 2 * hd + f] = to_float(dv[r * hd + f]);
    }
  }
  write_floats(dir + "/dqkv_" + std::string(split ? "split" : "packed") +
                   ".bin",
               dqkv);
}

// the body at the padded width of D (16 .. 256)
template <template <int> class Run, typename... Args>
bool by_width(int D, Args... args) {
  switch (attn_mma::padded_width(D)) {
    case 16: Run<16>::go(args...); return true;
    case 32: Run<32>::go(args...); return true;
    case 64: Run<64>::go(args...); return true;
    case 128: Run<128>::go(args...); return true;
    case 256: Run<256>::go(args...); return true;
  }
  return false;
}
template <int Dp>
struct Fwd {
  template <typename... Args>
  static void go(Args... args) {
    run_chunked<Dp>(args...);
  }
};
template <int Dp>
struct Bwd {
  template <typename... Args>
  static void go(Args... args) {
    run_chunked_bwd<Dp>(args...);
  }
};
}  // namespace

int main(int argc, char** argv) {
  if (argc != 9) {
    fprintf(stderr,
            "usage: emulate <f32|bf16|ring|chunked|ring_bwd|chunked_bwd> B "
            "N H D scale <packed|split> dir\n");
    return 2;
  }
  const std::string body = argv[1];
  const int B = atoi(argv[2]), N = atoi(argv[3]), H = atoi(argv[4]),
            D = atoi(argv[5]);
  const float scale = strtof(argv[6], nullptr);
  const bool split = std::string(argv[7]) == "split";
  if (body == "f32") {
    run<float>(B, N, H, D, scale, split, argv[8]);
  } else if (body == "bf16") {
    run<__nv_bfloat16>(B, N, H, D, scale, split, argv[8]);
  } else {
    const bool bwd = body == "ring_bwd" || body == "chunked_bwd";
    const bool ring = body == "ring" || body == "ring_bwd";
    const bool ok = bwd ? by_width<Bwd>(D, ring, B, N, H, D, scale, split,
                                        std::string(argv[8]))
                        : by_width<Fwd>(D, ring, B, N, H, D, scale, split,
                                        std::string(argv[8]));
    if (!ok) {
      fprintf(stderr, "the key-chunked bodies take head widths up to 256\n");
      return 2;
    }
  }
  return 0;
}
