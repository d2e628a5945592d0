"""Do the two phases of the attention backward see the same scores?

Phase 1 of ``csrc/attention_qkv_bwd.cu`` takes S = Q Kᵀ with Q as the
mma's A operand; phase 2 takes Sᵀ = K Qᵀ with K as A. This probe builds a
small kernel from the same building blocks, computes both products for
every head of random operands, and counts the scores whose f32 bits
differ: in bf16 through ``csrc/attention_mma.cuh`` (one m16n8k16 product
a step), in float32 through ``csrc/attention_tf32.cuh`` (three TF32
products a step, the cross terms in the same order of Q and K whichever
is the A operand). Equal bits give equal P and dS in both phases (the
rest is the same instructions); unequal ones differ by the tensor core's
summation order, within the gradient tolerances either way.

    python -m hgr_tpu_torch.tools.probe_score_bits [--batch 64] [--n 145]
        [--dtype bfloat16|float32]

Needs the card and nvcc; prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

_SOURCE = r"""
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
namespace tc = attn_mma;
namespace tf = attn_tf32;

// s[bh, i, j] = q_i . k_j with Q as A; st[bh, j, i] = k_j . q_i with K as A
__global__ void probe(const tc::bf16* q, const tc::bf16* k, long long img,
                      long long row, int n, float* s, float* st) {
  extern __shared__ uint4 smem[];
  const int npad = tc::pad16(n);
  tc::bf16* qs = reinterpret_cast<tc::bf16*>(smem);
  tc::bf16* ks = qs + npad * tc::row_pad(32);
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const long long off = b * img + h * 32;
  tc::stage_rows<32>(q + off, row, qs, n, npad, 32);
  tc::stage_rows<32>(k + off, row, ks, n, npad, 32);
  tc::cp_async_wait_all();
  __syncthreads();
  const long long base = (static_cast<long long>(b) * gridDim.x + h) *
                         npad * npad;
  const int g = lane >> 2, t = lane & 3;
  for (int pass = 0; pass < 2; ++pass) {
    const tc::bf16* a_rows = pass == 0 ? qs : ks;
    const tc::bf16* b_rows = pass == 0 ? ks : qs;
    float* out = (pass == 0 ? s : st) + base;
    for (int r0 = 0; r0 < npad; r0 += 16) {
      uint32_t a[2][4];
      tc::load_a<32>(a, a_rows, r0, lane);
      for (int c0 = 0; c0 < npad; c0 += 8) {
        float c[4];
        tc::product_t<32>(c, a, b_rows, c0, lane);
        for (int e = 0; e < 4; ++e) {
          out[(r0 + g + 8 * (e >> 1)) * npad + c0 + 2 * t + (e & 1)] = c[e];
        }
      }
    }
  }
}

// the same in float32 through the three-way TF32 split, with Q as A
// (kAisX true) in the first product and K as A (false) in the second
__global__ void probe_f32(const float* q, const float* k, long long img,
                          long long row, int n, float* s, float* st) {
  extern __shared__ uint4 smem[];
  const int npad = tf::pad16(n);
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + npad * tf::row_pad(32);
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const long long off = b * img + h * 32;
  tf::stage_rows<32>(q + off, row, qs, n, npad, 32);
  tf::stage_rows<32>(k + off, row, ks, n, npad, 32);
  tc::cp_async_wait_all();
  __syncthreads();
  const long long base = (static_cast<long long>(b) * gridDim.x + h) *
                         npad * npad;
  const int g = lane >> 2, t = lane & 3;
  for (int pass = 0; pass < 2; ++pass) {
    float* out = (pass == 0 ? s : st) + base;
    for (int r0 = 0; r0 < npad; r0 += 16) {
      for (int c0 = 0; c0 < npad; c0 += 8) {
        float c[1][4];
        if (pass == 0) {
          tf::products<32, 1, true>(c, qs, r0, ks, c0, npad, lane);
        } else {
          tf::products<32, 1, false>(c, ks, r0, qs, c0, npad, lane);
        }
        for (int e = 0; e < 4; ++e) {
          out[(r0 + g + 8 * (e >> 1)) * npad + c0 + 2 * t + (e & 1)] =
              c[0][e];
        }
      }
    }
  }
}

extern "C" int probe_scores(const void* q, const void* k, long long img,
                            long long row, int batch, int n, int heads,
                            int f32, float* s, float* st) {
  const int npad = tc::pad16(n);
  if (f32) {
    const int smem = 2 * npad * tf::row_pad(32) * 4;
    cudaFuncSetAttribute(probe_f32,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_f32<<<dim3(heads, batch), 32, smem>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), img, row,
        n, s, st);
  } else {
    probe<<<dim3(heads, batch), 32, 2 * npad * tc::row_pad(32) * 2>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        img, row, n, s, st);
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def _build() -> ctypes.CDLL:
    from hgr_tpu_torch.utils.cuda_build import (
        BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "probe_score_bits.cu"
    lib = BUILD_DIR / "libprobe_score_bits.so"
    src.write_text(_SOURCE)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    out.probe_scores.argtypes = [p, p, ll, ll, i, i, i, i, p, p]
    out.probe_scores.restype = i
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=145)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_score_bits needs a CUDA card")
    lib = _build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    b, n, h = args.batch, args.n, args.heads
    qkv = torch.randn(b, n, 3 * h * 32, device="cuda",
                      generator=gen).to(getattr(torch, args.dtype))
    npad = -(-n // 16) * 16
    s, st = (torch.empty(b, h, npad, npad, device="cuda") for _ in range(2))
    rc = lib.probe_scores(qkv.data_ptr(), qkv[..., h * 32:].data_ptr(),
                          qkv.stride(0), qkv.stride(1), b, n, h,
                          int(args.dtype == "float32"), s.data_ptr(),
                          st.data_ptr())
    if rc != 0:
        raise RuntimeError(f"probe kernel failed ({rc})")
    s = s[..., :n, :n].contiguous()
    st = st[..., :n, :n].transpose(-1, -2).contiguous()
    differ = s.view(torch.int32) != st.view(torch.int32)
    print(json.dumps({
        "probe": "score_bits", "shape": [b, n, h], "dtype": args.dtype,
        "scores": s.numel(),
        "bits_differ": int(differ.sum()),
        "max_abs_diff": (s - st).abs().max().item(),
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
