"""Where the time of the attention bodies above head width 256 goes.

Builds variants of ``csrc/attention_wide.cuh`` with one part taken out
(each source copied into its own directory under
``build/wide_attribution/``, the header patched, every nvcc run started
together) and times each variant's packed forward or backward against the
source as it is, in turns (the variants in order, then in reverse), with
CUDA events over back-to-back launches through ctypes:

  no_scores  the score products (S, dA) skipped: scores stay zero
  no_pv      the forward's P V products skipped
  no_out     the backward's dq, dk and dv products skipped
  no_loads   the key and query chunks' copies and their waits skipped (the
             block's own rows are still staged)

A variant computes garbage; only its time is read. The differences from
``base`` attribute the time to the parts (they overlap where the parts
run side by side). Needs the card:

    python -m hgr_tpu_torch.tools.wide_attribution [--shapes 16,785,512 ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC.parent.parent / "build" / "wide_attribution"

_SCORES = [("for (int f = 0; f < width; f += 32) {",
            "for (int f = 0; f < 0 * width; f += 32) {"),
           ("for (int f0 = 0; f0 < width; f0 += kSlice) {",
            "for (int f0 = 0; f0 < 0 * width; f0 += kSlice) {")]
_LOADS = [("fill(src + static_cast<int64_t>(c) * kB * row, row, dst,\n"
           "         min(kB, n - c * kB), kB, d, bar);",
           "(void)src; (void)dst; (void)bar; (void)row;"),
          ("fill(src + static_cast<int64_t>(c) * kA * row, row, dst,\n"
           "         min(kA, n - c * kA), kA, d, bar);",
           "(void)src; (void)dst; (void)bar; (void)row;"),
          ("bars.wait(1 + u);", ";"), ("bars.wait(1 + kKV + u);", ";"),
          ("bars.wait(3);  // V(c)", ";"), ("bars.wait(2);  // K(c)", ";"),
          ("bars.wait(1);  // G(c)", ";"), ("bars.wait(0);  // Q(c)", ";")]
VARIANTS = {
    "fwd": {
        "base": [],
        "no_scores": _SCORES,
        "no_pv": [("accumulate<kA / 16, 1, kB>(o, ps, kPS, 0, buf(kKV + u), "
                   "0, ow, warp,\n                                 lane);",
                   ";"),
                  ("accumulate<kA / 16, 1, kB>(o, ps, kPS, 0, vs, 0, ow, "
                   "warp, lane);", ";")],
        "no_loads": _LOADS,
    },
    "bwd": {
        "base": [],
        "no_scores": _SCORES,
        "no_out": [("accumulate<kA / 16, K::kParts, kB>(acc_dq, ds, kPS, "
                    "kPlane, ks, 0,\n                                     "
                    "        ow, warp, lane);", ";"),
                   ("accumulate<kB / 16, 1, kA>(acc_dv, pt, kPS, 0, gs, 0, "
                    "ow, warp, lane);", ";"),
                   ("accumulate<kB / 16, K::kParts, kA>(acc_dk, dt, kPS, "
                    "kPlane, qs, 0, ow,\n                                  "
                    "       warp, lane);", ";")],
        "no_loads": _LOADS,
    },
}


def _patched(kind: str, name: str, patches) -> subprocess.Popen:
    from hgr_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    out = BUILD / f"{kind}_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    header = out / "attention_wide.cuh"
    text = header.read_text()
    for old, new in patches:
        if old not in text:
            raise ValueError(f"variant {kind} {name}: {old!r} not found")
        text = text.replace(old, new)
    header.write_text(text)
    src = f"attention_qkv_{kind}"
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out / f"lib{src}.so"),
         str(out / f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def build(kinds=("fwd", "bwd")) -> dict:
    """Every variant of ``kinds`` built at once: (kind, name) -> CDLL."""
    procs = {(k, n): _patched(k, n, p) for k in kinds
             for n, p in VARIANTS[k].items()}
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for (kind, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{log}")
        lib = ctypes.CDLL(str(BUILD / f"{kind}_{name}" /
                              f"libattention_qkv_{kind}.so"))
        if kind == "fwd":
            lib.attention_qkv_fwd.argtypes = [p, p, i, i, i, i,
                                              ctypes.c_float, i, p]
        else:
            lib.attention_qkv_bwd.argtypes = [p, p, p, p, i, i, i, i,
                                              ctypes.c_float, i, p]
        libs[(kind, name)] = lib
    return libs


def time_shape(libs: dict, b: int, n: int, head_dim: int, dtype: str,
               iters: int = 10) -> dict:
    """ms of each variant at (b, n, 2 heads x head_dim), in turns."""
    import torch

    dt = getattr(torch, dtype)
    code = 1 if dtype == "bfloat16" else 0
    gen = torch.Generator(device="cuda").manual_seed(b + n + head_dim)
    qkv = torch.randn(b, n, 6 * head_dim, device="cuda", generator=gen).to(dt)
    g = torch.randn(b, n, 2 * head_dim, device="cuda", generator=gen).to(dt)
    out = torch.empty(b, n, 2 * head_dim, device="cuda", dtype=dt)
    dqkv = torch.empty_like(qkv)
    scratch = torch.empty(b * 2 * 3 * ((n + 15) // 16 * 16), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = head_dim ** -0.5
    rows = {}
    for kind in ("fwd", "bwd"):
        names = [name for k, name in libs if k == kind]
        if not names:
            continue
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            lib = libs[(kind, name)]
            if kind == "fwd":
                def call(lib=lib):
                    return lib.attention_qkv_fwd(
                        qkv.data_ptr(), out.data_ptr(), b, n, 2, head_dim,
                        scale, code, stream)
            else:
                def call(lib=lib):
                    return lib.attention_qkv_bwd(
                        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                        scratch.data_ptr(), b, n, 2, head_dim, scale, code,
                        stream)
            for _ in range(2):
                if call() != 0:
                    raise RuntimeError(f"{kind} {name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / iters)
        rows[kind] = {name: sum(v) / len(v) for name, v in ms.items()}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*",
                    default=["16,785,512", "4,785,512", "64,145,512"],
                    help="batch,n,head_dim (2 heads)")
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    libs = build()
    for shape in args.shapes:
        b, n, dh = (int(v) for v in shape.split(","))
        for dtype in args.dtypes:
            print(json.dumps({"shape": [b, n, 2, dh], "dtype": dtype,
                              "ms": time_shape(libs, b, n, dh, dtype)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
