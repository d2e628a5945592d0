"""Run attention bodies of the card on the CPU and hold them against the
plain versions: the bodies of head widths above 256, and the bf16
key-chunked ring bodies, forward and backward, at every padded head width
(16 .. 256).

``g++`` compiles the device code of ``csrc/attention_wide.cuh`` and the
bf16 kernels of ``csrc/attention_qkv_fwd.cu`` and
``csrc/attention_qkv_bwd.cu`` as C++, with the real
``csrc/attention_mma.cuh`` whose PTX primitives (cp.async, mbarriers,
ldmatrix, mma) are swapped for the stand-ins in ``tools/emulate/`` (with
the CUDA headers and ``attention_tf32.cuh``'s mma), the PTX-only bulk copy
and bare SFU exp replaced by immediate copies and ``exp2f``, and runs each
block with one fiber per CUDA thread (``emulate.cpp``); an mbarrier wait
yields the fiber until the barrier's phase flips. A wide case runs the
forward and both backward kernels on the packed operands and on three
contiguous copies (split) and compares them with
``attention_qkv_reference`` and ``attention_qkv_bwd_reference`` at the
card's tolerances, the split outputs with the packed ones bit for bit. A
ring case (``--body ring``, ``--kernel fwd`` or ``bwd``) runs the ring
forward (or backward pair) packed and split, and the two-buffer
key-chunked kernel (pair) of ``tools/emulate/chunked_{fwd,bwd}.cuh``
packed, and compares the ring's output with the plain version, split with
packed, and the ring with the two-buffer kernel bit for bit (the same
steps in the same order give the same bits under the emulated arithmetic
too). It checks the bodies' indexing, fragment layouts, masking, staging,
the ring's buffer turns and softmax statistics without a card; not their
speed, not the ordering of asynchronous copies (they complete at once),
and not the tensor cores' rounding (the emulated mma sums in double).
Needs g++ (C++17) and ucontext:

    python -m hgr_tpu_torch.tools.emulate_wide --dtype bfloat16 --n 40 \\
        --heads 2 --head_dim 264
    python -m hgr_tpu_torch.tools.emulate_wide --body ring --n 337 \\
        --heads 2 --head_dim 16
    python -m hgr_tpu_torch.tools.emulate_wide --body ring --kernel bwd \\
        --n 81 --heads 1 --head_dim 256
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from hgr_tpu_torch.ops import attention as A

HERE = Path(__file__).resolve().parent / "emulate"
CSRC = HERE.parent.parent / "csrc"
HEADER = CSRC / "attention_wide.cuh"
MMA = CSRC / "attention_mma.cuh"
FWD = CSRC / "attention_qkv_fwd.cu"
BWD = CSRC / "attention_qkv_bwd.cu"
BUILD = HERE.parent.parent.parent / "build" / "emulate"
# the card's tolerances (tests/test_torch_gpu.py): forward atol, rtol;
# gradients atol, rtol
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.0)}
GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2**-7)}
# the helpers written in PTX, replaced by emulate.cpp's immediate copies
# and exp2f (attention_wide.cuh's, attention_qkv_fwd.cu's) and by the
# stand-ins of mma_primitives.h (attention_mma.cuh's)
_PTX_ONLY = ("bulk_copy", "expect_bytes")
_PTX_ONLY_FWD = ("ex2_ftz",)
_PTX_ONLY_MMA = ("smem_addr", "cp_async16", "cp_async_wait_all",
                 "cp_async_commit", "cp_async_wait", "mbar_init",
                 "mbar_fence_init", "mbar_arrive", "mbar_arrive_copies",
                 "mbar_wait", "ldsm_x4", "ldsm_x2", "ldsm_x4_trans", "mma",
                 "bulk_row", "mbar_arrive_expect")


def _cut(code: str, names, where: str) -> str:
    """``code`` without the definitions of the device functions ``names``
    (each with its template line, if it has one)."""
    for name in names:
        found = re.search(r"(template <[^>\n]*>\n)?__device__ __forceinline__ "
                          rf"[\w:]+ {name}\(", code)
        if found is None:
            raise RuntimeError(f"{where}: no device function {name}(...) to "
                               "replace; update the emulator's stand-ins")
        code = (code[:found.start()]
                + code[code.index("\n}\n", found.start()) + 3:])
    return code


def device_code(header: str) -> str:
    """The wide header's device code: cut before its host side, the
    PTX-only helpers taken out."""
    code = (header[:header.index("// Host side.")]
            + "}  // namespace attn_wide\n")
    return _cut(code, _PTX_ONLY, HEADER.name)


def mma_code(header: str) -> str:
    """attention_mma.cuh with its PTX primitives replaced by the
    stand-ins of mma_primitives.h."""
    return '#include "mma_primitives.h"\n' + _cut(header, _PTX_ONLY_MMA,
                                                  MMA.name)


def fwd_code(source: str) -> str:
    """The bf16 kernels of attention_qkv_fwd.cu (its anonymous namespace
    up to the f32 bodies), the bare SFU exp taken out."""
    start = source.index("\nnamespace {\n")
    end = source.index("// o += P V over one chunk of keys from key0 on, in "
                       "f32")
    return _cut(source[start:end], _PTX_ONLY_FWD, FWD.name) + (
        "}  // namespace\n")


def bwd_code(source: str) -> str:
    """The bf16 kernels of attention_qkv_bwd.cu (its anonymous namespace
    up to the f32 bodies) in a namespace of their own, emu_bwd (their
    helpers share the forward's names)."""
    start = source.index("\nnamespace {\n")
    end = source.index("// The f32 body, whole-sequence route")
    return ("\nnamespace emu_bwd {\n" + source[start + len("\nnamespace {\n"):end]
            + "}  // namespace emu_bwd\n")


@functools.lru_cache(maxsize=None)
def build() -> Path:
    """Compile the emulator (once per source: the binary is named by a
    hash of the header and the stand-ins) into ``build/emulate/``."""
    if shutil.which("g++") is None:
        raise RuntimeError("the emulator needs g++")
    generated = {"attention_wide_dev.cuh": device_code(HEADER.read_text()),
                 "attention_mma.cuh": mma_code(MMA.read_text()),
                 "attention_qkv_fwd_dev.cuh": fwd_code(FWD.read_text()),
                 "attention_qkv_bwd_dev.cuh": bwd_code(BWD.read_text())}
    digest = hashlib.sha256()
    for name, code in sorted(generated.items()):
        digest.update(name.encode() + code.encode())
    for f in sorted(HERE.iterdir()):
        digest.update(f.read_bytes())
    out = BUILD / digest.hexdigest()[:16]
    binary = out / "emulate"
    if binary.exists():
        return binary
    out.mkdir(parents=True, exist_ok=True)
    for name, code in generated.items():
        (out / name).write_text(code)
    tmp = out / f"emulate.{os.getpid()}"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{out}", f"-I{HERE}", "-o", str(tmp),
                    str(HERE / "emulate.cpp")], check=True)
    os.replace(tmp, binary)
    return binary


def run_case(dtype: str, b: int, n: int, heads: int, head_dim: int,
             seed: int = 0) -> dict:
    """One case through the emulated kernels against the plain versions:
    the largest errors, their excess over the tolerance (<= 0 passes),
    whether split equals packed bit for bit and every output is finite."""
    binary = build()
    rng = np.random.RandomState(seed + n * 7 + head_dim)
    qkv = rng.randn(b, n, 3 * heads * head_dim).astype(np.float32)
    g = rng.randn(b, n, heads * head_dim).astype(np.float32)
    scale = float(np.float32(head_dim**-0.5))
    outs, grads = {}, {}
    with tempfile.TemporaryDirectory() as work:
        qkv.tofile(os.path.join(work, "qkv.bin"))
        g.tofile(os.path.join(work, "g.bin"))
        for layout in ("packed", "split"):
            subprocess.run([str(binary), "f32" if dtype == "float32"
                            else "bf16", str(b), str(n), str(heads),
                            str(head_dim), repr(scale), layout, work],
                           check=True)
            outs[layout] = np.fromfile(os.path.join(work, f"out_{layout}.bin"),
                                       np.float32)
            grads[layout] = np.fromfile(
                os.path.join(work, f"dqkv_{layout}.bin"), np.float32)
    dt = getattr(torch, dtype)
    x, gt = torch.from_numpy(qkv).to(dt), torch.from_numpy(g).to(dt)
    ref = A.attention_qkv_reference(x, heads, head_dim, scale).float().numpy()
    dref = A.attention_qkv_bwd_reference(x, gt, heads, head_dim,
                                         scale).float().numpy()
    out = outs["packed"].reshape(ref.shape)
    grad = grads["packed"].reshape(dref.shape)
    atol, rtol = TOL[dtype]
    gatol, grtol = GRAD_TOL[dtype]
    return {
        "dtype": dtype, "shape": [b, n, heads, head_dim],
        "fwd_err": float(np.abs(out - ref).max()),
        "fwd_excess": float((np.abs(out - ref) - atol
                             - rtol * np.abs(ref)).max()),
        "bwd_err": float(np.abs(grad - dref).max()),
        "bwd_excess": float((np.abs(grad - dref) - gatol
                             - grtol * np.abs(dref)).max()),
        "split_equals_packed": bool(
            np.array_equal(outs["packed"], outs["split"])
            and np.array_equal(grads["packed"], grads["split"])),
        "finite": bool(np.isfinite(out).all() and np.isfinite(grad).all()),
    }


def run_ring_case(b: int, n: int, heads: int, head_dim: int,
                  seed: int = 0, kernel: str = "fwd") -> dict:
    """One case of the bf16 key-chunked forward (``kernel`` "fwd") or
    backward ("bwd"): the ring body packed and split and the two-buffer
    kernel packed, through the emulator; the ring's largest error against
    the plain version and its excess over the card's tolerance (<= 0
    passes), whether split equals packed and the ring equals the
    two-buffer kernel bit for bit, and whether every output is finite."""
    binary = build()
    rng = np.random.RandomState(seed + n * 7 + head_dim)
    qkv = rng.randn(b, n, 3 * heads * head_dim).astype(np.float32)
    g = rng.randn(b, n, heads * head_dim).astype(np.float32)
    scale = float(np.float32(head_dim**-0.5))
    suffix, name = ("", "out") if kernel == "fwd" else ("_bwd", "dqkv")
    outs = {}
    with tempfile.TemporaryDirectory() as work:
        qkv.tofile(os.path.join(work, "qkv.bin"))
        g.tofile(os.path.join(work, "g.bin"))
        for body, layout in (("ring", "packed"), ("ring", "split"),
                             ("chunked", "packed")):
            subprocess.run([str(binary), body + suffix, str(b), str(n),
                            str(heads), str(head_dim), repr(scale), layout,
                            work], check=True)
            outs[body, layout] = np.fromfile(
                os.path.join(work, f"{name}_{layout}.bin"), np.float32)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    if kernel == "fwd":
        ref = A.attention_qkv_reference(x, heads, head_dim, scale)
        atol, rtol = TOL["bfloat16"]
    else:
        ref = A.attention_qkv_bwd_reference(
            x, torch.from_numpy(g).to(torch.bfloat16), heads, head_dim,
            scale)
        atol, rtol = GRAD_TOL["bfloat16"]
    ref = ref.float().numpy()
    out = outs["ring", "packed"].reshape(ref.shape)
    return {
        "body": "ring", "kernel": kernel, "shape": [b, n, heads, head_dim],
        f"{kernel}_err": float(np.abs(out - ref).max()),
        f"{kernel}_excess": float((np.abs(out - ref) - atol
                                   - rtol * np.abs(ref)).max()),
        "split_equals_packed": bool(np.array_equal(
            outs["ring", "packed"], outs["ring", "split"])),
        "ring_equals_chunked": bool(np.array_equal(
            outs["ring", "packed"], outs["chunked", "packed"])),
        "finite": bool(all(np.isfinite(o).all() for o in outs.values())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", default="wide", choices=("wide", "ring"),
                    help="the bodies of head widths above 256 (forward and "
                    "backward), or the bf16 key-chunked ring bodies (head "
                    "widths up to 256)")
    ap.add_argument("--kernel", default="fwd", choices=("fwd", "bwd"),
                    help="the ring body's kernel: the forward, or the "
                    "backward pair")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the wide bodies' type (the ring body is bf16)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--head_dim", type=int, default=264)
    args = ap.parse_args(argv)
    if args.body == "ring":
        row = run_ring_case(args.batch, args.n, args.heads, args.head_dim,
                            kernel=args.kernel)
        print(json.dumps(row))
        return 0 if (row[f"{args.kernel}_excess"] <= 0
                     and row["split_equals_packed"]
                     and row["ring_equals_chunked"]
                     and row["finite"]) else 1
    row = run_case(args.dtype, args.batch, args.n, args.heads, args.head_dim)
    print(json.dumps(row))
    return 0 if (row["fwd_excess"] <= 0 and row["bwd_excess"] <= 0
                 and row["split_equals_packed"] and row["finite"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
