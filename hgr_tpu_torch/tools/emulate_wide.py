"""Run the attention bodies of head widths above 256 on the CPU and hold
them against the plain versions.

``g++`` compiles the device code of ``csrc/attention_wide.cuh`` as C++
against the stand-ins in ``tools/emulate/`` (the CUDA headers, and the
primitives of ``attention_mma.cuh`` and ``attention_tf32.cuh`` with their
fragment layouts), the PTX-only bulk copy and its barrier replaced by
immediate copies, and runs each block with one fiber per CUDA thread
(``emulate.cpp``). A case runs the forward and both backward kernels on the
packed operands and on three contiguous copies (split) and compares them
with ``attention_qkv_reference`` and ``attention_qkv_bwd_reference`` at
the card's tolerances, the split outputs with the packed ones bit for bit.
It checks the bodies' indexing, fragment layouts, masking, staging and
softmax statistics without a card; not their speed, not the ordering of
asynchronous copies, and not the tensor cores' rounding (the emulated mma
sums in double). Needs g++ (C++17) and ucontext:

    python -m hgr_tpu_torch.tools.emulate_wide --dtype bfloat16 --n 40 \\
        --heads 2 --head_dim 264
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from hgr_tpu_torch.ops import attention as A

HERE = Path(__file__).resolve().parent / "emulate"
HEADER = HERE.parent.parent / "csrc" / "attention_wide.cuh"
BUILD = HERE.parent.parent.parent / "build" / "emulate"
# the card's tolerances (tests/test_torch_gpu.py): forward atol, rtol;
# gradients atol, rtol
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.0)}
GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2**-7)}
# the helpers written in PTX, replaced by emulate.cpp's immediate copies
_PTX_ONLY = ("bulk_copy", "expect_bytes")


def device_code(header: str) -> str:
    """The header's device code: cut before its host side, the PTX-only
    helpers taken out."""
    code = (header[:header.index("// Host side.")]
            + "}  // namespace attn_wide\n")
    for name in _PTX_ONLY:
        start = code.index(f"__device__ __forceinline__ void {name}(")
        code = code[:start] + code[code.index("\n}\n", start) + 3:]
    return code


@functools.lru_cache(maxsize=None)
def build() -> Path:
    """Compile the emulator (once per source: the binary is named by a
    hash of the header and the stand-ins) into ``build/emulate/``."""
    if shutil.which("g++") is None:
        raise RuntimeError("the emulator needs g++")
    code = device_code(HEADER.read_text())
    digest = hashlib.sha256(code.encode())
    for f in sorted(HERE.iterdir()):
        digest.update(f.read_bytes())
    out = BUILD / digest.hexdigest()[:16]
    binary = out / "emulate"
    if binary.exists():
        return binary
    out.mkdir(parents=True, exist_ok=True)
    (out / "attention_wide_dev.cuh").write_text(code)
    tmp = out / f"emulate.{os.getpid()}"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{HERE}", f"-I{out}", "-o", str(tmp),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--head_dim", type=int, default=264)
    args = ap.parse_args(argv)
    row = run_case(args.dtype, args.batch, args.n, args.heads, args.head_dim)
    print(json.dumps(row))
    return 0 if (row["fwd_excess"] <= 0 and row["bwd_excess"] <= 0
                 and row["split_equals_packed"] and row["finite"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
