"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``hgr_tpu_torch/csrc/`` has a plain C interface.
On first use in a process it is compiled with ``nvcc`` for ``sm_90a``
into a shared library and loaded with ``ctypes``. Libraries are cached in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds
and concurrent processes never load a half-written file.

Nothing here runs at import: the CPU tests import every module of the
package on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "kernels"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Flags of one kernel on top of NVCC_FLAGS. The warp rounds every product
# and sum on its own, as its plain PyTorch version does (no fused
# multiply-add), so that the HSV LUT's floor sees the same values.
KERNEL_FLAGS: Dict[str, List[str]] = {"warp_twopass": ["-fmad=false"]}


@dataclasses.dataclass
class BuiltKernel:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: Optional[float]  # None: reused a library built earlier
    ptxas_log: str  # nvcc's -Xptxas -v report (registers, shared memory)


_loaded: Dict[str, BuiltKernel] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels build from source on the machine with the card")


def load_kernel(name: str) -> BuiltKernel:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_kernels([name])[name]


def load_kernels(names: List[str]) -> Dict[str, BuiltKernel]:
    """Build (if needed) and load ``csrc/<name>.cu`` for each name: the
    nvcc runs of the sources not built yet are started together, then
    awaited in order."""
    with _lock:
        libs, builds = {}, {}
        for name in dict.fromkeys(names):
            if name in _loaded:
                continue
            src = CSRC_DIR / f"{name}.cu"
            flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, [])
            # the headers a source may include count as part of it
            headers = b"".join(h.read_bytes()
                               for h in sorted(CSRC_DIR.glob("*.cuh")))
            digest = hashlib.sha256(
                src.read_bytes() + headers + " ".join(flags).encode()
            ).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
            libs[name] = lib_path
            if not lib_path.exists():
                tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                builds[name] = (proc, tmp, time.perf_counter())
        seconds: Dict[str, float] = {}
        failed = []
        for name, (proc, tmp, t0) in builds.items():
            log = proc.communicate()[0]  # every build ends before a raise
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {CSRC_DIR / name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            libs[name].with_suffix(".log").write_text(log)
            os.replace(tmp, libs[name])  # atomic: readers see whole files
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, lib_path in libs.items():
            log_path = lib_path.with_suffix(".log")
            ptxas = log_path.read_text() if log_path.exists() else ""
            _loaded[name] = BuiltKernel(ctypes.CDLL(str(lib_path)), lib_path,
                                        seconds.get(name), ptxas)
        return {name: _loaded[name] for name in names}


def kernel_device(t, op: str) -> str:
    """``t``'s device type, 'cpu' (the plain version runs) or 'cuda' (the
    kernel launches); any other device raises naming ``op``, since a
    kernel wrapper never falls back."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, got {t.device}")
    return t.device.type


def require_storage(op: str, *tensors) -> None:
    """Raise naming ``op`` unless every tensor has storage of its own. A
    kernel reads memory by pointer; a batched wrapper (the legacy vmap of
    ``torch.autograd.grad(..., is_grads_batched=True)``) has none, and a
    kernel boundary must reach the kernel only through a custom op, which
    that vmap calls once per row with real tensors."""
    for t in tensors:
        try:
            t.untyped_storage()
        except (NotImplementedError, RuntimeError) as err:
            raise RuntimeError(
                f"{op} was handed a tensor without storage "
                f"({type(t).__name__} of shape {tuple(t.shape)}); a kernel "
                "needs real tensors") from err


def on_device(dev, launch):
    """``launch(stream)`` with card ``dev`` current (a kernel launches on
    the current device) and its current stream passed as an int; the
    device is switched, and restored, only when it is not current already
    (the cheap case is every call of a one-card process)."""
    import torch

    if dev.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))
