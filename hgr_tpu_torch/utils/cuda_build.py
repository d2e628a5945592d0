"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``hgr_tpu_torch/csrc/`` has a plain C interface.
On first use in a process it is compiled with ``nvcc`` for ``sm_90a``
into a shared library and loaded with ``ctypes``. Libraries are cached in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source rebuilds
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
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
        log_path = lib_path.with_suffix(".log")
        seconds: Optional[float] = None
        if not lib_path.exists():
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)  # atomic: readers see whole files
        ptxas = log_path.read_text() if log_path.exists() else ""
        built = BuiltKernel(ctypes.CDLL(str(lib_path)), lib_path, seconds,
                            ptxas)
        _loaded[name] = built
        return built
