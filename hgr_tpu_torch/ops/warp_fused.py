"""Fused HSV jitter + two-pass affine warp of staged canvases (port of
hgr_tpu/ops/warp_pallas.py:warp_twopass_pallas).

* ``warp_twopass`` — on a CUDA tensor it launches the hand-written kernel
  ``csrc/warp_twopass.cu`` (the port of the TPU kernels
  ``_warp_kernel_packed`` :251 and ``_warp_kernel`` :195, one kernel
  templated over the canvas type) and counts the launch in
  ``warp_twopass.launches``. On a CPU tensor it runs
  ``warp_twopass_reference``, the kernel's plain version.
* The kernel takes the raw affines, gains and jitter flags and derives
  each image's inverse affine, transpose route, shear coefficients and
  border mask itself, in the plain version's operation order; the
  wrapper only checks and allocates.

The canvas is (B, S, S, 3) BGR in uint8 (the staged layout of the
loader), float32 or bfloat16, read as stored: no packing and no padding
of S to a multiple of 128 (both are TPU layout devices).
``round_output`` (default: the canvas is an integer type) rounds and
clips the crop to [0, 255]; the output is (B, out_h, out_w, 3) uint8 for
a uint8 canvas with rounding (the Pallas wrapper's return in the canvas's
dtype), float32 otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hgr_tpu_torch.ops.color import jitter_bgr_planes
from hgr_tpu_torch.ops.warp import batched_affine_warp_twopass
from hgr_tpu_torch.utils.cuda_build import load_kernel, on_device

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _check(canvas: torch.Tensor, m: torch.Tensor,
           out_size: Tuple[int, int]) -> Tuple[int, int]:
    if canvas.dim() != 4 or canvas.shape[-1] != 3:
        raise ValueError(
            f"canvas must be (B, S, S, 3), got {tuple(canvas.shape)}")
    b, s, s_w, _ = canvas.shape
    if s != s_w:
        raise ValueError("the two-pass warp expects square canvases")
    if tuple(m.shape) != (b, 2, 3):
        raise ValueError(f"affines must be ({b}, 2, 3), got {tuple(m.shape)}")
    out_h, out_w = int(out_size[0]), int(out_size[1])
    if not (1 <= out_h <= s and 1 <= out_w <= s):
        raise ValueError(f"output {out_h}x{out_w} must fit the {s} canvas")
    return out_h, out_w


def warp_twopass_reference(canvas: torch.Tensor, m: torch.Tensor,
                           out_size: Tuple[int, int],
                           jitter_gains: Optional[torch.Tensor] = None,
                           do_jitter: Optional[torch.Tensor] = None,
                           round_output: Optional[bool] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the optional HSV jitter
    (gains (B, 3), gated per image by ``do_jitter`` (B,) > 0), the
    two-pass warp with its border mask (``batched_affine_warp_twopass``),
    then the optional round/clip."""
    out_h, out_w = _check(canvas, m, out_size)
    if round_output is None:
        round_output = not canvas.dtype.is_floating_point
    img = canvas.float()
    if jitter_gains is not None:
        g = jitter_gains.float()
        jittered = torch.stack(jitter_bgr_planes(
            img[..., 0], img[..., 1], img[..., 2], g[:, 0, None, None],
            g[:, 1, None, None], g[:, 2, None, None]), dim=-1)
        if do_jitter is None:
            img = jittered
        else:
            img = torch.where((do_jitter > 0)[:, None, None, None],
                              jittered, img)
    out = batched_affine_warp_twopass(img, m, (out_h, out_w))
    if round_output:
        out = torch.round(torch.clamp(out, 0.0, 255.0))
    return out.to(_out_dtype(canvas.dtype, round_output))


def _out_dtype(canvas_dtype: torch.dtype, round_output: bool) -> torch.dtype:
    """uint8 for a uint8 canvas with rounding (as the Pallas wrapper
    returns the canvas's dtype), float32 otherwise."""
    return torch.uint8 if canvas_dtype == torch.uint8 and round_output \
        else torch.float32


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/warp_twopass.cu) with its C signatures
    declared."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.warp_twopass.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.warp_twopass.restype = i
    lib.warp_twopass_error_string.argtypes = [i]
    lib.warp_twopass_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    return _declare(load_kernel("warp_twopass").lib)


def _launch(canvas: torch.Tensor, m: torch.Tensor, out_h: int, out_w: int,
            jitter_gains: Optional[torch.Tensor],
            do_jitter: Optional[torch.Tensor],
            round_output: bool) -> torch.Tensor:
    """The kernel's launch on a checked contiguous CUDA canvas, contiguous
    float32 affines (B, 2, 3), gains (B, 3) and do_jitter (B,) on its
    card (either may be None). The kernel derives every per-image
    parameter from the affine itself."""
    b, s = canvas.shape[0], canvas.shape[1]
    dtype = _out_dtype(canvas.dtype, round_output)
    out = torch.empty((b, out_h, out_w, 3), dtype=dtype,
                      device=canvas.device)
    lib = _kernel()
    rc = on_device(canvas.device, lambda stream: lib.warp_twopass(
        canvas.data_ptr(), m.data_ptr(),
        None if jitter_gains is None else jitter_gains.data_ptr(),
        None if jitter_gains is None or do_jitter is None
        else do_jitter.data_ptr(),
        out.data_ptr(), b, s, out_h, out_w, _DTYPE_CODES[canvas.dtype],
        _DTYPE_CODES[dtype], int(round_output), stream))
    if rc != 0:
        msg = lib.warp_twopass_error_string(rc).decode()
        raise RuntimeError(f"warp_twopass launch failed: {msg} ({rc})")
    warp_twopass.launches += 1
    return out


def _checked(t: Optional[torch.Tensor], name: str, shape,
             canvas: torch.Tensor) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.device != canvas.device:
        raise ValueError(f"{name} on {t.device}, canvas on {canvas.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t.float().contiguous()


def warp_twopass(canvas: torch.Tensor, m: torch.Tensor,
                 out_size: Tuple[int, int],
                 jitter_gains: Optional[torch.Tensor] = None,
                 do_jitter: Optional[torch.Tensor] = None,
                 round_output: Optional[bool] = None) -> torch.Tensor:
    """(B, S, S, 3) canvas, (B, 2, 3) src->dst affines -> (B, out_h,
    out_w, 3): the jitter (when ``jitter_gains`` is given) fused into the
    two-pass warp; uint8 for a uint8 canvas with ``round_output``, else
    float32.

    A CUDA canvas launches the kernel (or raises: there is no fallback);
    a CPU canvas runs ``warp_twopass_reference``.
    """
    out_h, out_w = _check(canvas, m, out_size)
    if round_output is None:
        round_output = not canvas.dtype.is_floating_point
    if canvas.device.type == "cpu":
        return warp_twopass_reference(canvas, m, out_size, jitter_gains,
                                      do_jitter, round_output)
    if canvas.device.type != "cuda":
        raise ValueError(f"warp_twopass runs on cuda or cpu, got "
                         f"{canvas.device}")
    if canvas.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"warp kernel takes uint8, float32 or bfloat16 canvases, got "
            f"{canvas.dtype}")
    if not canvas.is_contiguous():
        raise ValueError("warp kernel needs a contiguous (B, S, S, 3) canvas")
    b = canvas.shape[0]
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} outside [1, 65535]")
    return _launch(canvas, _checked(m, "affines", (b, 2, 3), canvas), out_h,
                  out_w, _checked(jitter_gains, "jitter_gains", (b, 3),
                                  canvas),
                  _checked(do_jitter, "do_jitter", (b,), canvas),
                  round_output)


warp_twopass.launches = 0  # kernel launches, counted by _launch
