"""Fused HSV jitter + two-pass affine warp of staged canvases (port of
hgr_tpu/ops/warp_pallas.py:warp_twopass_pallas).

* ``warp_twopass`` — on a CUDA tensor it launches the hand-written kernel
  ``csrc/warp_twopass.cu`` (the port of the TPU kernels
  ``_warp_kernel_packed`` :251 and ``_warp_kernel`` :195, one kernel
  templated over the canvas type) and counts the launch in
  ``warp_twopass.launches``. On a CPU tensor it runs
  ``warp_twopass_reference``, the kernel's plain version.
* The host side is the Pallas wrapper's: invert the affine, route through
  the transpose where |t| < |s|, compute alpha, beta, gamma, then the
  BORDER_CONSTANT mask and the round/clip. The kernel does the per-pixel
  part, mask and rounding included; the plain version does the same steps
  in the same order.

The canvas is (B, S, S, 3) BGR in uint8 (the staged layout of the
loader), float32 or bfloat16, read as stored: no packing and no padding
of S to a multiple of 128 (both are TPU layout devices). The output is
(B, out_h, out_w, 3) float32; ``round_output`` (default: the canvas is
an integer type) rounds and clips it to [0, 255], as the uint8 return of
the Pallas wrapper and the pipeline's quantization step do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hgr_tpu_torch.ops.color import jitter_bgr_planes
from hgr_tpu_torch.ops.warp import (
    batched_affine_warp_twopass,
    twopass_coefficients,
)

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
    return out


def _kernel_params(m: torch.Tensor, jitter_gains: Optional[torch.Tensor],
                   do_jitter: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 17) float32 per-image parameters of the kernel: alpha, beta,
    gamma, s2, t2, u2, the three gains, do_jitter, use_t, then the
    inverse affine's six entries (for the border mask)."""
    minv, use_t, *shear = twopass_coefficients(m)
    b = m.shape[0]
    ones = torch.ones(b, dtype=torch.float32, device=m.device)
    gains = (jitter_gains.float() if jitter_gains is not None
             else torch.ones(b, 3, dtype=torch.float32, device=m.device))
    dj = (ones if do_jitter is None or jitter_gains is None
          else (do_jitter > 0).float())
    return torch.cat([torch.stack(shear, dim=-1), gains, dj[:, None],
                      use_t.float()[:, None], minv.reshape(b, 6)],
                     dim=-1).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    lib = load_kernel("warp_twopass").lib
    lib.warp_twopass.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.warp_twopass.restype = ctypes.c_int
    lib.warp_twopass_error_string.argtypes = [ctypes.c_int]
    lib.warp_twopass_error_string.restype = ctypes.c_char_p
    return lib


def _launch(canvas, m, out_h, out_w, jitter_gains, do_jitter,
            round_output) -> torch.Tensor:
    if canvas.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"warp kernel takes uint8, float32 or bfloat16 canvases, got "
            f"{canvas.dtype}")
    if not canvas.is_contiguous():
        raise ValueError("warp kernel needs a contiguous (B, S, S, 3) canvas")
    b, s = canvas.shape[0], canvas.shape[1]
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} outside [1, 65535]")
    for name, t in (("affines", m), ("jitter_gains", jitter_gains),
                    ("do_jitter", do_jitter)):
        if t is not None and t.device != canvas.device:
            raise ValueError(f"{name} on {t.device}, canvas on "
                             f"{canvas.device}")
    params = _kernel_params(m, jitter_gains, do_jitter)
    return launch_with_params(canvas, params, out_h, out_w,
                              jitter_gains is not None, round_output)


def launch_with_params(canvas: torch.Tensor, params: torch.Tensor,
                       out_h: int, out_w: int, jitter: bool,
                       round_output: bool) -> torch.Tensor:
    """The kernel's launch alone, on a checked contiguous CUDA canvas and
    its (B, 17) parameters from ``_kernel_params`` (the wrapper's host-side
    part, a dozen small torch ops, done beforehand): what a timing of the
    kernel without that part calls."""
    b, s = canvas.shape[0], canvas.shape[1]
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.float32,
                      device=canvas.device)
    lib = _kernel()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        rc = lib.warp_twopass(
            canvas.data_ptr(), params.data_ptr(), out.data_ptr(), b, s,
            out_h, out_w, _DTYPE_CODES[canvas.dtype], int(jitter),
            int(round_output), stream)
    if rc != 0:
        msg = lib.warp_twopass_error_string(rc).decode()
        raise RuntimeError(f"warp_twopass launch failed: {msg} ({rc})")
    warp_twopass.launches += 1
    return out


def warp_twopass(canvas: torch.Tensor, m: torch.Tensor,
                 out_size: Tuple[int, int],
                 jitter_gains: Optional[torch.Tensor] = None,
                 do_jitter: Optional[torch.Tensor] = None,
                 round_output: Optional[bool] = None) -> torch.Tensor:
    """(B, S, S, 3) canvas, (B, 2, 3) src->dst affines -> (B, out_h,
    out_w, 3) float32: the jitter (when ``jitter_gains`` is given) fused
    into the two-pass warp.

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
    return _launch(canvas, m, out_h, out_w, jitter_gains, do_jitter,
                   round_output)


warp_twopass.launches = 0  # kernel launches, counted by _launch
