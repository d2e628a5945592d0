"""Bilinear resizes as separable passes.

Port of hgr_tpu/ops/resize.py:30,46,60,80,93. The pose decoder upsamples
patch features x4 with ``align_corners=True`` semantics (reference
model/transformer.py:148-149); the interpolation matrices are applied as
``out = A_h @ x @ A_w^T`` in the compute dtype, so a bf16 model rounds
the matrices and each product to bf16 exactly as the JAX model does.
``resize_bilinear`` is the half-pixel resize of the detector's letterbox
(reference detect.py:38), in float32 as two taps per axis, which equals
the JAX package's HIGHEST-precision products bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, align_corners=True:
    src = i * (n_in - 1) / (n_out - 1)."""
    if n_in == 1:
        mat = np.ones((n_out, 1), np.float32)
    else:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
        frac = src - lo
        mat = np.zeros((n_out, n_in), np.float32)
        mat[np.arange(n_out), lo] = (1.0 - frac).astype(np.float32)
        mat[np.arange(n_out), lo + 1] = frac.astype(np.float32)
    mat.setflags(write=False)  # cached: every caller shares this array
    return mat


@functools.lru_cache(maxsize=64)
def _half_pixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear matrix, half-pixel centers (cv2/jax default):
    src = (i + 0.5) * n_in / n_out - 0.5, edge-clamped."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), np.float32)
    np.add.at(mat, (np.arange(n_out), lo0), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (np.arange(n_out), lo1), frac.astype(np.float32))
    mat.setflags(write=False)
    return mat


def _taps(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, ...]:
    """The two taps of each output row of ``_half_pixel_matrix``: (k0, w0,
    k1, w1), k0 < k1; a row with one nonzero (the clamped edge, where
    the matrix holds the summed weight) gets w1 = 0."""
    mat = _half_pixel_matrix(n_in, n_out)
    k0 = np.argmax(mat != 0, axis=1)
    last = n_in - 1 - np.argmax(mat[:, ::-1] != 0, axis=1)
    rows = np.arange(n_out)
    w0 = mat[rows, k0]
    w1 = np.where(last > k0, mat[rows, last], 0.0).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (k0, w0, last, w1))


def resize_taps(in_hw, out_hw, device=None) -> Tuple[Tuple, Tuple]:
    """The H and W taps of ``resize_bilinear`` on ``device`` (callers
    that resize one geometry often keep them)."""
    return tuple(_taps(int(i), int(o), device)
                 for i, o in zip(in_hw, out_hw))


def _blend(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    k0, w0, k1, w1 = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, k0) * w0.view(shape)
            + x.index_select(dim, k1) * w1.view(shape))


def resize_bilinear(x: torch.Tensor, out_hw, taps=None) -> torch.Tensor:
    """Half-pixel bilinear resize of (..., H, W, C) to ``out_hw`` (cv2.resize
    semantics without its 11-bit fixed point), in float32, returned in x's
    dtype; ``taps``: ``resize_taps``' pair for this geometry, when the
    caller keeps it.

    The JAX package applies the interpolation matrices as two f32
    products (hgr_tpu/ops/resize.py:60); each output is then the sum of
    two rounded products w0·x0 + w1·x1 (the other terms are zeros), which
    is what this computes, per axis, H first: equal bit for bit, where a
    matrix product here would fuse the multiply-adds."""
    th, tw = taps or resize_taps(x.shape[-3:-1], out_hw, x.device)
    y = _blend(x.float(), th, x.dim() - 3)
    return _blend(y, tw, x.dim() - 2).to(x.dtype)


def upsample_bilinear_align_corners(
        x: torch.Tensor, scale: int = 4,
        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., H*scale, W*scale, C), align_corners=True.

    The matrices and x are cast to ``compute_dtype``; each of the two
    products rounds to it; the result comes back in x's dtype.
    """
    # int(): the ONNX exporter's tracer gives sizes as tensors
    h, w = int(x.shape[-3]), int(x.shape[-2])
    ah = torch.tensor(_align_corners_matrix(h, h * scale), dtype=compute_dtype,
                      device=x.device)
    aw = torch.tensor(_align_corners_matrix(w, w * scale), dtype=compute_dtype,
                      device=x.device)
    y = torch.einsum("oh,...hwc->...owc", ah, x.to(compute_dtype))
    y = torch.einsum("pw,...owc->...opc", aw, y)
    return y.to(x.dtype)
