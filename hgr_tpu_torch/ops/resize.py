"""Align-corners bilinear upsample as two separable matmuls.

Port of hgr_tpu/ops/resize.py:30,80. The pose decoder upsamples patch
features x4 with ``align_corners=True`` semantics (reference
model/transformer.py:148-149); the interpolation matrices are applied as
``out = A_h @ x @ A_w^T`` in the compute dtype, so a bf16 model rounds
the matrices and each product to bf16 exactly as the JAX model does.
"""

from __future__ import annotations

import functools

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


def upsample_bilinear_align_corners(
        x: torch.Tensor, scale: int = 4,
        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., H*scale, W*scale, C), align_corners=True.

    The matrices and x are cast to ``compute_dtype``; each of the two
    products rounds to it; the result comes back in x's dtype.
    """
    h, w = x.shape[-3], x.shape[-2]
    ah = torch.tensor(_align_corners_matrix(h, h * scale), dtype=compute_dtype,
                      device=x.device)
    aw = torch.tensor(_align_corners_matrix(w, w * scale), dtype=compute_dtype,
                      device=x.device)
    y = torch.einsum("oh,...hwc->...owc", ah, x.to(compute_dtype))
    y = torch.einsum("pw,...owc->...opc", aw, y)
    return y.to(x.dtype)
