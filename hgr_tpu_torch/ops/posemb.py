"""2D sin-cos positional embedding (reference model/transformer.py:9-26).

numpy, computed once per grid. Layout matches the reference:
pe = concat(sin(x*w), cos(x*w), sin(y*w), cos(y*w)) over dim//4 freqs,
rows ordered row-major over the (h, w) grid.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def pos_emb_sincos_2d(
    h: int, w: int, dim: int, temperature: float = 10000.0
) -> np.ndarray:
    if dim % 4 != 0:
        raise ValueError(f"dimension must be divisible by 4, got {dim}")
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = np.arange(dim // 4, dtype=np.float64)
    omega = 1.0 / (temperature**omega)
    yv = y.reshape(-1)[:, None] * omega[None, :]
    xv = x.reshape(-1)[:, None] * omega[None, :]
    pe = np.concatenate(
        [np.sin(xv), np.cos(xv), np.sin(yv), np.cos(yv)], axis=1
    )
    pe = pe.astype(np.float32)
    pe.setflags(write=False)  # cached: every caller shares this array
    return pe
