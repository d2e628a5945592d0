"""Heatmap argmax decode (port of hgr_tpu/ops/heatmap.py:93, reference
libs/utils.py:4-32): flat argmax -> (x, y), zeroed where the peak <= 0."""

from __future__ import annotations

from typing import Tuple

import torch


def get_max_preds(batch_heatmaps: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., J, H, W) -> preds (..., J, 2) float32 (x, y) and maxvals
    (..., J, 1) float32. Ties take the first flat index."""
    hm = batch_heatmaps.float()
    h, w = hm.shape[-2], hm.shape[-1]
    flat = hm.reshape(hm.shape[:-2] + (h * w,))
    maxvals, idx = torch.max(flat, dim=-1)
    px = (idx % w).float()
    py = torch.floor(idx.float() / w)
    preds = torch.stack([px, py], dim=-1)
    mask = (maxvals > 0.0).float()[..., None]
    return preds * mask, maxvals[..., None]
