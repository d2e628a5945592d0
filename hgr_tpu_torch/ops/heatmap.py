"""Gaussian heatmap targets and argmax decode (port of
hgr_tpu/ops/heatmap.py).

``generate_targets`` (reference libs/load.py:148-206) renders an
unnormalized Gaussian (peak 1) of std ``sigma`` inside a (6*sigma+1)^2
box around the quantized joint, batched over (B, J, Hh, Hw); joints whose
box misses the map get weight 0. mu = int(joint / stride + 0.5) with
Python's truncating int(), hence ``trunc`` and not ``floor``.
``get_max_preds`` (reference libs/utils.py:4-32): flat argmax -> (x, y),
zeroed where the peak <= 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from hgr_tpu_torch.ops.color import true_divide


def generate_targets(joints: torch.Tensor, joints_vis: torch.Tensor,
                     image_size: Sequence[int], heatmap_size: Sequence[int],
                     sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """joints (..., J, 2) in image pixels (x, y), joints_vis (..., J);
    image_size (W, H), heatmap_size (Hw, Hh). Returns target
    (..., J, Hh, Hw) and target_weight (..., J), both float32."""
    joints = joints.float()
    joints_vis = joints_vis.float()
    img_w, img_h = float(image_size[0]), float(image_size[1])
    hm_w, hm_h = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x, stride_y = img_w / hm_w, img_h / hm_h
    tmp_size = sigma * 3.0

    mu_x = torch.trunc(true_divide(joints[..., 0], stride_x) + 0.5)
    mu_y = torch.trunc(true_divide(joints[..., 1], stride_y) + 0.5)
    ul_x = torch.trunc(mu_x - tmp_size)
    ul_y = torch.trunc(mu_y - tmp_size)
    br_x = torch.trunc(mu_x + tmp_size + 1.0)
    br_y = torch.trunc(mu_y + tmp_size + 1.0)
    oob = (ul_x >= hm_w) | (ul_y >= hm_h) | (br_x < 0) | (br_y < 0)
    weight = torch.where(oob, torch.zeros_like(joints_vis), joints_vis)

    xs = torch.arange(hm_w, dtype=torch.float32, device=joints.device)
    ys = torch.arange(hm_h, dtype=torch.float32, device=joints.device)
    dx = xs - mu_x[..., None]  # (..., J, Hw)
    dy = ys - mu_y[..., None]  # (..., J, Hh)
    g = torch.exp(true_divide(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2),
                              2.0 * sigma ** 2))
    in_box = (((xs >= ul_x[..., None]) & (xs < br_x[..., None]))[..., None, :]
              & ((ys >= ul_y[..., None]) & (ys < br_y[..., None]))[..., :, None])
    target = torch.where((weight > 0.5)[..., None, None] & in_box, g,
                         torch.zeros_like(g))
    return target, weight


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
