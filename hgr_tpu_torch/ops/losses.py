"""Losses (port of hgr_tpu/ops/losses.py; reference libs/loss.py:4-40,
train.py:63-75).

``joints_mse_loss``: per joint, 0.5 · mean over (batch, pixels) of
(w·pred − w·gt)², summed over joints and divided by J — written as the
batch mean of the per-sample loss so that ``sample_mask`` can drop padded
samples. ``classification_loss``: mean softmax cross-entropy.
``multitask_loss``: 0.001 · CE + joints MSE.

``count`` replaces the number of valid samples in the denominator: a
data-parallel rank passes the global count, so its loss is (local sum) /
(global count) and the ranks' losses add up to the global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _masked_mean(per_sample: torch.Tensor,
                 sample_mask: Optional[torch.Tensor],
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch mean over samples with mask > 0 (plain mean without mask);
    ``count`` overrides the number of samples it divides by."""
    if sample_mask is None and count is None:
        return per_sample.mean()
    total = torch.sum(per_sample if sample_mask is None
                      else per_sample * sample_mask.float())
    if count is None:
        count = torch.sum(sample_mask.float())
    return total / torch.clamp(count, min=1.0)


def joints_mse_loss(output: torch.Tensor, target: torch.Tensor,
                    target_weight: Optional[torch.Tensor] = None,
                    sample_mask: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, J, H, W) heatmaps, (B, J) or (B, J, 1) visibility weights ->
    scalar float32 loss."""
    output = output.float()
    target = target.float()
    b, j = output.shape[0], output.shape[1]
    pred = output.reshape(b, j, -1)
    gt = target.reshape(b, j, -1)
    if target_weight is not None:
        w = target_weight.float().reshape(b, j, 1)
        pred = pred * w
        gt = gt * w
    per_sample = 0.5 * torch.mean(torch.mean((pred - gt) ** 2, dim=-1),
                                  dim=-1)
    return _masked_mean(per_sample, sample_mask, count)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        sample_mask: Optional[torch.Tensor] = None,
                        count: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits against (B,) integer labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(nll, sample_mask, count)


def multitask_loss(logits: torch.Tensor, heatmaps: torch.Tensor,
                   labels: torch.Tensor, target: torch.Tensor,
                   target_weight: Optional[torch.Tensor],
                   class_loss_weight: float = 0.001,
                   sample_mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = class_loss_weight · CE + joints MSE, with the parts."""
    class_loss = classification_loss(logits, labels, sample_mask,
                                      count) * class_loss_weight
    joints_loss = joints_mse_loss(heatmaps, target, target_weight,
                                  sample_mask, count)
    total = class_loss + joints_loss
    return total, {"total_loss": total, "class_loss": class_loss,
                   "joints_loss": joints_loss}
