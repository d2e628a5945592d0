"""On-device metrics: PCK pose accuracy and the confusion matrix behind
macro-F1 (port of hgr_tpu/ops/metrics.py; reference libs/metrics.py,
train.py:67-73). Everything stays on the tensors' device; only the
caller moves scalars to the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hgr_tpu_torch.ops.heatmap import get_max_preds


def pck_accuracy(output: torch.Tensor, target: torch.Tensor,
                 thr: float = 0.5, sample_mask: Optional[torch.Tensor] = None,
                 reduce: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """PCK@thr of (B, J, H, W) heatmaps (reference libs/metrics.py:31-62).

    Distances between decoded peaks are normalized by [h, w] / 10 applied
    to (x, y), the reference's order; a joint counts where its target
    peak has both coords > 1. Returns acc (J + 1,) (acc[0] the average,
    -1 for joints with no valid sample), avg_acc, cnt (int32: joints with
    a valid sample) and the predicted peaks (B, J, 2). ``reduce`` maps the
    (2, J) per-joint counts (valid, below the threshold) to their sum over
    data-parallel ranks, so the accuracy is the global batch's.
    """
    output = output.float()
    target = target.float()
    h, w = output.shape[2], output.shape[3]
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    norm = torch.tensor([h / 10.0, w / 10.0], dtype=torch.float32,
                        device=output.device)
    valid = (gt[..., 0] > 1.0) & (gt[..., 1] > 1.0)
    if sample_mask is not None:
        valid = valid & (sample_mask > 0)[:, None]
    dists = torch.linalg.vector_norm((pred - gt) / norm, dim=-1)
    valid_f = valid.float()
    num_valid = valid_f.sum(dim=0)
    below = ((dists < thr) & valid).float().sum(dim=0)
    if reduce is not None:
        num_valid, below = reduce(torch.stack([num_valid, below]))
    per_joint = torch.where(num_valid > 0,
                            below / torch.clamp(num_valid, min=1.0),
                            torch.full_like(num_valid, -1.0))
    cnt = (num_valid > 0).float().sum()
    avg_acc = torch.where(
        cnt > 0, torch.where(per_joint >= 0, per_joint,
                             torch.zeros_like(per_joint)).sum()
        / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    acc = torch.cat([avg_acc[None], per_joint])
    return acc, avg_acc, cnt.to(torch.int32), pred


def confusion_update(conf: torch.Tensor, labels: torch.Tensor,
                     preds: torch.Tensor,
                     sample_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """conf + the (C, C) counts of (label, pred) pairs; samples with
    mask 0 count nothing."""
    c = conf.shape[0]
    lab = torch.nn.functional.one_hot(labels.long(), c).float()
    prd = torch.nn.functional.one_hot(preds.long(), c).float()
    if sample_mask is not None:
        lab = lab * sample_mask.float()[:, None]
    return conf + lab.T @ prd


def macro_f1_from_confusion(conf: torch.Tensor) -> torch.Tensor:
    """Macro F1 over classes of a (C, C) confusion matrix (rows = true),
    sklearn's ``f1_score(average='macro', zero_division=0)``."""
    conf = conf.float()
    tp = torch.diagonal(conf)
    fp = conf.sum(dim=0) - tp
    fn = conf.sum(dim=1) - tp
    denom = 2.0 * tp + fp + fn
    f1 = torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1.0),
                     torch.zeros_like(denom))
    return f1.mean()


def batch_macro_f1(labels: torch.Tensor, preds: torch.Tensor,
                   num_classes: int,
                   sample_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Macro F1 of one batch (the quantity the reference logs each step)."""
    conf = torch.zeros((num_classes, num_classes), dtype=torch.float32,
                       device=labels.device)
    return macro_f1_from_confusion(
        confusion_update(conf, labels, preds, sample_mask))
