"""Training loss of the YOLOv7-tiny detector, one box per image (port of
hgr_tpu/models/yolo_loss.py).

Each ground-truth box goes to its best (scale, anchor) by wh-IoU against
the anchor table, at the grid cell holding the box centre. Box
regression inverts the IDetect decode of ``yolo.decode_predictions``: its
targets are in the sigmoid domain, so the loss and the serving decode
cannot drift. Objectness is BCE over every cell (1 at the assigned one),
class BCE at the positives.

The head maps are channels-last (B, h, w, 3 (5 + nc)), as
``YOLOv7Tiny.forward`` returns them; everything is static-shaped.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from hgr_tpu_torch.models.yolo import ANCHORS, STRIDES


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the stable form)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def assign_targets(gt_cxcywh: torch.Tensor,
                   grid_hw: Sequence[Tuple[int, int]], anchors=ANCHORS,
                   strides=STRIDES):
    """The best (scale, anchor) per box by wh-IoU (the first on ties, as
    ``jnp.argmax``), its cell and the sigmoid-domain regression targets.
    Returns per scale (mask (B,) bool, anchor index (B,), cell_yx (B, 2)
    int64, t_sig (B, 4) [sx, sy, sw, sh])."""
    dev = gt_cxcywh.device
    w, h = gt_cxcywh[:, 2], gt_cxcywh[:, 3]
    flat = torch.tensor([a for scale in anchors for a in scale],
                        dtype=torch.float32, device=dev)  # (9, 2)
    inter = (torch.minimum(w[:, None], flat[None, :, 0])
             * torch.minimum(h[:, None], flat[None, :, 1]))
    union = (w * h)[:, None] + (flat[:, 0] * flat[:, 1])[None, :] - inter
    iou = inter / torch.clamp(union, min=1e-9)
    best = torch.argmax(iou, dim=-1)
    best_scale, best_anchor = best // 3, best % 3

    out = []
    for s, ((gh, gw), anc, stride) in enumerate(zip(grid_hw, anchors,
                                                    strides)):
        mask = best_scale == s
        cx_g = gt_cxcywh[:, 0] / stride
        cy_g = gt_cxcywh[:, 1] / stride
        gx = torch.clamp(torch.floor(cx_g), 0, gw - 1)
        gy = torch.clamp(torch.floor(cy_g), 0, gh - 1)
        # invert xy = (2 sig - 0.5 + g) stride: sig in [0.25, 0.75]
        sx = torch.clamp((cx_g - gx + 0.5) / 2.0, 1e-4, 1 - 1e-4)
        sy = torch.clamp((cy_g - gy + 0.5) / 2.0, 1e-4, 1 - 1e-4)
        # invert wh = (2 sig)^2 anchor: sig = sqrt(wh / anchor) / 2
        anc_t = torch.tensor(anc, dtype=torch.float32, device=dev)
        aw, ah = anc_t[best_anchor, 0], anc_t[best_anchor, 1]
        sw = torch.clamp(torch.sqrt(torch.clamp(w / aw, min=1e-8)) / 2.0,
                         1e-4, 1 - 1e-4)
        sh = torch.clamp(torch.sqrt(torch.clamp(h / ah, min=1e-8)) / 2.0,
                         1e-4, 1 - 1e-4)
        out.append((mask, best_anchor,
                    torch.stack([gy, gx], dim=-1).long(),
                    torch.stack([sx, sy, sw, sh], dim=-1)))
    return out


def yolo_single_box_loss(outs: List[torch.Tensor], gt_cxcywh: torch.Tensor,
                         num_classes: int = 1, box_weight: float = 5.0,
                         obj_weight: float = 1.0, cls_weight: float = 1.0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) for one box (B, 4) [cx, cy, w, h] in input pixels
    per image. Objectness is the mean over (h, w, anchor) per image,
    summed over the batch, over the number of scales; box and class sum
    over the positives and divide by B."""
    b = gt_cxcywh.shape[0]
    no = 5 + num_classes
    assigned = assign_targets(gt_cxcywh, [(o.shape[1], o.shape[2])
                                          for o in outs])
    total_obj = total_box = total_cls = 0.0
    bidx = torch.arange(b, device=gt_cxcywh.device)
    for out, (mask, anc_idx, cell_yx, t_sig) in zip(outs, assigned):
        _, gh, gw, _ = out.shape
        o = out.reshape(b, gh, gw, 3, no)
        idx = (bidx, cell_yx[:, 0], cell_yx[:, 1], anc_idx)
        pos = o[idx]  # (B, no)
        m = mask.to(out.dtype)
        box_l = _bce_logits(pos[:, 0:4], t_sig).sum(dim=-1)
        total_box = total_box + (box_l * m).sum()
        t_obj = out.new_zeros((b, gh, gw, 3)).index_put(idx, m)
        total_obj = total_obj + _bce_logits(o[..., 4], t_obj).mean(
            dim=(1, 2, 3)).sum()
        if num_classes > 0:
            cls_l = _bce_logits(pos[:, 5:], torch.ones_like(pos[:, 5:])).sum(
                dim=-1)
            total_cls = total_cls + (cls_l * m).sum()
    n_pos = max(float(b), 1.0)
    parts = {"box": box_weight * total_box / n_pos,
             "obj": obj_weight * total_obj / float(len(outs)),
             "cls": cls_weight * total_cls / n_pos}
    return parts["box"] + parts["obj"] + parts["cls"], parts
