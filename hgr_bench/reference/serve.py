"""What the serving paths compute, plain: the crop normalize and
classifier read-out, and the two-stage detect pipeline (reference
detect.py:15-157) — letterbox, YOLOv7-tiny, top-1 box, the square crop
warped from the original frame, the classifier, and the landmarks
mapped back into the frame. Each ``judge_*`` function reads the
served answers only to measure them against what the reference
computes from the same inputs."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hgr_bench.reference import yolo
from hgr_bench.reference.augment import MEAN, STD


def normalize(crops: torch.Tensor) -> torch.Tensor:
    """BGR (B, H, W, 3) of 0-255 values -> x/255 normalized with the RGB
    ImageNet statistics applied to the BGR channels (the reference's
    quirk)."""
    mean = torch.tensor(MEAN, device=crops.device)
    std = torch.tensor(STD, device=crops.device)
    return (crops.float() / 255.0 - mean) / std


def heatmap_gap(hm: torch.Tensor, served_cells: List) -> torch.Tensor:
    """Per joint of (J, Hh, Hw) reference heatmaps: how far the best
    value among the cells consistent with the served landmark lies below
    the heatmap's maximum, in units of the heatmap's standard deviation.
    ``served_cells[j]``: a boolean (Hh, Hw) mask of those cells. A
    heatmap whose maximum is at or below 0 is served as the first cell
    (the decode zeroes such landmarks)."""
    flat = hm.flatten(1)
    top = flat.max(1).values
    scale = flat.std(1).clamp(min=1e-12)
    out = []
    for j, mask in enumerate(served_cells):
        cand = flat[j][mask.flatten()]
        best = cand.max() if cand.numel() else flat[j].min()
        gap = (top[j] - best) / scale[j]
        if mask.flatten()[0]:  # served as the zeroed landmark
            gap = torch.minimum(gap, torch.clamp(top[j], min=0) / scale[j])
        out.append(gap)
    return torch.stack(out)


def judge_classify(logits: torch.Tensor, hm: torch.Tensor,
                   served: List[Dict]) -> Dict[str, float]:
    """Reference logits (B, C) and heatmaps (B, Hh, Hw, J) of the crops
    against the served answers: ``probs``, the largest |served
    probability - reference softmax|; ``label``, how far the reference's
    logit of the served label lies below its best; ``landmark``, the
    worst ``heatmap_gap`` (a served landmark is the heatmap argmax times
    4: its cell is landmark / 4)."""
    probs = torch.softmax(logits.float(), -1).cpu().numpy()
    lg = logits.float().cpu()
    hm = hm.permute(0, 3, 1, 2).float().cpu()
    b, j, hh, hw = hm.shape
    out = {"probs": 0.0, "label": 0.0, "landmark": 0.0}
    for i, ans in enumerate(served):
        out["probs"] = max(out["probs"],
                           float(np.abs(ans["probs"] - probs[i]).max()))
        lab = int(np.argmax(ans["probs"]))
        out["label"] = max(out["label"], float(lg[i].max() - lg[i, lab]))
        cells = []
        for x, y in np.asarray(ans["landmarks"]) / 4.0:
            m = torch.zeros(hh, hw, dtype=torch.bool)
            if 0 <= y < hh and 0 <= x < hw and x == int(x) and y == int(y):
                m[int(y), int(x)] = True
            cells.append(m)
        out["landmark"] = max(out["landmark"],
                              float(heatmap_gap(hm[i], cells).max()))
    return out


def letterbox(frames_u8: torch.Tensor, size: int):
    """BGR frames (B, H, W, 3) uint8 -> (detector input (B, 3, size,
    size) RGB in [0, 1], r, (dw, dh)): resized by r = min(size/H,
    size/W) with half-pixel bilinear taps, padded with 114 around the
    centre (top and left by round(d - 0.1))."""
    h, w = frames_u8.shape[1:3]
    r = min(size / h, size / w)
    uw, uh = int(round(w * r)), int(round(h * r))
    dw, dh = (size - uw) / 2, (size - uh) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    x = frames_u8.float().flip(-1).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(uh, uw), mode="bilinear",
                      align_corners=False)
    x = F.pad(x, (left, size - uw - left, top, size - uh - top),
              value=114.0)
    return x / 255.0, r, (dw, dh)


def crop_warp(frames: torch.Tensor, boxes: torch.Tensor, out: int
              ) -> torch.Tensor:
    """The square crop of side max(box w, box h) about each box's centre,
    resampled to out x out by bilinear taps of the original frame (0
    outside it): frames (B, H, W, 3) float, boxes (B, 4) -> (B, out,
    out, 3)."""
    b, h, w, _ = frames.shape
    side = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
    cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
    k = side / out  # source pixels per output pixel
    g = torch.arange(out, dtype=torch.float32, device=frames.device)
    sx = (cx - side / 2.0)[:, None] + g[None] * k[:, None]
    sy = (cy - side / 2.0)[:, None] + g[None] * k[:, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[:, None, :, None], (sy - y0)[:, :, None, None]
    x0, y0 = x0.long(), y0.long()
    flat = frames.reshape(b, h * w, 3)

    def tap(yi, xi):
        ok = ((yi[:, :, None] >= 0) & (yi[:, :, None] < h)
              & (xi[:, None, :] >= 0) & (xi[:, None, :] < w))
        idx = (yi.clamp(0, h - 1)[:, :, None] * w
               + xi.clamp(0, w - 1)[:, None, :])
        v = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, 3))
        return v.reshape(b, out, out, 3) * ok[..., None].float()

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def detector_rows(model: yolo.YOLOv7Tiny, frames_u8: torch.Tensor,
                  size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every anchor row's box in frame pixels, rounded as the pipeline
    rounds it, and its score: ((B, R, 4), (B, R))."""
    x, r, (dw, dh) = letterbox(frames_u8, size)
    boxes, scores = yolo.xyxy_scores(yolo.decode(model(x), model.nc))
    off = torch.tensor([dw, dh, dw, dh], device=boxes.device)
    return torch.round((boxes - off) / r), scores


def judge_detect(rows: torch.Tensor, scores: torch.Tensor,
                 served: List, thresh: float) -> Dict[str, float]:
    """Against the reference's rows: ``det_score``, how far the served
    box's row (the reference row that overlaps it most) scores below
    the reference's best, or the served score differs from that row's,
    and for a frame served no box, how far the best scores above the
    gate; ``det_box``, the largest pixel distance of a served box from
    its row's box."""
    out = {"det_score": 0.0, "det_box": 0.0}
    for i, ans in enumerate(served):
        best = float(scores[i].max())
        if ans is None:
            out["det_score"] = max(out["det_score"], best - thresh)
            continue
        sb = torch.tensor(np.asarray(ans["box"], np.float32),
                          device=rows.device)
        lt = torch.maximum(rows[i, :, :2], sb[:2])
        rb = torch.minimum(rows[i, :, 2:], sb[2:])
        inter = torch.clamp(rb - lt, min=0).prod(-1)
        area = (rows[i, :, 2:] - rows[i, :, :2]).prod(-1)
        iou = inter / (area + (sb[2:] - sb[:2]).prod() - inter + 1e-9)
        k = int(torch.argmax(iou))
        s = float(scores[i, k])
        out["det_score"] = max(out["det_score"], best - s,
                               abs(ans["score"] - s))
        out["det_box"] = max(out["det_box"],
                             float((rows[i, k] - sb).abs().max()))
    return out


def judge_detect_classify(logits: torch.Tensor, hm: torch.Tensor,
                          boxes: torch.Tensor, served: List
                          ) -> Dict[str, float]:
    """The classifier's part of served detections, from the reference's
    logits and heatmaps (B, Hh, Hw, J) of the crops of the served boxes:
    ``label`` as in ``judge_classify``; ``landmark``, the worst
    ``heatmap_gap`` over the cells whose landmark, mapped into the frame
    as the pipeline maps it (cell / Hw · side + corner, truncated), lies
    within a pixel of the served one."""
    lg = logits.float().cpu()
    hm = hm.permute(0, 3, 1, 2).float().cpu()
    _, _, hh, hw = hm.shape
    out = {"label": 0.0, "landmark": 0.0}
    for i, ans in enumerate(served):
        out["label"] = max(out["label"],
                           float(lg[i].max() - lg[i, ans["label"]]))
        b = boxes[i].float().cpu()
        side = torch.maximum(b[2] - b[0], b[3] - b[1])
        corner = torch.stack([(b[0] + b[2]) / 2.0 - side / 2.0,
                              (b[1] + b[3]) / 2.0 - side / 2.0])
        gx = torch.arange(hw, dtype=torch.float32) / hw * side + corner[0]
        gy = torch.arange(hh, dtype=torch.float32) / hh * side + corner[1]
        cells = []
        for x, y in np.asarray(ans["landmarks"], np.float32):
            cells.append(((gy[:, None] - y).abs() <= 1.0)
                         & ((gx[None, :] - x).abs() <= 1.0))
        out["landmark"] = max(out["landmark"],
                              float(heatmap_gap(hm[i], cells).max()))
    return out
