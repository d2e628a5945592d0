"""Train YOLOv7-tiny briefly on synthetic hand-box scenes and save its
weights (port of hgr_tpu/tools/train_detector_smoke.py).

Each scene is a textured background with one synthetic hand crop pasted
at a random box (``make_scene``), sometimes with letterbox bars or shrunk
onto 114 gray as the serving letterbox shrinks a wide frame. The tool
trains the detector from scratch on a pool of such batches (bf16, train-
mode BatchNorm, ``models/yolo_loss.py``, Adam), reports the best-box IoU
on fresh scenes and writes the variables as the JAX tool does: an .npz of
float16 arrays under Flax paths (``params/stem1/conv/kernel``,
``batch_stats/stem1/bn/mean``, ...), which ``infer/weights.py:
load_detector_weights`` and the JAX package's ``load_npz_weights`` read.

    python -m hgr_tpu_torch.tools.train_detector_smoke [--steps 800]
        [--out build/detector_smoke/yolo_smoke_weights.npz] [--device cpu]

Runs on the card unless ``--device cpu``. Scene generation is numpy: the
area downscale is a copy of OpenCV's ``INTER_AREA`` (``area_resize_u8``),
so the port needs no cv2, and the RandomState draws are those of the JAX
tool, scene for scene.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "detector_smoke",
                           "yolo_smoke_weights.npz")


def _area_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's area-resize table (computeResizeAreaTab) for a downscale
    src -> dst: per output index, its source indices and float32 weights
    in the order OpenCV sums them (a fractional first cell, whole cells, a
    fractional last cell), zero-padded to one width."""
    scale = src / dst
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wts = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, w) in enumerate(taps):
            idx[d, j], wts[d, j] = s, w
    return idx, wts


def area_resize_u8(img: np.ndarray, new: int) -> np.ndarray:
    """(H, W, C) uint8 -> (new, new, C) by area averaging, as
    ``cv2.resize(img, (new, new), interpolation=cv2.INTER_AREA)`` computes
    a downscale: each output pixel is the mean over its source area with
    fractional edge weights, summed in float32 in OpenCV's order
    (horizontal, then vertical) and rounded half to even."""
    iy, wy = _area_taps(img.shape[0], new)
    ix, wx = _area_taps(img.shape[1], new)
    src = img.astype(np.float32)
    rows = np.zeros((img.shape[0], new, img.shape[2]), np.float32)
    for j in range(ix.shape[1]):
        rows += src[:, ix[:, j]] * wx[:, j][None, :, None]
    out = np.zeros((new, new, img.shape[2]), np.float32)
    for j in range(iy.shape[1]):
        out += rows[iy[:, j]] * wy[:, j][:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def make_scene(rng: np.random.RandomState, size: int = 416,
               pad_prob: float = 0.3, shrink_prob: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic frame: (uint8 (size, size, 3) BGR, gt (4,) [cx, cy,
    w, h] pixels). ``pad_prob`` adds 114-gray letterbox bars,
    ``shrink_prob`` shrinks the composed scene by f in [0.55, 0.95] onto
    114 gray, as the serving letterbox shrinks a wide frame."""
    from hgr_tpu_torch.data.synthetic import make_hand_image

    frame = np.empty((size, size, 3), np.uint8)
    base = rng.randint(30, 160, 3)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(3):
        frame[..., c] = np.clip(
            base[c] + 50 * yy * rng.rand() + 50 * xx * rng.rand()
            + rng.randn(size, size) * 8, 0, 255).astype(np.uint8)

    if rng.rand() < pad_prob:
        bar = rng.randint(20, 80)
        if rng.rand() < 0.5:
            frame[:bar] = 114
            frame[-bar:] = 114
        else:
            frame[:, :bar] = 114
            frame[:, -bar:] = 114

    hand_size = rng.randint(80, 221)
    crop, _ = make_hand_image(rng, size=hand_size)
    x0 = rng.randint(0, size - hand_size + 1)
    y0 = rng.randint(0, size - hand_size + 1)
    frame[y0:y0 + hand_size, x0:x0 + hand_size] = crop
    gt = np.array([x0 + hand_size / 2.0, y0 + hand_size / 2.0,
                   float(hand_size), float(hand_size)], np.float32)

    if rng.rand() < shrink_prob:
        f = rng.uniform(0.55, 0.95)
        new = max(32, int(round(size * f)))
        small = area_resize_u8(frame, new)
        off = (size - new) // 2
        frame = np.full((size, size, 3), 114, np.uint8)
        frame[off:off + new, off:off + new] = small
        scale = new / float(size)
        gt = np.array([gt[0] * scale + off, gt[1] * scale + off,
                       gt[2] * scale, gt[3] * scale], np.float32)
    return frame, gt


def make_batch(rng: np.random.RandomState, batch: int, size: int = 416
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``batch`` scenes: (frames (B, size, size, 3) uint8, gts (B, 4))."""
    frames = np.empty((batch, size, size, 3), np.uint8)
    gts = np.empty((batch, 4), np.float32)
    for i in range(batch):
        frames[i], gts[i] = make_scene(rng, size)
    return frames, gts


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise IoU of [x0, y0, x1, y1] boxes."""
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def cxcywh_to_xyxy(gts: np.ndarray) -> np.ndarray:
    return np.stack([gts[:, 0] - gts[:, 2] / 2, gts[:, 1] - gts[:, 3] / 2,
                     gts[:, 0] + gts[:, 2] / 2, gts[:, 1] + gts[:, 3] / 2],
                    axis=-1)


def adam(params, lr: float) -> torch.optim.Optimizer:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the root, no
    weight decay."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_detector_train_step(model, optimizer) -> Callable:
    """``step(frames_u8, gt) -> (total, parts)``: uint8 (B, S, S, 3) frames
    on the model's device -> f32/255 -> train-mode forward (the model's
    dtype) -> ``yolo_single_box_loss`` -> backward -> optimizer update.
    The BatchNorm running statistics update in the forward. Losses stay on
    the device."""
    from hgr_tpu_torch.models.yolo_loss import yolo_single_box_loss
    from hgr_tpu_torch.ops.color import true_divide

    def step(frames_u8: torch.Tensor, gt: torch.Tensor):
        model.train()
        x = true_divide(frames_u8.float(), 255.0)
        total, parts = yolo_single_box_loss(model(x), gt)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def detector_loss_and_grads(model, frames_u8: torch.Tensor,
                            gt: torch.Tensor):
    """One train-mode forward and backward without an update: (total,
    parts, {parameter name: gradient}); the BatchNorm running statistics
    update as in a step. For holding a step on one device against the
    same step on another."""
    from hgr_tpu_torch.models.yolo_loss import yolo_single_box_loss
    from hgr_tpu_torch.ops.color import true_divide

    model.train()
    names, params = zip(*model.named_parameters())
    total, parts = yolo_single_box_loss(
        model(true_divide(frames_u8.float(), 255.0)), gt)
    grads = torch.autograd.grad(total, params)
    return (total.detach(), {k: v.detach() for k, v in parts.items()},
            dict(zip(names, grads)))


@torch.no_grad()
def best_boxes(model, frames_u8: torch.Tensor
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Eval-mode best box per frame: (boxes (B, 4) xyxy, scores (B,))."""
    from hgr_tpu_torch.models.yolo import best_box, decode_predictions
    from hgr_tpu_torch.ops.color import true_divide

    model.eval()
    x = true_divide(frames_u8.float(), 255.0)
    boxes, scores = best_box(decode_predictions(model(x), num_classes=1))
    return boxes.float().cpu().numpy(), scores.float().cpu().numpy()


def save_detector_npz(model, path: str) -> None:
    """Write the model's variables as the JAX tool saves them: float16
    arrays under 'params/...' and 'batch_stats/...' Flax paths, one
    compressed .npz."""
    from hgr_tpu_torch.utils.convert import to_flax

    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v).astype(np.float16)

    tree = to_flax(model.state_dict())
    for coll in ("params", "batch_stats"):
        walk(tree[coll], coll)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--unique_batches", type=int, default=250,
                   help="pre-generated batches cycled during training")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda "
                        "raises instead of running on the CPU")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, evaluate and save as the flags say. Returns the model, the
    losses, the eval IoUs and scores, the path written, the seconds the
    scene pool took and the milliseconds a step (host clock over the
    steps, up to the last loss read back)."""
    from hgr_tpu_torch.models.yolo import YOLOv7Tiny
    from hgr_tpu_torch.train.state import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).train()
    step = make_detector_train_step(model, adam(model.parameters(), args.lr))
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    pool = [make_batch(rng, args.batch, args.size)
            for _ in range(min(args.unique_batches, args.steps))]
    pool = [(torch.from_numpy(f).to(device), torch.from_numpy(g).to(device))
            for f, g in pool]
    pool_s = time.time() - t0
    print(f"scene pool: {len(pool)} batches in {pool_s:.0f}s", flush=True)
    losses = []
    t1 = time.perf_counter()
    for i in range(args.steps):
        total, parts = step(*pool[i % len(pool)])
        losses.append(total)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(total):.4f} "
                  f"box={float(parts['box']):.4f} "
                  f"obj={float(parts['obj']):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    losses = [float(x) for x in losses]  # waits for the last step
    step_ms = (time.perf_counter() - t1) / args.steps * 1e3
    print(f"{args.steps} steps: {step_ms:.1f} ms a step", flush=True)
    frames, gts = make_batch(np.random.RandomState(args.seed + 999),
                             args.eval_n, args.size)
    boxes, scores = best_boxes(model, torch.from_numpy(frames).to(device))
    ious = iou_xyxy(boxes, cxcywh_to_xyxy(gts))
    print(f"eval: mean IoU={ious.mean():.3f} "
          f"IoU>0.5 frac={float((ious > 0.5).mean()):.3f} "
          f"mean score={scores.mean():.3f}", flush=True)
    save_detector_npz(model, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)",
          flush=True)
    return {"model": model, "losses": losses, "ious": ious,
            "scores": scores, "out": args.out, "pool_seconds": pool_s,
            "ms_per_step": step_ms}


if __name__ == "__main__":
    main()
