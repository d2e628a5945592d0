"""Debug visualization: image grids with joints and labels, heatmap
overlays, cls-token attention overlays (the port's copy of
hgr_tpu/utils/vis.py; reference libs/vis.py:12-205).

Runs off the hot path on host numpy: the inputs are the eval step's
outputs (``make_eval_step(return_outputs=True)``), NHWC images and NCHW
heatmaps, as numpy arrays or tensors on any device. cv2 draws, resizes
and writes when it imports (it is imported inside the functions, never
with the module), else the PIL and numpy fallbacks do.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from hgr_tpu_torch.ops.heatmap import get_max_preds
from hgr_tpu_torch.ops.resize import upsample_bilinear_align_corners
from hgr_tpu_torch.utils.draw import draw_joints


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as host numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _to_uint8_grid(images: np.ndarray, nrow: int = 8,
                   padding: int = 2) -> np.ndarray:
    """Tile (B, H, W, 3) [0, 1] images into a grid (torchvision's
    make_grid, reference libs/vis.py:22)."""
    b, h, w, c = images.shape
    xmaps = min(nrow, b)
    ymaps = int(math.ceil(b / xmaps))
    grid = np.zeros(
        (ymaps * (h + padding) + padding, xmaps * (w + padding) + padding, c),
        np.uint8)
    k = 0
    for y in range(ymaps):
        for x in range(xmaps):
            if k >= b:
                break
            img = np.clip(images[k] * 255.0, 0, 255).astype(np.uint8)
            y0 = y * (h + padding) + padding
            x0 = x * (w + padding) + padding
            grid[y0:y0 + h, x0:x0 + w] = img
            k += 1
    return grid


def _unnormalize(images: np.ndarray) -> np.ndarray:
    """ImageNet-normalized -> the [0, 1] range of the batch."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    x = images * std + mean
    mn, mx = float(x.min()), float(x.max())
    return (x - mn) / (mx - mn + 1e-5)


def _imwrite(path: str, img: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, img)
    except ImportError:
        from PIL import Image

        Image.fromarray(img[..., ::-1]).save(path)


def save_batch_image_with_joints(images: np.ndarray, labels: np.ndarray,
                                 joints: np.ndarray, joints_vis: np.ndarray,
                                 file_name: str, nrow: int = 8,
                                 padding: int = 2) -> None:
    """Grid of the (B, H, W, 3) normalized images with their visible
    (B, J, 2) joints and class labels (reference libs/vis.py:12-50)."""
    images, labels = _host(images), _host(labels)
    joints, joints_vis = _host(joints), _host(joints_vis)
    grid = _to_uint8_grid(_unnormalize(images), nrow, padding).copy()
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    xmaps = min(nrow, b)
    for k in range(b):
        y, x = divmod(k, xmaps)
        cx = x * (w + padding) + padding
        cy = y * (h + padding) + padding
        pts = joints[k] + np.array([cx, cy])
        vis_pts = pts[joints_vis[k] > 0].astype(int)
        draw_joints(grid, vis_pts)
        _put_text(grid, str(int(labels[k])), (cx, cy + 25))
    _imwrite(file_name, grid)


def save_batch_heatmaps(images: np.ndarray, heatmaps: np.ndarray,
                        file_name: str) -> None:
    """Per-joint heatmap overlays, one row per image: the image at
    heatmap size, then each (J, Hh, Hw) joint's jet map blended 0.7/0.3
    with its peak marked (reference libs/vis.py:53-113)."""
    images, heatmaps = _host(images), _host(heatmaps)
    b, j = heatmaps.shape[:2]
    hh, hw = heatmaps.shape[2], heatmaps.shape[3]
    imgs = _unnormalize(images)
    preds = get_max_preds(torch.from_numpy(
        np.ascontiguousarray(heatmaps, np.float32)))[0].numpy()
    grid = np.zeros((b * hh, (j + 1) * hw, 3), np.uint8)
    for i in range(b):
        small = _resize_u8(
            np.clip(imgs[i] * 255, 0, 255).astype(np.uint8), (hh, hw))
        row0 = i * hh
        grid[row0:row0 + hh, 0:hw] = small
        for jj in range(j):
            hm = np.clip(heatmaps[i, jj] * 255, 0, 255).astype(np.uint8)
            overlay = (_colormap_jet(hm) * 0.7 + small * 0.3).astype(np.uint8)
            px, py = int(preds[i, jj, 0]), int(preds[i, jj, 1])
            overlay[max(0, py - 1):py + 2, max(0, px - 1):px + 2] = (0, 0, 255)
            c0 = (jj + 1) * hw
            grid[row0:row0 + hh, c0:c0 + hw] = overlay
    _imwrite(file_name, grid)


def attention_levels(attnmap: np.ndarray) -> np.ndarray:
    """The cls token's attention over the patches as uint8 levels
    (B, 4f, 4f): the head mean of the (B, heads, N, N) map, row 0 over
    tokens 1.., on the f x f feature grid, upsampled x4 (align corners,
    f32) and normalized per image (reference libs/vis.py:116-184)."""
    attnmap = _host(attnmap)
    b = attnmap.shape[0]
    feat = int(round(math.sqrt(attnmap.shape[-1] - 1)))
    cls_attn = attnmap.mean(axis=1)[:, 0, 1:].reshape(b, feat, feat)
    up = upsample_bilinear_align_corners(
        torch.from_numpy(np.ascontiguousarray(cls_attn, np.float32))[
            ..., None], 4)[..., 0].numpy()
    lo = up.min(axis=(1, 2), keepdims=True)
    hi = up.max(axis=(1, 2), keepdims=True)
    return ((up - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)


def save_batch_attention_map(images: np.ndarray, attnmap: np.ndarray,
                             file_name: str) -> None:
    """``attention_levels`` jet-colored and blended 0.5/0.5 over each
    image, the images side by side."""
    images = _host(images)
    levels = attention_levels(attnmap)
    imgs = _unnormalize(images)
    rows = []
    for i in range(images.shape[0]):
        base = _resize_u8(np.clip(imgs[i] * 255, 0, 255).astype(np.uint8),
                          levels.shape[1:])
        heat = _colormap_jet(levels[i])
        rows.append((base * 0.5 + heat * 0.5).astype(np.uint8))
    _imwrite(file_name, np.concatenate(rows, axis=1))


def save_debug_images(outputs: Dict, prefix: str,
                      with_attention: bool = False) -> None:
    """The reference's dump (libs/vis.py:187-205): ``<prefix>_gt.jpg`` and
    ``_pred.jpg`` (joints and labels), ``_hm_gt.jpg`` and ``_hm_pred.jpg``
    (heatmap strips), and with ``with_attention`` and a map
    ``_attn.jpg``."""
    images = _host(outputs["image"])
    weight = _host(outputs["target_weight"])
    save_batch_image_with_joints(images, _host(outputs["label"]),
                                 _host(outputs["joints"]), weight,
                                 f"{prefix}_gt.jpg")
    heatmap = _host(outputs["heatmap"])
    pred_joints = get_max_preds(torch.from_numpy(
        np.ascontiguousarray(heatmap, np.float32)))[0].numpy()
    save_batch_image_with_joints(images, _host(outputs["pred_label"]),
                                 pred_joints * 4.0, weight,
                                 f"{prefix}_pred.jpg")
    save_batch_heatmaps(images, _host(outputs["target"]),
                        f"{prefix}_hm_gt.jpg")
    save_batch_heatmaps(images, heatmap, f"{prefix}_hm_pred.jpg")
    if with_attention and outputs.get("attnmap") is not None:
        save_batch_attention_map(images, _host(outputs["attnmap"]),
                                 f"{prefix}_attn.jpg")


def _resize_u8(img: np.ndarray, out_hw) -> np.ndarray:
    try:
        import cv2

        return cv2.resize(img, (out_hw[1], out_hw[0]))
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize(
            (out_hw[1], out_hw[0])))


@functools.lru_cache(maxsize=1)
def _jet_lut():
    """cv2's jet colormap as a (256, 3) BGR table (None without cv2)."""
    try:
        import cv2
    except ImportError:
        return None
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    return cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[:, 0]


def _colormap_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 grayscale -> BGR jet colormap: cv2's table, looked up. One
    ``cv2.applyColorMap`` call took ~12 ms with cv2 4.13 on an H100
    host, and a B = 256 dump colors ~11,000 small maps."""
    lut = _jet_lut()
    if lut is not None:
        return lut[gray]
    g = gray.astype(np.float32) / 255.0
    r = np.clip(1.5 - np.abs(4 * g - 3), 0, 1)
    gg = np.clip(1.5 - np.abs(4 * g - 2), 0, 1)
    bb = np.clip(1.5 - np.abs(4 * g - 1), 0, 1)
    return (np.stack([bb, gg, r], -1) * 255).astype(np.uint8)


def _put_text(img: np.ndarray, text: str, org) -> None:
    try:
        import cv2

        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1,
                    (255, 0, 0), 2)
    except ImportError:
        pass
