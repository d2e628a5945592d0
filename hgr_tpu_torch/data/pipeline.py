"""Device-side augmentation and preprocessing of staged batches (port of
hgr_tpu/data/pipeline.py:127-322; reference libs/load.py:52-146).

The host stages each decoded image into a square uint8 canvas with its
orig->canvas affine (``stage_image``, numpy, bit for bit the JAX
package's; the window it keeps comes from ``staging_window_fraction``).
On the device, one batched function draws the augment
parameters (``draw_augment_params``, from a ``torch.Generator``), folds
flip and crop geometry into one affine, applies the HSV jitter and the
warp, rounds as cv2's uint8 warp does, normalizes, moves the joints into
crop space and renders the Gaussian targets (``apply_augment_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.ops.affine import (
    build_affine,
    compose_affine,
    invert_affine,
    transform_points,
)
from hgr_tpu_torch.ops.color import hsv_jitter, normalize_imagenet
from hgr_tpu_torch.ops.heatmap import generate_targets
from hgr_tpu_torch.ops.warp import batched_affine_warp
from hgr_tpu_torch.ops.warp_fused import warp_twopass

WARP_METHODS = ("auto", "exact", "kernel")


def staging_window_fraction(aug: AugmentConfig,
                            crop_size_factor: float = 0.35) -> float:
    """Fraction of max(h, w) the augmented crop can ever sample from
    (hgr_tpu/data/pipeline.py:51): twice the worst reach from the image
    center, 2·tf (translate) + csf·(1 + sf)·√2/2 (the crop's half
    diagonal at 45°), at most 1. The defaults give 0.748."""
    reach = (2.0 * aug.translate_factor
             + crop_size_factor * (1.0 + aug.scale_factor)
             * float(np.sqrt(2.0)) / 2.0)
    return float(min(1.0, 2.0 * reach))


def stage_image(img: np.ndarray, canvas_size: int, window_frac: float = 0.75
                ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Stage a decoded (H, W, 3) uint8 image into a square canvas
    (hgr_tpu/data/pipeline.py:70): keep the central ``window_frac ·
    max(h, w)`` window, downscale it only when it exceeds the canvas, and
    place it at the top-left. Returns (canvas uint8, orig->canvas affine
    (2, 3) float32, (orig_h, orig_w))."""
    h, w = img.shape[:2]
    win = int(np.ceil(window_frac * max(h, w)))
    cx, cy = w / 2.0, h / 2.0
    x0 = max(0, int(np.floor(cx - win / 2.0)))
    y0 = max(0, int(np.floor(cy - win / 2.0)))
    x1 = min(w, x0 + win)
    y1 = min(h, y0 + win)
    window = img[y0:y1, x0:x1]
    wh, ww = window.shape[:2]

    scale = 1.0
    if max(wh, ww) > canvas_size:
        scale = canvas_size / max(wh, ww)
        new_w = max(1, int(round(ww * scale)))
        new_h = max(1, int(round(wh * scale)))
        window = _host_resize(window, (new_h, new_w))
        wh, ww = window.shape[:2]

    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    canvas[:wh, :ww] = window[:, :, :3]
    a = np.array(
        [[scale, 0.0, -x0 * scale], [0.0, scale, -y0 * scale]], np.float32)
    return canvas, a, (h, w)


def _linear_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """First source index and float32 fraction of each output position,
    with half-pixel centres, as cv2's resize computes them: the position
    in double, rounded to float32, floored."""
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    return i0, pos - i0.astype(np.float32)


def _fixed_weights(frac: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The two taps' 11-bit fixed-point weights, each rounded on its own."""
    one = np.float32(1 << 11)
    return (np.rint((np.float32(1.0) - frac) * one).astype(np.int32),
            np.rint(frac * one).astype(np.int32))


def _host_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8 image, bit for bit what
    ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` gives, which the
    JAX package calls where cv2 imports (pipeline.py:107-113); cv2 stays
    off the port. cv2 (imgproc/src/resize.cpp) blends each row's two
    columns in integers with 11-bit weights (edges clamped to one column),
    then two rows with 11-bit weights, rounding as its vector path does:
    ``((b0·(S0 >> 4)) >> 16) + ((b1·(S1 >> 4)) >> 16)``, plus 2, >> 2."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    sx, fx = _linear_taps(ow, w)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _fixed_weights(fx)
    sy, fy = _linear_taps(oh, h)
    b0, b1 = _fixed_weights(fy)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    rows, inv = np.unique(np.concatenate([r0, r1]), return_inverse=True)
    src = img[rows]
    cols = (src[:, sx].astype(np.int32) * a0[None, :, None]
            + src[:, np.minimum(sx + 1, w - 1)].astype(np.int32)
            * a1[None, :, None]) >> 4
    s0, s1 = cols[inv[:oh]], cols[inv[oh:]]
    out = (((b0[:, None, None] * s0) >> 16) + ((b1[:, None, None] * s1) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class AugmentParams:
    """Per-sample augment draw; every field leads with the batch B."""

    scale: torch.Tensor  # (B,)
    rot: torch.Tensor  # (B,) degrees
    translate: torch.Tensor  # (B, 2) additive center shift in pixels
    flip: torch.Tensor  # (B,) {0., 1.}
    jitter_gains: torch.Tensor  # (B, 3); 1.0 == no-op
    do_jitter: torch.Tensor  # (B,) {0., 1.}


def draw_augment_params(generator: torch.Generator, batch: int,
                        sizes_hw: torch.Tensor,
                        cfg: AugmentConfig) -> AugmentParams:
    """Sample the reference's augment distributions (libs/load.py:116-133)
    on the generator's device:

      s  = clip(N(1, sf), 1-sf, 1+sf)
      r  = clip(N(0, rf), -2rf, 2rf) with prob 0.6, else 0
      dc = [w, h] * clip(N(0, tf), -2tf, 2tf) with prob 0.5
      flip with prob 0.5; HSV jitter with prob 0.5, gains U(-1, 1)·g + 1
    """
    dev = generator.device
    sf, rf, tf = cfg.scale_factor, cfg.rotate_factor, cfg.translate_factor

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    scale = torch.clamp(normal(batch) * sf + 1.0, 1.0 - sf, 1.0 + sf)
    rot_raw = torch.clamp(normal(batch) * rf, -2.0 * rf, 2.0 * rf)
    rot = torch.where(uniform(batch) <= 0.6, rot_raw,
                      torch.zeros_like(rot_raw))
    t_raw = torch.clamp(normal(batch, 2) * tf, -2.0 * tf, 2.0 * tf)
    do_t = (uniform(batch) <= 0.5)[:, None]
    sizes_hw = sizes_hw.to(dev).float()
    wh = torch.stack([sizes_hw[:, 1], sizes_hw[:, 0]], dim=-1)
    translate = torch.where(do_t, t_raw * wh, torch.zeros_like(t_raw))
    flip = ((uniform(batch) <= 0.5) & cfg.horizontal_flip).float()
    hsv = torch.tensor([cfg.hsv_h, cfg.hsv_s, cfg.hsv_v], device=dev)
    gains_raw = (uniform(batch, 3) * 2.0 - 1.0) * hsv + 1.0
    do_jitter = ((uniform(batch) <= 0.5) & cfg.color_jittering).float()
    jitter_gains = torch.where(do_jitter[:, None] > 0, gains_raw,
                               torch.ones_like(gains_raw))
    return AugmentParams(scale=scale, rot=rot, translate=translate,
                         flip=flip, jitter_gains=jitter_gains,
                         do_jitter=do_jitter)


def identity_params(batch: int, device="cpu") -> AugmentParams:
    """Eval-time params: s=1, r=0, no translate, flip or jitter."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return AugmentParams(scale=full((batch,), 1.0), rot=full((batch,), 0.0),
                         translate=full((batch, 2), 0.0),
                         flip=full((batch,), 0.0),
                         jitter_gains=full((batch, 3), 1.0),
                         do_jitter=full((batch,), 0.0))


def auto_warp_method(device_type: str, canvas_shape: Tuple[int, ...]) -> str:
    """The warp 'auto' takes for a (B, S_h, S_w, 3) canvas on
    ``device_type``: the two-pass kernel on CUDA when the canvas is
    square (the kernel's layout), else the exact warp, as the JAX
    package's ``kernel_ok`` guard routes (pipeline.py:266-269)."""
    square = canvas_shape[1] == canvas_shape[2]
    return "kernel" if device_type == "cuda" and square else "exact"


def crop_affines(orig_to_canvas: torch.Tensor, sizes_hw: torch.Tensor,
                 params: AugmentParams,
                 image_size: Tuple[int, int] = (192, 192),
                 crop_size_factor: float = 0.35
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m_orig, m_canvas), each (B, 2, 3): the original image -> crop
    affines with the flip folded in, and the canvas -> crop affines the
    warp takes, for orig_to_canvas (B, 2, 3), sizes_hw (B, 2) (h, w) and
    the drawn params."""
    b = orig_to_canvas.shape[0]
    orig_to_canvas = orig_to_canvas.float()
    sizes_hw = sizes_hw.float()
    h, w = sizes_hw[:, 0], sizes_hw[:, 1]
    out_h, out_w = image_size

    # crop center and size (reference libs/load.py:69-70)
    center = torch.stack([w / 2.0, h / 2.0], dim=-1) + params.translate
    origin_size = torch.maximum(h, w) * crop_size_factor

    # the flip folded into the geometry: the reference flips pixels,
    # joints and center (libs/load.py:131-133); m_crop built from the
    # flipped center, composed with the mirror F: x -> w - 1 - x, acts on
    # the unflipped image
    flip = params.flip > 0
    center_f = torch.stack(
        [torch.where(flip, w - center[:, 0] - 1.0, center[:, 0]),
         center[:, 1]], dim=-1)
    m_crop = build_affine(center_f, params.scale, params.rot, origin_size,
                          (float(out_w), float(out_h)))
    f_mat = torch.zeros((b, 2, 3), dtype=torch.float32,
                        device=orig_to_canvas.device)
    f_mat[:, 0, 0] = torch.where(flip, -1.0, 1.0)
    f_mat[:, 0, 2] = torch.where(flip, w - 1.0, torch.zeros_like(w))
    f_mat[:, 1, 1] = 1.0
    m_orig = compose_affine(m_crop, f_mat)  # orig -> crop, flip folded
    return m_orig, compose_affine(m_orig, invert_affine(orig_to_canvas))


def apply_augment_batch(canvas: torch.Tensor, orig_to_canvas: torch.Tensor,
                        sizes_hw: torch.Tensor, joints: torch.Tensor,
                        joints_vis: torch.Tensor, params: AugmentParams,
                        image_size: Tuple[int, int] = (192, 192),
                        heatmap_size: Tuple[int, int] = (48, 48),
                        sigma: float = 2.0, crop_size_factor: float = 0.35,
                        normalize: bool = True, warp_method: str = "auto",
                        enable_jitter: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """The reference's __getitem__ transform, batched on the canvas's
    device. canvas (B, S, S, 3) uint8; orig_to_canvas (B, 2, 3); sizes_hw
    (B, 2) (h, w); joints (B, J, 2) in original pixels; joints_vis (B, J).

    ``warp_method``: 'auto' takes the fused jitter + warp kernel on CUDA
    for a square canvas and the exact 4-tap warp otherwise (as the JAX
    package routes, pipeline.py:266-269; ``auto_warp_method``); 'exact';
    'kernel' (``warp_twopass``: the kernel on CUDA, its plain version on
    the CPU; square canvases only).

    Returns image (B, H, W, 3) f32, target (B, J, Hh, Hw), target_weight
    (B, J) and joints (B, J, 2) in crop space.
    """
    if warp_method not in WARP_METHODS:
        raise ValueError(f"warp_method {warp_method!r} not in "
                         f"{WARP_METHODS}")
    dev = canvas.device
    out_h, out_w = image_size
    m_orig, m_canvas = crop_affines(orig_to_canvas, sizes_hw, params,
                                    image_size, crop_size_factor)

    if warp_method == "auto":
        warp_method = auto_warp_method(dev.type, tuple(canvas.shape))
    gains = params.jitter_gains if enable_jitter else None
    if warp_method == "kernel":
        crop = warp_twopass(canvas, m_canvas, (out_h, out_w),
                            jitter_gains=gains, do_jitter=params.do_jitter,
                            round_output=True)
    else:
        img = canvas.float()
        if enable_jitter:
            img = torch.where(params.do_jitter[:, None, None, None] > 0,
                              hsv_jitter(img, params.jitter_gains), img)
        crop = batched_affine_warp(img, m_canvas, (out_h, out_w))
        # cv2.warpAffine on uint8 rounds
        crop = torch.round(torch.clamp(crop, 0.0, 255.0))
    # the kernel's crop of a uint8 canvas is uint8; the image is f32, as
    # the JAX pipeline casts it (pipeline.py:293)
    crop = normalize_imagenet(crop) if normalize else crop.float()

    joints_crop = transform_points(joints, m_orig)
    target, target_weight = generate_targets(
        joints_crop, joints_vis, (out_w, out_h), heatmap_size, sigma)
    return {"image": crop, "target": target, "target_weight": target_weight,
            "joints": joints_crop}
