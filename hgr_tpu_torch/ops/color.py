"""Color ops: cv2-convention 8-bit HSV jitter and ImageNet normalization
(port of hgr_tpu/ops/color.py; reference libs/augmentations.py:22-45,
libs/load.py:46-50).

The jitter works on float images holding 0-255 values: BGR -> HSV in
cv2's 8-bit conventions (H in [0, 180), S and V in [0, 255]), the stored
HSV rounded as cv2 rounds to uint8, the gains applied with the uint8
LUT's floor, then HSV -> BGR, rounded and clipped to [0, 255].
``jitter_bgr_planes`` is the same arithmetic on three channel planes; the
warp kernel's plain version (ops/warp_fused.py) reuses it, and the CUDA
kernel repeats it op for op.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded on every device. PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can round one ulp
    apart (and move the HSV LUT's floor by a level); a 0-dim tensor on
    x's device takes the true division, as the CPU, JAX and the CUDA
    kernel divide."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _hsv_planes(b, g, r) -> Planes:
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    # sector formulas of cv2's 8-bit conversion (H in half-degrees)
    h_r = 30.0 * (g - b) / safe_c
    h_g = 60.0 + 30.0 * (b - r) / safe_c
    h_b = 120.0 + 30.0 * (r - g) / safe_c
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(c > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v > 0, 255.0 * c / torch.where(v > 0, v,
                                                    torch.ones_like(v)),
                    torch.zeros_like(v))
    return h, s, v


def _bgr_planes(h, s, v) -> Planes:
    h_deg = h * 2.0  # [0, 360)
    s01 = true_divide(s, 255.0)
    c = v * s01
    hp = true_divide(h_deg, 60.0)
    # hp >= 0, so fmod is the floor-mod of the JAX code
    x = c * (1.0 - torch.abs(torch.fmod(hp, 2.0) - 1.0))
    m = v - c
    sector = torch.floor(hp).to(torch.int32) % 6
    zero = torch.zeros_like(c)

    def pick(v0, v1, v2, v3, v4, v5):
        return torch.where(sector == 0, v0, torch.where(
            sector == 1, v1, torch.where(sector == 2, v2, torch.where(
                sector == 3, v3, torch.where(sector == 4, v4, v5)))))

    r2 = pick(c, x, zero, zero, x, c)
    g2 = pick(x, c, c, x, zero, zero)
    b2 = pick(zero, zero, x, c, c, x)
    return b2 + m, g2 + m, r2 + m


def bgr_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR in [0, 255] -> (..., 3) HSV, float and unrounded."""
    return torch.stack(_hsv_planes(img[..., 0], img[..., 1], img[..., 2]),
                       dim=-1)


def hsv_to_bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) cv2-convention HSV -> (..., 3) BGR, float."""
    return torch.stack(_bgr_planes(hsv[..., 0], hsv[..., 1], hsv[..., 2]),
                       dim=-1)


def jitter_bgr_planes(b, g, r, gh, gs, gv) -> Planes:
    """HSV LUT jitter of three broadcastable f32 BGR planes with gains
    (gh, gs, gv) broadcastable against them; returns rounded 0-255
    planes."""
    h, s, v = _hsv_planes(b, g, r)
    # cv2 stores HSV as rounded uint8; the LUT scales and truncates
    h = torch.floor(torch.fmod(torch.round(h) * gh, 180.0))
    s = torch.floor(torch.clamp(torch.round(s) * gs, 0.0, 255.0))
    v = torch.floor(torch.clamp(torch.round(v) * gv, 0.0, 255.0))
    return tuple(torch.round(torch.clamp(t, 0.0, 255.0))
                 for t in _bgr_planes(h, s, v))


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR float in [0, 255] with per-image gains (B, 3) ->
    the jittered image, float in [0, 255]."""
    gh, gs, gv = (gains[..., i, None, None].float() for i in range(3))
    img = img.float()
    return torch.stack(jitter_bgr_planes(img[..., 0], img[..., 1],
                                         img[..., 2], gh, gs, gv), dim=-1)


def normalize_imagenet(img: torch.Tensor,
                       mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """0-255 (..., 3) -> float32 (x / 255 - mean) / std, with the
    RGB-ordered stats applied to BGR channels as the reference does."""
    img = true_divide(img.float(), 255.0)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - mean_t) / std_t
