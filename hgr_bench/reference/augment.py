"""The training augment, plain (reference libs/load.py:52-146,
libs/augmentations.py:22-45, libs/transforms.py:5-60): the draw of the
augment parameters, the crop geometry with the flip folded in, the 8-bit
HSV jitter, the two-pass affine warp of the uint8 canvas rounded as
cv2's uint8 warp rounds, the ImageNet normalize (RGB statistics on BGR
channels, as the reference), the joints moved into the crop and their
Gaussian heatmap targets.

The draw replays a ``torch.Generator`` in the order the training step
draws (each call's shape and distribution), so the same generator state
gives the same parameters on both sides.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def draw(gen: torch.Generator, b: int, sizes_hw: torch.Tensor,
         aug: Dict) -> Dict[str, torch.Tensor]:
    """scale ~ clip(N(1, sf)); rot ~ clip(N(0, rf)) with p 0.6; shift ~
    [w, h]·clip(N(0, tf)) with p 0.5; flip p 0.5; HSV gains
    U(-1, 1)·g + 1 with p 0.5."""
    dev = gen.device
    sf, rf, tf = aug["scale_factor"], aug["rotate_factor"], \
        aug["translate_factor"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    scale = torch.clamp(normal(b) * sf + 1.0, 1.0 - sf, 1.0 + sf)
    rot_raw = torch.clamp(normal(b) * rf, -2.0 * rf, 2.0 * rf)
    rot = torch.where(uniform(b) <= 0.6, rot_raw, torch.zeros_like(rot_raw))
    t_raw = torch.clamp(normal(b, 2) * tf, -2.0 * tf, 2.0 * tf)
    do_t = (uniform(b) <= 0.5)[:, None]
    wh = sizes_hw.float().flip(-1).to(dev)
    shift = torch.where(do_t, t_raw * wh, torch.zeros_like(t_raw))
    flip = ((uniform(b) <= 0.5) & aug["horizontal_flip"]).float()
    hsv = torch.tensor([aug["hsv_h"], aug["hsv_s"], aug["hsv_v"]],
                       device=dev)
    gains = (uniform(b, 3) * 2.0 - 1.0) * hsv + 1.0
    jit = ((uniform(b) <= 0.5) & aug["color_jittering"]).float()
    gains = torch.where(jit[:, None] > 0, gains, torch.ones_like(gains))
    return {"scale": scale, "rot": rot, "shift": shift, "flip": flip,
            "gains": gains, "jitter": jit}


def _affine(a, b, c, d, e, f):
    """(B, 2, 3) from six (B,) entries, row-major."""
    return torch.stack([torch.stack([a, b, c], -1),
                        torch.stack([d, e, f], -1)], -2)


def _inverse(m):
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    return _affine(ia, ib, -(ia * c + ib * f), id_, ie, -(id_ * c + ie * f))


def _compose(m2, m1):
    """x -> m2(m1(x))."""
    lin = m2[:, :, :2] @ m1[:, :, :2]
    off = (m2[:, :, :2] @ m1[:, :, 2:])[..., 0] + m2[:, :, 2]
    return torch.cat([lin, off[..., None]], -1)


def _solve(src, dst):
    """The affine taking three points to three (cv2.getAffineTransform):
    (A⁻¹ dst)ᵀ with A = [[x, y, 1]]."""
    a = torch.cat([src, torch.ones_like(src[..., :1])], -1)
    return torch.linalg.solve(a, dst).transpose(-1, -2)


def _third(a, b):
    d = a - b
    return b + torch.stack([-d[..., 1], d[..., 0]], -1)


def crop_affines(o2c, sizes_hw, p, out_hw, csf: float = 0.35):
    """(orig -> crop, canvas -> crop) affines (reference
    libs/transforms.py:20-54): the crop of side max(h, w)·csf·scale
    around the (shifted, flipped) centre, rotated by rot, onto the
    out_h x out_w output, from three point pairs; the mirror
    x -> w - 1 - x is applied first where flipped."""
    h, w = sizes_hw[:, 0].float(), sizes_hw[:, 1].float()
    out_h, out_w = out_hw
    cx = w / 2.0 + p["shift"][:, 0]
    cy = h / 2.0 + p["shift"][:, 1]
    flip = p["flip"] > 0
    cx = torch.where(flip, w - cx - 1.0, cx)
    side = torch.maximum(h, w) * csf * p["scale"]
    rot = math.pi * p["rot"] / 180.0
    half = side * -0.5
    src0 = torch.stack([cx, cy], -1)
    src1 = src0 + torch.stack([-half * torch.sin(rot), half * torch.cos(rot)],
                              -1)
    dst0 = torch.tensor([out_w * 0.5, out_h * 0.5], device=w.device
                        ).expand_as(src0)
    dst1 = dst0 + torch.tensor([0.0, out_w * -0.5], device=w.device)
    src = torch.stack([src0, src1, _third(src0, src1)], -2)
    dst = torch.stack([dst0, dst1, _third(dst0, dst1)], -2)
    m_crop = _solve(src, dst)
    one, zero = torch.ones_like(w), torch.zeros_like(w)
    mirror = _affine(torch.where(flip, -one, one), zero,
                     torch.where(flip, w - 1.0, zero), zero, one, zero)
    m_orig = _compose(m_crop, mirror)
    return m_orig, _compose(m_orig, _inverse(o2c.float()))


def _hsv(b, g, r):
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    cs = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, 30.0 * (g - b) / cs,
                    torch.where(v == g, 60.0 + 30.0 * (b - r) / cs,
                                120.0 + 30.0 * (r - g) / cs))
    h = torch.where(c > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v > 0, 255.0 * c / torch.where(v > 0, v,
                                                    torch.ones_like(v)),
                    torch.zeros_like(v))
    return h, s, v


def _bgr(h, s, v):
    c = v * (s / 255.0)
    hp = h * 2.0 / 60.0
    x = c * (1.0 - torch.abs(torch.fmod(hp, 2.0) - 1.0))
    m = v - c
    sec = torch.floor(hp).long() % 6
    z = torch.zeros_like(c)
    r = torch.stack([c, x, z, z, x, c])
    g = torch.stack([x, c, c, x, z, z])
    b = torch.stack([z, z, x, c, c, x])
    pick = sec[None]
    return tuple(torch.gather(t, 0, pick)[0] + m for t in (b, g, r))


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR 0-255 float -> jittered, rounded: cv2's 8-bit HSV
    (H in half degrees) stored rounded, scaled by the gains through a
    truncating LUT, converted back."""
    g = [gains[:, i, None, None].float() for i in range(3)]
    h, s, v = _hsv(img[..., 0], img[..., 1], img[..., 2])
    h = torch.floor(torch.fmod(torch.round(h) * g[0], 180.0))
    s = torch.floor(torch.clamp(torch.round(s) * g[1], 0.0, 255.0))
    v = torch.floor(torch.clamp(torch.round(v) * g[2], 0.0, 255.0))
    return torch.stack([torch.round(torch.clamp(t, 0.0, 255.0))
                        for t in _bgr(h, s, v)], -1)


def twopass_warp(img: torch.Tensor, m: torch.Tensor, out_h: int,
                 out_w: int) -> torch.Tensor:
    """Resample square (B, S, S, 3) float canvases through canvas -> crop
    affines by two linear passes: along source rows at x = α·x' + β·k + γ
    (k a source row), then across the two rows around y = s·x' + t·y' + u
    of the inverse map; near-vertical maps (|t| < |s|) swap the canvas's
    axes. Taps clamp into the canvas, and outputs whose exact inverse
    lands outside (-1, S) on either axis are 0."""
    b, s_dim = img.shape[0], img.shape[1]
    inv = _inverse(m.float())
    p_, q_, r_ = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    s_, t_, u_ = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    swap = torch.abs(t_) < torch.abs(s_)
    p, q, r = (torch.where(swap, a, c) for a, c in ((s_, p_), (t_, q_),
                                                   (u_, r_)))
    s2, t2, u2 = (torch.where(swap, a, c) for a, c in ((p_, s_), (q_, t_),
                                                      (r_, u_)))
    t2s = torch.where(torch.abs(t2) < 1e-6, torch.full_like(t2, 1e-6), t2)
    alpha, beta, gamma = p - q * s2 / t2s, q / t2s, r - q * u2 / t2s
    dev = img.device
    yp, xp = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")

    def col(t):
        return t[:, None, None]

    flat = img.reshape(b, s_dim * s_dim, 3)
    rs = torch.where(swap, 1, s_dim)[:, None, None]
    cs = torch.where(swap, s_dim, 1)[:, None, None]

    def taps(pos):
        i0 = torch.clamp(torch.floor(pos), 0, s_dim - 1)
        fr = torch.clamp(pos - i0, 0.0, 1.0)[..., None]
        i0 = i0.long()
        return i0, torch.clamp(i0 + 1, max=s_dim - 1), fr

    def read(k, x):
        idx = (k * rs + x * cs).reshape(b, -1, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(b, out_h, out_w, 3)

    def row(k):
        x0, x1, fx = taps(col(alpha) * xp + col(beta) * k.float()
                          + col(gamma))
        return read(k, x0) * (1.0 - fx) + read(k, x1) * fx

    y0, y1, fy = taps(col(s2) * xp + col(t2) * yp + col(u2))
    out = row(y0) * (1.0 - fy) + row(y1) * fy
    sx = col(p_) * xp + col(q_) * yp + col(r_)
    sy = col(s_) * xp + col(t_) * yp + col(u_)
    inside = (sx > -1.0) & (sx < s_dim) & (sy > -1.0) & (sy < s_dim)
    return out * inside[..., None].float()


def targets(joints, vis, image_wh, hm_wh, sigma):
    """Gaussian heatmaps (B, J, Hh, Hw) of peak 1 and std sigma within a
    (6σ+1)² box around each joint quantized to the heatmap, and weights
    (B, J): 0 where invisible or the box misses the map."""
    img_w, img_h = image_wh
    hm_w, hm_h = hm_wh
    mu_x = torch.trunc(joints[..., 0] / (img_w / hm_w) + 0.5)
    mu_y = torch.trunc(joints[..., 1] / (img_h / hm_h) + 0.5)
    r = sigma * 3.0
    ul_x, ul_y = torch.trunc(mu_x - r), torch.trunc(mu_y - r)
    br_x, br_y = torch.trunc(mu_x + r + 1.0), torch.trunc(mu_y + r + 1.0)
    miss = (ul_x >= hm_w) | (ul_y >= hm_h) | (br_x < 0) | (br_y < 0)
    weight = torch.where(miss, torch.zeros_like(vis), vis.float())
    xs = torch.arange(hm_w, dtype=torch.float32, device=joints.device)
    ys = torch.arange(hm_h, dtype=torch.float32, device=joints.device)
    dx = xs - mu_x[..., None]
    dy = ys - mu_y[..., None]
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2)
                  / (2.0 * sigma ** 2))
    box = (((xs >= ul_x[..., None]) & (xs < br_x[..., None]))[..., None, :]
           & ((ys >= ul_y[..., None]) & (ys < br_y[..., None]))[..., :, None])
    return torch.where((weight > 0.5)[..., None, None] & box, g,
                       torch.zeros_like(g)), weight


def augment(batch: Dict[str, torch.Tensor], p: Dict[str, torch.Tensor],
            image_hw, sigma: float) -> Dict[str, torch.Tensor]:
    """A staged batch -> (image (B, H, W, 3) normalized float32, target,
    target_weight) under the drawn parameters ``p``."""
    out_h, out_w = image_hw
    m_orig, m_canvas = crop_affines(batch["orig_to_canvas"],
                                    batch["sizes_hw"], p, image_hw)
    img = batch["canvas"].float()
    img = torch.where(p["jitter"][:, None, None, None] > 0,
                      hsv_jitter(img, p["gains"]), img)
    crop = torch.round(torch.clamp(twopass_warp(img, m_canvas, out_h,
                                                out_w), 0.0, 255.0))
    mean = torch.tensor(MEAN, device=crop.device)
    std = torch.tensor(STD, device=crop.device)
    image = (crop / 255.0 - mean) / std
    j = batch["joints"].float()
    j = torch.einsum("bij,bnj->bni", m_orig[:, :, :2], j) \
        + m_orig[:, None, :, 2]
    target, weight = targets(j, batch["joints_vis"], (out_w, out_h),
                             (out_w // 4, out_h // 4), sigma)
    return {"image": image, "target": target, "target_weight": weight}
