"""Batched affine warps with cv2.INTER_LINEAR semantics (port of
hgr_tpu/ops/warp.py; reference libs/load.py:136-140 ``cv2.warpAffine``).

* ``batched_affine_warp`` — the exact warp: each destination pixel
  samples inv(M) @ [x, y, 1] and blends its 4 neighbours, out-of-bounds
  taps reading the constant border value. The augment pipeline's route
  on the CPU, as in the JAX package.
* ``batched_affine_warp_twopass`` — the two-pass (Catmull-Smith)
  decomposition the TPU kernel computes: a horizontal lerp at
  alpha·x' + beta·k + gamma of source rows k, then a vertical lerp at
  s2·x' + t2·y' + u2; near-90° rotations (|t| < |s|) route through the
  transposed canvas. The fused jitter + warp kernel's plain version
  (ops/warp_fused.py) is the HSV jitter followed by this warp.

The vertical lerp needs the horizontal pass only at its two rows, so
``twopass_sample`` reads 4 source pixels per output pixel and computes
exactly the two-pass result. Taps follow the Pallas kernel's ``_taps``
(hgr_tpu/ops/warp_pallas.py:100): the fraction is tied to the clamped
integer tap and clipped to [0, 1], which equals floor/frac wherever the
position lies inside the canvas.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hgr_tpu_torch.ops.affine import invert_affine


def batched_affine_warp(images: torch.Tensor, m: torch.Tensor,
                        out_size: Tuple[int, int],
                        fill: float = 0.0) -> torch.Tensor:
    """Warp (B, H, W, C) by per-image src->dst affines (B, 2, 3) to
    (B, out_h, out_w, C) with BORDER_CONSTANT ``fill``; integer inputs
    come back rounded and clipped in their dtype."""
    out_h, out_w = int(out_size[0]), int(out_size[1])
    b, in_h, in_w, c = images.shape
    dev = images.device
    imgs = images.float()
    minv = invert_affine(m.float())
    gy, gx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = imgs.reshape(b, in_h * in_w, c)

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < in_w) & (yi >= 0) & (yi < in_h))
        idx = (yi.clamp(0, in_h - 1) * in_w + xi.clamp(0, in_w - 1))
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        vals = vals.reshape(b, out_h, out_w, c)
        mask = valid[..., None].float()
        return vals * mask + fill * (1.0 - mask)

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    out = top * (1.0 - fy) + bot * fy
    return _to_dtype(out, images.dtype)


def _to_dtype(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(dtype)


def twopass_coefficients(m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, 2, 3) src->dst affines -> (minv, use_t, alpha, beta, gamma,
    s2, t2, u2), each of the last seven (B,): the shear decomposition of
    the inverse map (sx, sy) = (p x' + q y' + r, s x' + t y' + u), rows
    swapped where ``use_t`` (|t| < |s|) routes through the transpose."""
    minv = invert_affine(m.float())
    p_, q_, r_ = minv[:, 0, 0], minv[:, 0, 1], minv[:, 0, 2]
    s_, t_, u_ = minv[:, 1, 0], minv[:, 1, 1], minv[:, 1, 2]
    use_t = torch.abs(t_) < torch.abs(s_)
    p = torch.where(use_t, s_, p_)
    q = torch.where(use_t, t_, q_)
    r = torch.where(use_t, u_, r_)
    s2 = torch.where(use_t, p_, s_)
    t2 = torch.where(use_t, q_, t_)
    u2 = torch.where(use_t, r_, u_)
    safe_t = torch.where(torch.abs(t2) < 1e-6, torch.full_like(t2, 1e-6),
                         t2)
    alpha = p - q * s2 / safe_t
    beta = q / safe_t
    gamma = r - q * u2 / safe_t
    return minv, use_t, alpha, beta, gamma, s2, t2, u2


def _taps(pos: torch.Tensor, s_dim: int):
    i0 = torch.clamp(torch.floor(pos), 0, s_dim - 1)
    frac = torch.clamp(pos - i0, 0.0, 1.0)
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=s_dim - 1), frac[..., None]


def twopass_sample(imgs: torch.Tensor, coefs: Tuple[torch.Tensor, ...],
                   out_h: int, out_w: int) -> torch.Tensor:
    """The two-pass resample of f32 (B, S, S, C) canvases with the
    coefficients of ``twopass_coefficients``: (B, out_h, out_w, C) f32,
    blended as left·(1-fx) + right·fx, then top·(1-fy) + bot·fy."""
    _, use_t, alpha, beta, gamma, s2, t2, u2 = coefs
    b, s_dim, _, c = imgs.shape
    dev = imgs.device
    flat = imgs.reshape(b, s_dim * s_dim, c)
    # (row, col) of the routed canvas -> flat index of the stored one
    row_stride = torch.where(use_t, 1, s_dim)[:, None, None]
    col_stride = torch.where(use_t, s_dim, 1)[:, None, None]
    yp, xp = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")

    def col(t):
        return t[:, None, None]

    def read(k, x):
        idx = (k * row_stride + x * col_stride).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(
            b, out_h, out_w, c)

    def row(k):  # the horizontal pass at source row k (B, out_h, out_w)
        pos = col(alpha) * xp + col(beta) * k.float() + col(gamma)
        x0, x1, fx = _taps(pos, s_dim)
        return read(k, x0) * (1.0 - fx) + read(k, x1) * fx

    y0, y1, fy = _taps(col(s2) * xp + col(t2) * yp + col(u2), s_dim)
    return row(y0) * (1.0 - fy) + row(y1) * fy


def border_mask(minv: torch.Tensor, out_h: int, out_w: int, in_h: int,
                in_w: int) -> torch.Tensor:
    """(B, out_h, out_w, 1) f32: 1 where the exact inverse map lands
    inside (-1, in) on both axes, else 0 (cv2 BORDER_CONSTANT)."""
    dev = minv.device
    gy, gx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    inside = (sx > -1.0) & (sx < in_w) & (sy > -1.0) & (sy < in_h)
    return inside[..., None].float()


def batched_affine_warp_twopass(images: torch.Tensor, m: torch.Tensor,
                                out_size: Tuple[int, int]) -> torch.Tensor:
    """Two-pass warp of square (B, S, S, C) canvases to (B, out_h, out_w,
    C), zero outside the source by the original affine; integer inputs
    come back rounded and clipped in their dtype."""
    out_h, out_w = int(out_size[0]), int(out_size[1])
    b, in_h, in_w, _ = images.shape
    if in_h != in_w:
        raise ValueError("the two-pass warp expects square canvases")
    if out_h > in_h or out_w > in_w:
        raise ValueError("output larger than the canvas is not supported")
    coefs = twopass_coefficients(m)
    out = twopass_sample(images.float(), coefs, out_h, out_w)
    out = out * border_mask(coefs[0], out_h, out_w, in_h, in_w)
    return _to_dtype(out, images.dtype)
