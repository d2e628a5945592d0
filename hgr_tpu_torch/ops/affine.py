"""Affine crop geometry, batched (port of hgr_tpu/ops/affine.py; reference
libs/transforms.py:5-60).

A 2x3 matrix ``M`` maps SOURCE pixel coords to DESTINATION pixel coords:
``dst = M @ [x, y, 1]``. ``center`` is the crop center (x, y) in source
pixels, ``scale`` an isotropic factor (or (sx, sy)), ``rot_deg`` the
rotation in degrees, ``origin_size`` the side of the source crop square
before scaling, ``output_size`` the destination (out_w, out_h). All
arithmetic is float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Num = Union[torch.Tensor, float]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _third_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Perpendicular third point: b + rot90(a - b)."""
    direct = a - b
    return b + torch.stack([-direct[..., 1], direct[..., 0]], dim=-1)


def _rotate_dir(point: torch.Tensor, rot_rad: torch.Tensor) -> torch.Tensor:
    """Rotate a 2-vector by ``rot_rad``."""
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    return torch.stack([point[..., 0] * cs - point[..., 1] * sn,
                        point[..., 0] * sn + point[..., 1] * cs], dim=-1)


def _solve_affine(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The 2x3 affine taking 3 src points to 3 dst points (closed form of
    ``cv2.getAffineTransform``): with A = [[x_i, y_i, 1]],
    M = (A^-1 dst)^T, shape (..., 2, 3)."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    a = torch.cat([src, ones], dim=-1)  # (..., 3, 3)
    return torch.linalg.solve(a, dst).transpose(-1, -2)


def build_affine(center: torch.Tensor, scale: Num, rot_deg: Num,
                 origin_size: Num, output_size: Union[Sequence[float],
                                                      torch.Tensor],
                 shift: Tuple[float, float] = (0.0, 0.0),
                 inv: bool = False) -> torch.Tensor:
    """The crop affine (reference libs/transforms.py:20-54), batched over
    the leading dims of ``center`` (B, 2). Returns (..., 2, 3) float32."""
    center = _f32(center, None)
    dev = center.device
    scale = _f32(scale, dev)
    rot_deg = _f32(rot_deg, dev)
    origin_size = _f32(origin_size, dev)
    output_size = _f32(output_size, dev)
    shift = _f32(shift, dev)
    if scale.dim() == center.dim() - 1:  # one scale per batch element
        scale = scale[..., None] * torch.ones_like(center)
    if origin_size.dim() < center.dim():
        origin_size = origin_size[..., None] * torch.ones_like(center)
    scale_tmp = scale * origin_size  # (..., 2)
    src_w = scale_tmp[..., 0]
    dst_w = output_size[..., 0]
    dst_h = output_size[..., 1]

    rot_rad = math.pi * rot_deg / 180.0
    src_dir = _rotate_dir(
        torch.stack([torch.zeros_like(src_w), src_w * -0.5], dim=-1),
        rot_rad)
    dst_dir = torch.stack([torch.zeros_like(dst_w), dst_w * -0.5], dim=-1)

    src0 = center + scale_tmp * shift
    src1 = center + src_dir + scale_tmp * shift
    src2 = _third_point(src0, src1)
    dst_c = torch.stack([dst_w * 0.5, dst_h * 0.5], dim=-1)
    dst0 = dst_c
    dst1 = dst_c + dst_dir
    dst2 = _third_point(dst0, dst1)

    src = torch.stack([src0, src1, src2], dim=-2)  # (..., 3, 2)
    dst = torch.stack([dst0, dst1, dst2], dim=-2)
    src, dst = torch.broadcast_tensors(src, dst)
    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def transform_points(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Apply 2x3 affine(s) to points: (..., N, 2) with (..., 2, 3) ->
    (..., N, 2)."""
    points = points.float()
    lin = torch.einsum("...ij,...nj->...ni", m[..., :, :2], points)
    return lin + m[..., None, :, 2]


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert 2x3 affine(s): dst = A src + b  =>  src = A^-1 dst - A^-1 b.

    Elementwise ops only, each rounded on its own (the A^-1 b product
    written out, not a batched matrix product, which a card may run with
    fused multiply-adds): the warp kernel (csrc/warp_twopass.cu) inverts
    in this order and equals it bit for bit; on the CPU it is the einsum's
    result."""
    a = m[..., :, :2]
    b = m[..., :, 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_a = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
    ], dim=-2) / det[..., None, None]
    inv_b = -(inv_a[..., :, 0] * b[..., None, 0]
              + inv_a[..., :, 1] * b[..., None, 1])
    return torch.cat([inv_a, inv_b[..., None]], dim=-1)


def compose_affine(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """result(x) = m2(m1(x)); both (..., 2, 3)."""
    a = torch.einsum("...ij,...jk->...ik", m2[..., :, :2], m1[..., :, :2])
    b = (torch.einsum("...ij,...j->...i", m2[..., :, :2], m1[..., :, 2])
         + m2[..., :, 2])
    return torch.cat([a, b[..., None]], dim=-1)
