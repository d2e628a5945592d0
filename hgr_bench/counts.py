"""The yardstick's arithmetic: the card's published peaks, the model
FLOPs of a forward (counted on the plain reference on the ``meta``
device, so that a hand-written kernel's work is counted the same
whatever implements it), and each kernel's least time from its shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from hgr_bench.reference import mtn, yolo

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # the CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=8)
def _mtn_forward(model_items: Tuple, image_hw: Tuple[int, int]) -> float:
    cfg = {"model": dict(model_items)}
    with torch.device("meta"):
        model = mtn.from_config(cfg, image_hw)
        x = torch.empty(1, image_hw[0], image_hw[1], 3)
    return _count(lambda: model(x))


def mtn_forward_flops(cfg: Dict, image_hw) -> float:
    """FLOPs of one crop's MultiTaskNet forward (2 a multiply-add)."""
    return _mtn_forward(tuple(sorted(cfg["model"].items())),
                        (int(image_hw[0]), int(image_hw[1])))


@functools.lru_cache(maxsize=4)
def yolo_forward_flops(size: int) -> float:
    """FLOPs of one frame's YOLOv7-tiny forward at size x size."""
    with torch.device("meta"):
        model = yolo.YOLOv7Tiny()
        x = torch.empty(1, 3, size, size)
    return _count(lambda: model(x))


def bound_s(nbytes: float, flops: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time on the card: bytes over HBM's rate against
    operations over ``peak`` (bf16 on the tensor cores unless given)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def attention_fwd(b: int, n: int, heads: int, head_dim: int
                  ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one bf16 attention forward on the packed qkv:
    q, k and v read once, the output written once; QKᵀ and PV."""
    width = heads * head_dim
    return (b * n * 4 * width * BF16_BYTES,
            4.0 * b * heads * n * n * head_dim)


def attention_bwd(b: int, n: int, heads: int, head_dim: int
                  ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one bf16 attention backward: qkv and the output
    gradient read once, dqkv written once; dV = PᵀdO, dP = dO Vᵀ,
    dQ = dS K, dK = dSᵀQ (the scores, recomputed from q and k, are
    not counted)."""
    width = heads * head_dim
    return (b * n * 7 * width * BF16_BYTES,
            8.0 * b * heads * n * n * head_dim)


# operations of the warp kernel (float32, CUDA cores), from its source:
# the two-pass blend and the positions (~45) per output pixel, the HSV
# jitter (~60) per canvas pixel of a jittered image's footprint
WARP_FLOPS_PER_PX, JITTER_FLOPS_PER_PX = 45, 60


def warp_footprint_px(m_canvas: torch.Tensor, s: int, out_h: int,
                      out_w: int) -> torch.Tensor:
    """(B,) canvas pixels whose centres the canvas -> crop affines send
    into the output. Where a crop magnifies the canvas, as every crop of
    the training cells does (the crop's side on the canvas is under the
    output's), each of them is a tap of the warp: the count is at most
    what the kernel has to read (its taps' one-pixel rim left out)."""
    dev = m_canvas.device
    ys, xs = torch.meshgrid(torch.arange(s, dtype=torch.float32, device=dev),
                            torch.arange(s, dtype=torch.float32, device=dev),
                            indexing="ij")
    out = []
    for m in m_canvas.float().split(16):
        x = (m[:, 0, 0, None, None] * xs + m[:, 0, 1, None, None] * ys
             + m[:, 0, 2, None, None])
        y = (m[:, 1, 0, None, None] * xs + m[:, 1, 1, None, None] * ys
             + m[:, 1, 2, None, None])
        inside = (x >= 0) & (x < out_w) & (y >= 0) & (y < out_h)
        out.append(inside.flatten(1).sum(1))
    return torch.cat(out).float()


def warp(footprint: torch.Tensor, jittered: torch.Tensor, out_h: int,
         out_w: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one warp launch over uint8 canvases: each
    image's footprint read once (3 bytes a pixel), the uint8 crop
    written once."""
    b = footprint.shape[0]
    nbytes = float(footprint.sum()) * 3 + b * out_h * out_w * 3
    flops = (b * out_h * out_w * WARP_FLOPS_PER_PX
             + JITTER_FLOPS_PER_PX * float((footprint * jittered).sum()))
    return nbytes, flops
