"""The int8 convolution of the quantized ConvBnAct, as stock ops (port of
the ``lax.conv_general_dilated(..., preferred_element_type=int32)`` call
of hgr_tpu/models/layers.py:375-378, which XLA computes: no TPU kernel).

``conv_int8`` pads the int8 NHWC input, gathers the k·k shifted, strided
taps of every output pixel into a (B·Ho·Wo, k·k·Cin) int8 matrix, whose
column order (tap row, tap column, input channel) is the row order of
the HWIO kernel reshaped to (k·k·Cin, Cout), and multiplies it with
``torch._int_mm``: an exact int32 product (cuBLASLt on the card).

On the card ``_int_mm`` takes more than 16 rows and a depth and width
that are multiples of 8. The route pads the depth with zero columns in
both operands (the stem: Cin = 3, k·k·Cin = 27 -> 32) and the rows with
zero rows to at least 17 on every device, and checks the three
conditions itself, so that a breach shows on the CPU too, where
``_int_mm`` does not enforce them.

``conv_int8_reference`` is the plain version: ``F.conv2d`` in float64 on
the int8 values, exact since |Σ| <= 127² · k·k·Cin < 2^53.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 17  # _int_mm on the card: more than 16 rows
_ALIGN = 8  # ... and a depth and width that are multiples of 8


def _check_operands(xq: torch.Tensor, kernel_q: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype} and "
                        f"{kernel_q.dtype}")
    if xq.dim() != 4 or kernel_q.dim() != 4:
        raise ValueError(f"xq (B, H, W, Cin) and kernel_q (k, k, Cin, Cout) "
                         f"expected, got {tuple(xq.shape)} and "
                         f"{tuple(kernel_q.shape)}")
    k, k2, cin, _ = kernel_q.shape
    if k != k2 or xq.shape[-1] != cin:
        raise ValueError(f"kernel_q {tuple(kernel_q.shape)} does not take "
                         f"an input of {xq.shape[-1]} channels")


def gather_taps(xq: torch.Tensor, k: int, stride: int, padding: int
                ) -> torch.Tensor:
    """(B, H, W, Cin) -> (B, Ho, Wo, k·k·Cin): the taps of every output
    pixel, in the HWIO kernel's (row, column, channel) order."""
    b, h, w, _ = xq.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    taps = [xp[:, i:i + stride * (ho - 1) + 1:stride,
               j:j + stride * (wo - 1) + 1:stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(taps, dim=-1)


def int_mm_operands(a: torch.Tensor, wmat: torch.Tensor):
    """(M, K) and (K, N) int8 -> the operands ``_int_mm`` takes on the
    card: the depth padded with zero columns to a multiple of 8 in both,
    the rows with zero rows to at least 17; the second operand as the
    transposed view of a contiguous (N, K) matrix. Raises where the width
    N is not a multiple of 8 (no padding of the output's channels)."""
    m, kdim = a.shape
    n = wmat.shape[1]
    pad_k = -kdim % _ALIGN
    pad_m = max(_MIN_ROWS - m, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    bt = F.pad(wmat.t(), (0, pad_k)).contiguous()
    rows, depth = a.shape
    if rows < _MIN_ROWS or depth % _ALIGN or n % _ALIGN:
        raise ValueError(
            f"int8 product of ({rows}, {depth}) by ({depth}, {n}): the card "
            f"takes more than 16 rows and a depth and width that are "
            f"multiples of {_ALIGN}")
    return a.contiguous(), bt.t()


def conv_int8(xq: torch.Tensor, kernel_q: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """int32 (B, Ho, Wo, Cout) = the exact convolution of the int8 NHWC
    input ``xq`` with the int8 HWIO ``kernel_q`` (k, k, Cin, Cout),
    'same'-style symmetric ``padding``, no dilation or groups."""
    _check_operands(xq, kernel_q)
    k, _, cin, cout = kernel_q.shape
    taps = gather_taps(xq, k, stride, padding)
    b, ho, wo, kdim = taps.shape
    a, bmat = int_mm_operands(taps.reshape(b * ho * wo, kdim),
                              kernel_q.reshape(k * k * cin, cout))
    acc = torch._int_mm(a, bmat)
    return acc[:b * ho * wo].reshape(b, ho, wo, cout)


def conv_int8_reference(xq: torch.Tensor, kernel_q: torch.Tensor,
                        stride: int, padding: int) -> torch.Tensor:
    """Plain version of ``conv_int8``: ``F.conv2d`` in float64 on the int8
    values (exact), rounded back to int32."""
    _check_operands(xq, kernel_q)
    y = F.conv2d(xq.double().permute(0, 3, 1, 2),
                 kernel_q.double().permute(3, 2, 0, 1), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)
