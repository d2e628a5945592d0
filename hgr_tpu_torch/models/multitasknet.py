"""MultiTaskNet — GELAN encoder -> 1x1 projection -> ViT decoder (port of
hgr_tpu/models/multitasknet.py:28; reference model/multitasknet.py:8-29).

Forward: images (B, H, W, 3) float ->
  cls_out  (B, num_classes) f32
  hmap_out (B, H/4, W/4, num_joints) f32  [NHWC; ``heatmaps_to_nchw``]
  attnmap  (B, heads, N, N) f32 with N = (H/16)*(W/16) + 1, or None.

Eval mode only: BatchNorm uses its running statistics, and the forward
on a CUDA tensor runs under ``torch.inference_mode()`` or ``no_grad()``
(the attention backward kernel lands with the training slice).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from hgr_tpu_torch.models.gelan import GELANNet
from hgr_tpu_torch.models.layers import Conv, torch_init_
from hgr_tpu_torch.models.vit import ViT


def _unported(field: str, value: Any, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"MultiTaskNet({field}={value!r}) is not ported yet (ROADMAP {item})")


class MultiTaskNet(nn.Module):
    """GELAN -> proj -> ViT, with the JAX constructor's fields.

    Parameters are float32 on the CPU, initialized from ``generator``
    (a fresh ``torch.Generator`` seeded with 0 when None); move the model
    with ``.to(device)``. Fields of the JAX model that are not ported yet
    raise ``NotImplementedError`` rather than being ignored.
    """

    def __init__(self, num_joints: int = 21, num_classes: int = 19,
                 image_size: Tuple[int, int] = (192, 192),
                 backbone: str = "small", dim: int = 256, depth: int = 4,
                 heads: int = 8, head_dim: int = 32, mlp_dim: int = 256,
                 dtype: torch.dtype = torch.float32,
                 decoder_dtype: Optional[torch.dtype] = None,
                 early_dtype: Optional[torch.dtype] = None,
                 fused_attention: Any = True,
                 remat: bool = False, stride2_impl: str = "plain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decoder_dtype is not None:
            raise _unported("decoder_dtype", decoder_dtype, "A13")
        if early_dtype is not None:
            raise _unported("early_dtype", early_dtype, "A13")
        if remat:
            raise _unported("remat", remat, "A13")
        if stride2_impl != "plain":
            raise _unported("stride2_impl", stride2_impl, "A13")
        if fused_attention == "split":
            raise _unported("fused_attention", fused_attention, "A12/B5")
        if fused_attention not in (True, False):
            raise ValueError(
                f"fused_attention must be True or False, got "
                f"{fused_attention!r}")
        self.image_size = tuple(image_size)
        self.num_joints, self.num_classes = num_joints, num_classes
        self.dtype = dtype
        self.encoder = GELANNet(backbone, dtype=dtype)
        self.proj = Conv(512, dim, 1, bias=False, dtype=dtype)
        self.decoder = ViT(num_classes, num_joints,
                           (image_size[0] // 16, image_size[1] // 16), dim,
                           depth, heads, head_dim, mlp_dim, dtype=dtype,
                           fused=bool(fused_attention))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        torch_init_(self, generator)

    def forward(self, x: torch.Tensor, need_attnmap: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """``need_attnmap=False`` (serving) lets every attention layer take
        the fused core; the third output is then None."""
        feats = self.proj(self.encoder(x.to(self.dtype)))
        return self.decoder(feats, need_attnmap=need_attnmap)


def heatmaps_to_nchw(hmap_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, J) -> (B, J, H, W) for reference-layout consumers."""
    return hmap_nhwc.permute(0, 3, 1, 2)
