"""MultiTaskNet — GELAN encoder -> 1x1 projection -> ViT decoder (port of
hgr_tpu/models/multitasknet.py:28; reference model/multitasknet.py:8-29).

Forward: images (B, H, W, 3) float ->
  cls_out  (B, num_classes) f32
  hmap_out (B, H/4, W/4, num_joints) f32  [NHWC; ``heatmaps_to_nchw``]
  attnmap  (B, heads, N, N) f32 with N = (H/16)*(W/16) + 1, or None.

``.train()`` (the ``nn.Module`` default) normalizes with batch
statistics and updates the BatchNorm running statistics once per
forward; ``.eval()`` uses the running statistics. With
``need_attnmap=False`` every attention layer takes the fused core, whose
forward and backward are the CUDA kernels on the card;
``fused_attention='split'`` feeds them q, k and v as three operands (the
tensor-parallel form, equal bit for bit to the packed one on one rank).

Precision and lowering knobs (hgr_tpu/models/multitasknet.py:41-82):
``decoder_dtype`` is the dtype of the 1x1 projection and the ViT (its
class head stays float32), ``early_dtype`` that of the first
``early_units`` GELAN units, ``remat`` recomputes the backbone body and
the pose head in the backward, ``stride2_impl`` lowers the backbone's
stride-2 convs. None of them changes the parameter tree.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from hgr_tpu_torch.models.gelan import GELANNet
from hgr_tpu_torch.models.layers import Conv, torch_init_
from hgr_tpu_torch.models.vit import ViT


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


class MultiTaskNet(nn.Module):
    """GELAN -> proj -> ViT, with the JAX constructor's fields.

    Parameters are float32 on the CPU, initialized from ``generator``
    (a fresh ``torch.Generator`` seeded with 0 when None); move the model
    with ``.to(device)``.
    """

    def __init__(self, num_joints: int = 21, num_classes: int = 19,
                 image_size: Tuple[int, int] = (192, 192),
                 backbone: str = "small", dim: int = 256, depth: int = 4,
                 heads: int = 8, head_dim: int = 32, mlp_dim: int = 256,
                 dtype: torch.dtype = torch.float32,
                 decoder_dtype: Optional[torch.dtype] = None,
                 early_dtype: Optional[torch.dtype] = None,
                 early_units: int = 3,
                 fused_attention: Any = True,
                 remat: bool = False, stride2_impl: str = "plain",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fused_attention not in (True, False, "split"):
            raise ValueError(
                f"fused_attention must be True, False or 'split', got "
                f"{fused_attention!r}")
        self.image_size = tuple(image_size)
        self.num_joints, self.num_classes = num_joints, num_classes
        self.dtype = dtype
        self.encoder = GELANNet(backbone, dtype=dtype, remat=remat,
                                stride2_impl=stride2_impl,
                                early_dtype=early_dtype,
                                early_units=early_units)
        ddt = decoder_dtype if decoder_dtype is not None else dtype
        self.proj = Conv(512, dim, 1, bias=False, dtype=ddt)
        self.decoder = ViT(num_classes, num_joints,
                           (image_size[0] // 16, image_size[1] // 16), dim,
                           depth, heads, head_dim, mlp_dim, dtype=ddt,
                           fused=fused_attention, remat_pose_head=remat)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        torch_init_(self, generator)

    @classmethod
    def from_config(cls, cfg, generator: Optional[torch.Generator] = None
                    ) -> "MultiTaskNet":
        """The model of a ``config.ModelConfig`` (dtypes by name), as the
        JAX ``MultiTaskNet.from_config``."""
        return cls(num_joints=cfg.num_joints, num_classes=cfg.num_classes,
                   image_size=cfg.image_size, backbone=cfg.backbone,
                   dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
                   head_dim=cfg.head_dim, mlp_dim=cfg.mlp_dim,
                   dtype=_dtype(cfg.compute_dtype),
                   decoder_dtype=_dtype(cfg.decoder_dtype),
                   early_dtype=_dtype(cfg.early_dtype),
                   early_units=cfg.early_units,
                   fused_attention=cfg.fused_attention, remat=cfg.remat,
                   generator=generator)

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
