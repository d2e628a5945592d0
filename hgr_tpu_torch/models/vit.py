"""ViT decoder — cls-token transformer + simple pose decoder (port of
hgr_tpu/models/vit.py; reference model/transformer.py:29-152). NHWC.

Dtype placement mirrors the JAX modules: LayerNorm in float32, its output
cast to the compute dtype by each dense layer; residuals add in the
compute dtype; the class head is a float32 LayerNorm + float32 dense; the
pose head (x4 align-corners upsample -> ReLU -> 1x1 conv) runs in the
compute dtype and returns float32.

Attention routes by need (vit.py:105-135): without the map, every layer
takes ``fused_attention_qkv`` (the hand-written CUDA kernel on the card);
with the map, the last layer runs the unfused chain that materializes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hgr_tpu_torch.models.layers import Conv, Dense
from hgr_tpu_torch.ops.attention import (
    attention_core,
    fused_attention_qkv,
    merge_heads,
    split_heads,
)
from hgr_tpu_torch.ops.posemb import pos_emb_sincos_2d
from hgr_tpu_torch.ops.resize import upsample_bilinear_align_corners


class FeedForward(nn.Module):
    """Pre-LN MLP with exact (erf) GELU (reference transformer.py:29-41)."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x.float()))))


class Attention(nn.Module):
    """Pre-LN multi-head attention (reference transformer.py:45-77).

    ``fused``: True routes the no-map case through ``fused_attention_qkv``;
    False always takes the unfused chain.
    """

    def __init__(self, dim: int, heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, fused: bool = True):
        super().__init__()
        inner = heads * head_dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, bias=False, dtype=dtype)
        self.heads, self.head_dim = heads, head_dim
        self.scale = head_dim**-0.5
        self.fused = fused

    def forward(self, x: torch.Tensor, need_map: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        qkv = self.to_qkv(self.norm(x.float()))
        attn = None
        if need_map or not self.fused:
            q, k, v = split_heads(qkv, self.heads, self.head_dim)
            out, attn = attention_core(q, k, v, self.scale, return_attn=True)
            if not need_map:
                attn = None
            out = merge_heads(out)
        else:
            out = fused_attention_qkv(qkv.contiguous(), self.heads,
                                      self.head_dim, self.scale)
        return self.to_out(out), attn


class Transformer(nn.Module):
    """depth x (attention + MLP) with residuals; returns the last
    layer's attention map (reference transformer.py:80-96)."""

    def __init__(self, dim: int, depth: int, heads: int, head_dim: int,
                 mlp_dim: int, dtype: torch.dtype = torch.float32,
                 fused: bool = True):
        super().__init__()
        for i in range(depth):
            # Flax names: layers_<i>_attn / layers_<i>_ff (vit.py:166-173)
            self.add_module(f"layers_{i}_attn",
                            Attention(dim, heads, head_dim, dtype, fused))
            self.add_module(f"layers_{i}_ff",
                            FeedForward(dim, mlp_dim, dtype))
        self.depth = depth

    def forward(self, x: torch.Tensor, need_attnmap: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        attnmap = None
        for i in range(self.depth):
            last = i == self.depth - 1
            message, attnmap = getattr(self, f"layers_{i}_attn")(
                x, need_map=last and need_attnmap)
            x = message + x
            x = getattr(self, f"layers_{i}_ff")(x) + x
        return x, attnmap


class ViT(nn.Module):
    """ViT decoder head (reference transformer.py:99-152).

    Input: (B, h, w, dim) projected backbone features (NHWC).
    Output: (cls_out (B, num_classes) f32, hmap_out (B, 4h, 4w, J) f32,
             attnmap (B, heads, 1+h*w, 1+h*w) f32 or None).
    """

    def __init__(self, num_classes: int, num_joints: int,
                 feature_size: Tuple[int, int], dim: int, depth: int,
                 heads: int, head_dim: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32, fused: bool = True):
        super().__init__()
        h, w = feature_size
        self.feature_size = (h, w)
        self.dim = dim
        self.dtype = dtype
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.register_buffer(
            "pos_emb", torch.tensor(pos_emb_sincos_2d(h, w, dim)),
            persistent=False)
        self.transformer = Transformer(dim, depth, heads, head_dim, mlp_dim,
                                       dtype, fused)
        self.mlp_head_norm = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_head_fc = Dense(dim, num_classes, dtype=torch.float32)
        self.simple_decoder_conv = Conv(dim, num_joints, 1, bias=True,
                                        dtype=dtype)

    def forward(self, x: torch.Tensor, need_attnmap: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        b, h, w, c = x.shape
        if (h, w) != self.feature_size:
            raise ValueError(
                f"features are {(h, w)}, the decoder was built for "
                f"{self.feature_size}")
        tokens = x.reshape(b, h * w, c)
        tokens = tokens + self.pos_emb.to(tokens.dtype)
        cls_tokens = self.cls_token.to(tokens.dtype).expand(b, 1, self.dim)
        tokens = torch.cat([cls_tokens, tokens], dim=1)

        tokens, attnmap = self.transformer(tokens, need_attnmap=need_attnmap)

        cls_out = self.mlp_head_fc(self.mlp_head_norm(tokens[:, 0].float()))

        # the bf16 upsample rounds the matrices too (vit.py:240-249)
        hmap = tokens[:, 1:].reshape(b, h, w, self.dim)
        hmap = upsample_bilinear_align_corners(hmap, 4,
                                               compute_dtype=self.dtype)
        hmap_out = self.simple_decoder_conv(F.relu(hmap))
        return cls_out, hmap_out.float(), attnmap
