"""ViT decoder — cls-token transformer + simple pose decoder (port of
hgr_tpu/models/vit.py; reference model/transformer.py:29-152). NHWC.

Dtype placement mirrors the JAX modules: LayerNorm in float32, its output
cast to the compute dtype by each dense layer; residuals add in the
compute dtype; the class head is a float32 LayerNorm + float32 dense; the
pose head (x4 align-corners upsample -> ReLU -> 1x1 conv) runs in the
compute dtype and returns float32; ``remat_pose_head`` recomputes it in
the backward (hgr_tpu/models/vit.py:244-260, ``layers.remat``).

Attention routes by need (vit.py:105-135): without the map, every layer
takes ``fused_attention_qkv`` (the hand-written CUDA kernels on the card,
forward and backward), or with ``fused='split'`` ``fused_attention_split``
on the three chunk views of ``to_qkv``'s output (the same kernel bodies);
with the map, the last layer runs the unfused chain that materializes it.

Tensor parallelism (``parallel/tp.py`` cuts the shards): an ``Attention``
or ``FeedForward`` whose ``tp_group`` is set holds this rank's shard of
each leaf named in ``tp_cuts`` (to_qkv/fc1 column-parallel, to_out/fc2
row-parallel) and the whole of every other leaf, and runs Megatron's
collectives (``parallel/collectives.py``) where a sharded tensor meets a
replicated one; fc2's bias is added once, after the reduce.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hgr_tpu_torch.models.layers import Conv, Dense, remat
from hgr_tpu_torch.ops.attention import (
    attention_core,
    fused_attention_qkv,
    fused_attention_split,
    merge_heads,
    split_heads,
)
from hgr_tpu_torch.ops.posemb import pos_emb_sincos_2d
from hgr_tpu_torch.ops.resize import upsample_bilinear_align_corners
from hgr_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_cat,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)


class FeedForward(nn.Module):
    """Pre-LN MLP with exact (erf) GELU (reference transformer.py:29-41)."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)
        self.tp_group = None  # set by parallel.tp.make_tensor_parallel
        self.tp_cuts = {}  # {leaf name: layout} of the leaves it shards

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x.float())
        # fc1 and fc2 share the hidden width: both are cut or neither is
        if "fc2.weight" not in self.tp_cuts:
            return self.fc2(F.gelu(self.fc1(h)))
        h = F.gelu(self.fc1(copy_to_model(h, self.tp_group)))
        fc2 = self.fc2
        part = F.linear(h.to(fc2.dtype), fc2.weight.to(fc2.dtype))
        return reduce_from_model(part, self.tp_group,
                                 bias=fc2.bias.to(fc2.dtype))


class Attention(nn.Module):
    """Pre-LN multi-head attention (reference transformer.py:45-77).

    ``fused``: True routes the no-map case through ``fused_attention_qkv``,
    'split' through ``fused_attention_split`` (the tensor-parallel form,
    vit.py:118-126); False always takes the unfused chain. Under tensor
    parallelism with to_qkv cut by heads (layout 'qkv') ``heads`` is this
    rank's head count; the map is then its head group's, by the unfused
    chain, gathered over the model group in head order into the full
    (B, heads, N, N) map (no gradient: it is an output to look at). With
    to_qkv cut contiguously (layout 'rows': the heads do not divide by the
    model axis) every rank gathers the whole qkv and attends over every
    head; to_out then takes this rank's columns of the output where it is
    row-parallel.
    """

    def __init__(self, dim: int, heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, fused=True):
        super().__init__()
        inner = heads * head_dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, bias=False, dtype=dtype)
        self.heads, self.head_dim = heads, head_dim
        self.scale = head_dim**-0.5
        self.fused = fused
        self.tp_group = None  # set by parallel.tp.make_tensor_parallel
        self.tp_cuts = {}  # {leaf name: layout} of the leaves it shards

    def forward(self, x: torch.Tensor, need_map: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm(x.float())
        group, qkv_cut = self.tp_group, self.tp_cuts.get("to_qkv.weight")
        if qkv_cut is not None:
            h = copy_to_model(h, group)
        qkv = self.to_qkv(h)
        if qkv_cut == "rows":  # every head, on every model rank
            qkv = gather_from_model(qkv, group)
        attn = None
        if need_map or not self.fused:
            q, k, v = split_heads(qkv, self.heads, self.head_dim)
            out, attn = attention_core(q, k, v, self.scale, return_attn=True)
            if not need_map:
                attn = None
            out = merge_heads(out)
        elif self.fused == "split":
            q, k, v = qkv.chunk(3, dim=-1)
            out = fused_attention_split(q, k, v, self.heads, self.head_dim,
                                        self.scale)
        else:
            out = fused_attention_qkv(qkv.contiguous(), self.heads,
                                      self.head_dim, self.scale)
        if qkv_cut == "qkv" and attn is not None:  # the ranks' head groups
            attn = gather_cat(attn, group, dim=1)
        if "to_out.weight" not in self.tp_cuts:
            return self.to_out(out), attn
        if qkv_cut != "qkv":  # this rank's columns of every head's output
            out = scatter_to_model(out, group)
        w = self.to_out.weight.to(self.to_out.dtype)
        part = F.linear(out.to(self.to_out.dtype), w)
        return reduce_from_model(part, group), attn


class Transformer(nn.Module):
    """depth x (attention + MLP) with residuals; returns the last
    layer's attention map (reference transformer.py:80-96)."""

    def __init__(self, dim: int, depth: int, heads: int, head_dim: int,
                 mlp_dim: int, dtype: torch.dtype = torch.float32,
                 fused=True):
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
                 dtype: torch.dtype = torch.float32, fused=True,
                 remat_pose_head: bool = False):
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
        self.remat_pose_head = remat_pose_head

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

        hmap_feat = tokens[:, 1:]
        hmap_out = (remat(self._pose_head, hmap_feat)
                    if self.remat_pose_head else self._pose_head(hmap_feat))
        return cls_out, hmap_out.float(), attnmap

    def _pose_head(self, hmap_feat: torch.Tensor) -> torch.Tensor:
        h, w = self.feature_size
        hmap = hmap_feat.reshape(hmap_feat.shape[0], h, w, self.dim)
        # the bf16 upsample rounds the matrices too (vit.py:240-249)
        hmap = upsample_bilinear_align_corners(hmap, 4,
                                               compute_dtype=self.dtype)
        return self.simple_decoder_conv(F.relu(hmap))
