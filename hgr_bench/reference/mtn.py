"""MultiTaskNet, plain (reference model/multitasknet.py:8-29,
model/gelan.py:5-176, model/transformer.py:9-152): GELAN backbone ->
1x1 projection -> cls-token ViT with a x4 align-corners pose decoder.

NHWC in and out; parameter and buffer names are those of the package
under test, so one state dict loads into both. Every convolution and
dense product takes its operands through ``prec.q``. BatchNorm is
Flax's (momentum 0.9, eps 1e-5, the fast variance of the batch in train
mode); the reference does not keep running statistics, since it follows
at most a few steps and compares gradients and parameters.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hgr_bench.reference import Precision

GELAN = {"small": (1, 1, 1, 1), "large": (2, 2, 2, 2)}


class Conv(nn.Module):
    def __init__(self, prec, c_in, c_out, k=1, stride=1, bias=False):
        super().__init__()
        self.prec = [prec]  # a list: not a submodule
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        self.stride, self.pad = stride, k // 2

    def forward(self, x):
        q = self.prec[0].q
        b = None if self.bias is None else self.bias.float()
        y = F.conv2d(q(x).permute(0, 3, 1, 2), q(self.weight), b,
                     self.stride, self.pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, prec, d_in, d_out, bias=True):
        super().__init__()
        self.prec = [prec]
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        q = self.prec[0].q
        b = None if self.bias is None else self.bias.float()
        return F.linear(q(x), q(self.weight), b)


class BatchNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class ConvBnAct(nn.Module):
    def __init__(self, prec, c_in, c_out, k=1, stride=1, act=True):
        super().__init__()
        self.conv = Conv(prec, c_in, c_out, k, stride)
        self.bn = BatchNorm(c_out)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act else y


class ResBasicBlock(nn.Module):
    def __init__(self, prec, c_in, c_out):
        super().__init__()
        self.cv1 = ConvBnAct(prec, c_in, c_out, 3)
        self.cv2 = ConvBnAct(prec, c_out, c_out, 3, act=False)
        self.downsample = (ConvBnAct(prec, c_in, c_out, 1, act=False)
                           if c_in != c_out else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.silu(res + self.cv2(self.cv1(x)))


class GELANBlock(nn.Module):
    def __init__(self, prec, c_in, c_out, hid1, hid2, n):
        super().__init__()
        self.half, self.n = hid1 // 2, n
        self.cv1 = ConvBnAct(prec, c_in, hid1)
        for i in range(n):
            self.add_module(f"cv2_{i}", ResBasicBlock(
                prec, self.half if i == 0 else hid2, hid2))
        for i in range(n):
            self.add_module(f"cv3_{i}", ResBasicBlock(prec, hid2, hid2))
        self.cv4 = ConvBnAct(prec, hid1 + 2 * hid2, c_out)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[..., :self.half], y[..., self.half:]
        c = b
        for i in range(self.n):
            c = getattr(self, f"cv2_{i}")(c)
        d = c
        for i in range(self.n):
            d = getattr(self, f"cv3_{i}")(d)
        return self.cv4(torch.cat([a, b, c, d], dim=-1))


class GELANNet(nn.Module):
    def __init__(self, prec, variant):
        super().__init__()
        n = GELAN[variant]
        self.conv1 = ConvBnAct(prec, 3, 64, 3, 2)
        self.conv2 = ConvBnAct(prec, 64, 128, 3, 2)
        self.cspelan1 = GELANBlock(prec, 128, 128, 128, 64, n[0])
        self.down1 = ConvBnAct(prec, 128, 256, 3, 2)
        self.cspelan2 = GELANBlock(prec, 256, 256, 256, 128, n[1])
        self.down2 = ConvBnAct(prec, 256, 512, 3, 2)
        self.cspelan3 = GELANBlock(prec, 512, 512, 512, 256, n[2])

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        x = self.down1(self.cspelan1(x))
        x = self.down2(self.cspelan2(x))
        return self.cspelan3(x)


class Attention(nn.Module):
    def __init__(self, prec, dim, heads, head_dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.to_qkv = Dense(prec, dim, 3 * heads * head_dim, bias=False)
        self.to_out = Dense(prec, heads * head_dim, dim, bias=False)
        self.heads, self.head_dim = heads, head_dim

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.to_qkv(self.norm(x))
        q, k, v = (t.reshape(b, n, self.heads, self.head_dim).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        s = torch.matmul(q, k.transpose(-1, -2)) * self.head_dim ** -0.5
        out = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, prec, dim, hidden):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(prec, dim, hidden)
        self.fc2 = Dense(prec, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class Transformer(nn.Module):
    def __init__(self, prec, dim, depth, heads, head_dim, mlp_dim):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}_attn",
                            Attention(prec, dim, heads, head_dim))
            self.add_module(f"layers_{i}_ff", FeedForward(prec, dim, mlp_dim))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"layers_{i}_attn")(x) + x
            x = getattr(self, f"layers_{i}_ff")(x) + x
        return x


def pos_emb_sincos(h: int, w: int, dim: int) -> np.ndarray:
    """(h·w, dim): sin/cos of x then of y over dim/4 frequencies of
    temperature 1e4 (reference model/transformer.py:9-26)."""
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = 1.0 / 10000.0 ** np.arange(dim // 4, dtype=np.float64)
    xv = x.reshape(-1)[:, None] * omega
    yv = y.reshape(-1)[:, None] * omega
    return np.concatenate([np.sin(xv), np.cos(xv), np.sin(yv), np.cos(yv)],
                          axis=1).astype(np.float32)


def align_corners_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) linear interpolation with align_corners=True."""
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    m = np.zeros((n_out, n_in))
    m[np.arange(n_out), lo] = 1.0 - (src - lo)
    m[np.arange(n_out), lo + 1] = src - lo
    return torch.tensor(m, dtype=torch.float32)


class ViT(nn.Module):
    def __init__(self, prec, num_classes, num_joints, feat_hw, dim, depth,
                 heads, head_dim, mlp_dim):
        super().__init__()
        h, w = feat_hw
        self.feat_hw, self.dim = (h, w), dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.register_buffer("pos_emb", torch.tensor(
            pos_emb_sincos(h, w, dim)), persistent=False)
        self.register_buffer("up_h", align_corners_matrix(h, 4 * h),
                             persistent=False)
        self.register_buffer("up_w", align_corners_matrix(w, 4 * w),
                             persistent=False)
        self.transformer = Transformer(prec, dim, depth, heads, head_dim,
                                       mlp_dim)
        self.mlp_head_norm = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_head_fc = Dense(prec, dim, num_classes)
        self.simple_decoder_conv = Conv(prec, dim, num_joints, 1, bias=True)

    def forward(self, x):
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c) + self.pos_emb
        t = torch.cat([self.cls_token.expand(b, 1, c), t], dim=1)
        t = self.transformer(t)
        cls_out = self.mlp_head_fc(self.mlp_head_norm(t[:, 0]))
        hm = t[:, 1:].reshape(b, h, w, c)
        hm = torch.einsum("oh,bhwc->bowc", self.up_h, hm)
        hm = torch.einsum("pw,bowc->bopc", self.up_w, hm)
        return cls_out, self.simple_decoder_conv(F.relu(hm))


class MultiTaskNet(nn.Module):
    """(B, H, W, 3) normalized images -> (logits (B, C), heatmaps (B,
    H/4, W/4, J)), both float32."""

    def __init__(self, image_size: Tuple[int, int] = (192, 192),
                 backbone: str = "small", dim: int = 256, depth: int = 4,
                 heads: int = 8, head_dim: int = 32, mlp_dim: int = 256,
                 num_classes: int = 19, num_joints: int = 21,
                 prec: Precision = None):
        super().__init__()
        prec = prec or Precision()
        self.image_size = tuple(image_size)
        self.encoder = GELANNet(prec, backbone)
        self.proj = Conv(prec, 512, dim, 1)
        self.decoder = ViT(prec, num_classes, num_joints,
                           (image_size[0] // 16, image_size[1] // 16), dim,
                           depth, heads, head_dim, mlp_dim)

    def forward(self, x):
        return self.decoder(self.proj(self.encoder(x.float())))


def from_config(cfg: dict, image_size, prec: Precision = None
                ) -> MultiTaskNet:
    """The reference of a configuration file's ``model`` block."""
    m = cfg["model"]
    return MultiTaskNet(tuple(image_size), m["backbone"], m["dim"],
                        m["depth"], m["heads"], m["head_dim"], m["mlp_dim"],
                        m["num_classes"], m["num_joints"], prec)


def init_scales(model: nn.Module):
    """Per parameter, in ``named_parameters`` order: ('uniform', bound)
    for conv and dense weights and biases (±1/sqrt(fan_in), the torch
    defaults the package draws), ('normal', 1.0) for the class token,
    ('const', v) for norm scales (1) and shifts (0)."""
    out = []
    owners = {}
    for mod in model.modules():
        for pname, p in mod.named_parameters(recurse=False):
            owners[id(p)] = (mod, pname)
    for name, p in model.named_parameters():
        mod, pname = owners[id(p)]
        if isinstance(mod, (Conv, Dense)):
            fan_in = mod.weight[0].numel()
            out.append((name, "uniform", 1.0 / math.sqrt(fan_in)))
        elif pname == "cls_token":
            out.append((name, "normal", 1.0))
        else:
            out.append((name, "const", 1.0 if pname == "weight" else 0.0))
    return out
