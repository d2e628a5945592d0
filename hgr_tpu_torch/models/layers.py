"""Building-block layers: Conv+BN+SiLU, ResNet basic/bottleneck blocks
(port of hgr_tpu/models/layers.py, plain stride-2 route).

Layout: modules take and return NHWC tensors, as the JAX modules do;
convolutions run on the NCHW view of the same memory (channels-last),
so no permute copies. Parameters stay float32; each module casts them
to its compute ``dtype`` at the call.

Parameter names follow PyTorch (``weight``/``bias``); BatchNorm keeps
its running statistics under the Flax names ``mean``/``var``
(utils/convert.py maps the trees). BatchNorm is functional over those
buffers rather than ``nn.BatchNorm2d``, whose ``running_var`` update
is unbiased where Flax's is biased (layers.py:260-263), and whose fused
kernel computes the variance and its gradient another way.

``fused_bn()`` routes each train-mode ``ConvBnAct`` through
``ops/bn_act.bn_act`` instead (hgr_tpu/models/layers.py:48-68,
:339-342): the same parameters and buffers, the two-pass biased batch
variance, and a hand-derived backward whose two passes are CUDA kernels
on the card. Off unless asked for.

int8 inference (hgr_tpu/models/layers.py:354-389, built by
``infer/quant.py``): a ``ConvBnAct`` with a ``QuantConv`` child
(``quant``) runs, in eval mode, its input quantized against a calibrated
per-tensor scale, the int8 conv with exact int32 accumulation
(``ops/int8_conv.py``) and the BN-folded dequantization, then SiLU.

Data parallelism: ``sync_batch_stats(model, group)`` makes every
BatchNorm of the model take its train-mode statistics over ``group``
(the mesh's data group): the per-channel sums and the row count are
summed over the ranks, through a differentiable sum on the plain route
and around the two kernels on the fused one (ops/bn_act.py), so the
statistics and the running-stat update are those of the global batch.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hgr_tpu_torch.ops.bn_act import bn_act
from hgr_tpu_torch.ops.int8_conv import conv_int8
from hgr_tpu_torch.parallel.collectives import all_sum_grad

# Fused BN(+SiLU) training route: the module-level override wins when set
# (tests and tools pin it), else HGR_TPU_FUSED_BN ('on' | 'off' |
# 'auto'/unset), read at each forward. 'auto' stays off, as in the JAX
# package (layers.py:55, where the route lost on the TPU): on the H100 it
# measured faster (PERF.md), but no benchmark cell holds that yet.
_FUSED_BN: Optional[bool] = None
_FUSED_BN_AUTO = False


def fused_bn() -> bool:
    """Whether train-mode ConvBnAct takes the fused route."""
    if _FUSED_BN is not None:
        return _FUSED_BN
    v = os.environ.get("HGR_TPU_FUSED_BN", "auto")
    if v in ("1", "on", "true"):
        return True
    if v in ("0", "off", "false"):
        return False
    return _FUSED_BN_AUTO


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels (reference model/gelan.py:5-14)."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def torch_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter of ``module`` in place from ``generator``
    with the distributions of hgr_tpu/models/layers.py:71-89 (the torch
    Conv2d/Linear defaults): weights and biases of convs and dense layers
    U(±1/sqrt(fan_in)), norms scale 1 / bias 0, the cls token N(0, 1).
    Parameters are visited in ``named_parameters`` order, so one seed
    gives one model."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Conv, Dense)):
                fan_in = mod.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
            cls_token = getattr(mod, "cls_token", None)
            if isinstance(cls_token, nn.Parameter):
                cls_token.normal_(0.0, 1.0, generator=generator)
    return module


class Conv(nn.Module):
    """NHWC convolution holding an OIHW ``weight`` (+ optional ``bias``),
    computed in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dilation: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Linear layer on the last axis with an (out, in) ``weight``,
    computed in ``dtype`` (Flax ``nn.Dense(dtype=...)``: input, kernel
    and bias cast to ``dtype``)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


# the running-stat momentum of every BatchNorm of the model
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, in float32, as Flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` computes it
    (layers.py:343-352): y = (x - mean) * (rsqrt(var + eps) * weight) +
    bias. The output is float32.

    Eval mode normalizes with the running statistics. Train mode uses the
    batch statistics of Flax 0.12's ``use_fast_variance``: mean(x) and
    var = max(mean(x²) − mean(x)², 0) in float32, written in plain torch
    ops so that autograd differentiates that formula. Each train-mode
    forward then updates the running statistics once, under ``no_grad``,
    with the biased var: ra = 0.9·ra + 0.1·batch.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps
        self.sync_group = None  # set by sync_batch_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.sync_group is None:
                mean = x.mean(dim=axes)
                mean_sq = (x * x).mean(dim=axes)
            else:  # over the data group; every rank holds as many rows
                count = x[..., 0].numel() * dist.get_world_size(
                    self.sync_group)
                sums = all_sum_grad(torch.stack(
                    [x.sum(dim=axes), (x * x).sum(dim=axes)]),
                    self.sync_group)
                mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            self.update_stats(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    @torch.no_grad()
    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = 0.9·ra + 0.1·batch for the running mean and (biased) var."""
        m = BN_MOMENTUM
        self.mean.mul_(m).add_((1.0 - m) * mean.detach())
        self.var.mul_(m).add_((1.0 - m) * var.detach())


def sync_batch_stats(module: nn.Module, group) -> nn.Module:
    """Take every BatchNorm's train-mode statistics over the ranks of
    ``group`` (None: this rank's batch alone)."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.sync_group = group
    return module


class QuantConv(nn.Module):
    """The int8 state of one quantized ``ConvBnAct``, as buffers (the
    'quant' collection of hgr_tpu/models/layers.py:362-367):

    kernel_q  (k, k, Cin, Cout) int8, BN-folded, per output channel
    act_scale () float32, the calibrated input scale (absmax / 127)
    out_scale (Cout,) float32, act_scale · the weight scale
    bias      (Cout,) float32, the BN-folded bias
    """

    def __init__(self, k: int, c_in: int, c_out: int):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(k, k, c_in, c_out,
                                                     dtype=torch.int8))
        self.register_buffer("act_scale", torch.ones(()))
        self.register_buffer("out_scale", torch.ones(c_out))
        self.register_buffer("bias", torch.zeros(c_out))


class ConvBnAct(nn.Module):
    """conv(bias=False) + BatchNorm + SiLU (reference model/gelan.py:18-56
    ``Conv``): the conv in ``dtype``, BN and SiLU in float32, the output
    cast to ``dtype`` (hgr_tpu/models/layers.py:267).

    With a ``quant`` child (``add_quant``) and not in train mode it takes
    the int8 branch (layers.py:306, ``_quantized``).

    In train mode with ``fused_bn()`` the BN(+SiLU) is ``ops/bn_act.bn_act``
    on the conv output, with the running statistics updated from its
    two-pass biased variance (layers.py:259-263). bf16 BN is not ported
    (ROADMAP A13), so the chain is float32 and the JAX condition on the
    chain dtype (layers.py:334-340) always holds."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 1,
                 strides: int = 1, padding: Optional[int] = None,
                 groups: int = 1, dilation: int = 1, use_act: bool = True,
                 dtype: torch.dtype = torch.float32,
                 stride2_impl: str = "plain"):
        super().__init__()
        if stride2_impl != "plain":
            raise NotImplementedError(
                f"stride2_impl={stride2_impl!r} is not ported yet "
                "(ROADMAP A13); only 'plain'")
        p = autopad(kernel_size, padding, dilation)
        self.conv = Conv(c_in, features, kernel_size, strides, p, groups,
                         dilation, bias=False, dtype=dtype)
        self.bn = BatchNorm(features)
        self.use_act = use_act
        self.dtype = dtype
        self.add_module("quant", None)

    def add_quant(self) -> QuantConv:
        """Give the module an (empty) int8 state: it then loads a state
        dict with ``quant.*`` entries and takes the int8 branch in eval
        mode."""
        conv = self.conv
        if conv.groups != 1 or conv.dilation != 1:
            raise ValueError("the int8 branch takes plain convs only "
                             "(groups 1, dilation 1)")
        c_out, c_in, k, _ = conv.weight.shape
        self.quant = QuantConv(k, c_in, c_out).to(conv.weight.device)
        return self.quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is not None and not self.training:
            return self._quantized(x)
        if self.training and fused_bn():
            bn = self.bn
            y, mean, var = bn_act(self.conv(x), bn.weight, bn.bias, bn.eps,
                                  self.use_act, group=bn.sync_group)
            bn.update_stats(mean, var)
            return y.to(self.dtype)
        y = self.bn(self.conv(x))
        if self.use_act:
            y = F.silu(y)
        return y.to(self.dtype)

    def _quantized(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize the input, int8 conv with int32 accumulation, dequant
        with the BN-folded scale and bias, SiLU (layers.py:372-385). The
        division is by a 0-dim tensor on x's device: a true division, as
        JAX divides (a CUDA division by a Python scalar multiplies by the
        reciprocal, and one ulp moves round() at a .5 boundary)."""
        q = self.quant
        xq = torch.clamp(torch.round(x.float() / q.act_scale), -127, 127
                         ).to(torch.int8)
        acc = conv_int8(xq, q.kernel_q, self.conv.stride, self.conv.padding)
        y = acc.float() * q.out_scale + q.bias
        if self.use_act:
            y = F.silu(y)
        return y.to(self.dtype)


class ResBasicBlock(nn.Module):
    """ResNet basic block (reference model/gelan.py:59-87): two 3x3
    Conv-BN blocks, SiLU between, residual add, trailing SiLU."""

    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cv1 = ConvBnAct(c_in, features, 3, 1, dtype=dtype)
        self.cv2 = ConvBnAct(features, features, 3, 1, use_act=False,
                             dtype=dtype)
        self.shortcut = shortcut
        self.downsample = (
            ConvBnAct(c_in, features, 1, 1, use_act=False, dtype=dtype)
            if shortcut and c_in != features else None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        if self.shortcut:
            residual = x if self.downsample is None else self.downsample(x)
            y = residual + y
        return F.silu(y).to(self.dtype)


class ResBottleneck(nn.Module):
    """ResNet bottleneck (reference model/gelan.py:90-121); unused by the
    GELAN 'small'/'large' specs, kept for the inventory."""

    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        c_ = int(features * expansion)
        self.cv1 = ConvBnAct(c_in, c_, 1, 1, dtype=dtype)
        self.cv2 = ConvBnAct(c_, c_, 3, 1, dtype=dtype)
        self.cv3 = ConvBnAct(c_, features, 1, 1, use_act=False, dtype=dtype)
        # Reference: residual only when c_in == features (gelan.py:105).
        self.add = shortcut and c_in == features
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv3(self.cv2(self.cv1(x)))
        if self.add:
            y = x + y
        return F.silu(y).to(self.dtype)
