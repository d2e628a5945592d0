"""Building-block layers: Conv+BN+SiLU, ResNet basic/bottleneck blocks
(port of hgr_tpu/models/layers.py).

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

``bn_dtype()`` (HGR_TPU_BN_DTYPE, hgr_tpu/models/layers.py:27-45) is the
dtype of the normalize chain under a bf16 conv: 'bfloat16' casts the
BatchNorm output to bf16 before the SiLU, as Flax's ``nn.BatchNorm(dtype=
bfloat16)`` does (its statistics and normalize stay float32 by type
promotion), and keeps such a layer off the fused route.

``stride2_impl`` lowers an eligible 3x3/stride-2 conv as the JAX package
does (layers.py:101-231): 's2d' (space-to-depth and a 2x2 stride-1 conv)
or 'dense_grad' (the plain forward, the input gradient as four dense
stride-1 convs). The parameter stays ``conv.weight``.

``remat(fn, *args)`` is Flax's ``nn.remat`` for the backbone body and the
pose head: ``torch.utils.checkpoint`` without reentry, with the running
statistics updated by the forward only, never by a recomputation.

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

import contextlib
import math
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
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


# Dtype of the BatchNorm normalize chain under a bf16 conv (layers.py:27-45):
# the module-level override wins when set, else HGR_TPU_BN_DTYPE, read at
# each forward. float32 unless 'bfloat16' is asked for.
_BN_DTYPE: Optional[torch.dtype] = None


def bn_dtype() -> torch.dtype:
    """The normalize chain's dtype asked for (bf16 or f32)."""
    if _BN_DTYPE is not None:
        return _BN_DTYPE
    return (torch.bfloat16
            if os.environ.get("HGR_TPU_BN_DTYPE", "") == "bfloat16"
            else torch.float32)


# > 0 while a checkpointed region recomputes its forward: BatchNorm then
# leaves its running statistics alone (``remat``). A global rather than a
# thread-local: the backward that recomputes may run on another thread.
_STATS_FROZEN = 0


@contextlib.contextmanager
def stats_frozen():
    """No BatchNorm updates its running statistics within the block."""
    global _STATS_FROZEN
    _STATS_FROZEN += 1
    try:
        yield
    finally:
        _STATS_FROZEN -= 1


def remat(fn: Callable, *args):
    """``fn(*args)`` whose activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), as Flax's ``nn.remat``.
    The first call is the forward and updates the BatchNorm running
    statistics; every recomputation runs under ``stats_frozen``, so a step
    updates them once however many pullbacks recompute. Without autograd
    recording it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        with stats_frozen():
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


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


def _s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """The (O, C, 3, 3) kernel of a 3x3/stride-2 conv as the (O, 4C, 2, 2)
    kernel of the 2x2 stride-1 conv on the space-to-depth input:
    W2[o, (p·2 + q)·C + c, ka, kb] = W[o, c, 2ka + p − 1, 2kb + q − 1],
    zero where a tap index leaves [0, 2] (layers.py:206-218)."""
    o, c = w.shape[:2]
    d = torch.arange(2)[:, None] * 2 + torch.arange(2)[None, :] - 1
    ok = (d >= 0) & (d <= 2)
    dc = d.clamp(0, 2).to(w.device)
    w2 = w[:, :, dc][:, :, :, :, dc]  # (O, C, ka, p, kb, q)
    mask = (ok[:, :, None, None] & ok[None, None]).to(w.device, w.dtype)
    w2 = w2 * mask
    return w2.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 2, 2)


class S2DConv3x3s2(Conv):
    """3x3/stride-2 conv as space-to-depth + a 2x2 stride-1 conv
    (layers.py:_S2DConv3x3s2): the same multiply-adds, every conv and
    gradient stride 1. Holds the plain (O, C, 3, 3) ``weight``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"s2d takes even sizes, got {(h, w)}")
        z = x.to(self.dtype).reshape(b, h // 2, 2, w // 2, 2, c)
        z = z.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        z = F.pad(z.permute(0, 3, 1, 2), (1, 0, 1, 0))
        y = F.conv2d(z, _s2d_kernel(self.weight.to(self.dtype)))
        return y.permute(0, 2, 3, 1)


class _Conv3x3s2DenseGrad(torch.autograd.Function):
    """The plain 3x3/stride-2 conv (NCHW) whose input gradient is four
    dense stride-1 convs over the cotangent, one per output phase
    (layers.py:133-162): an even position takes the centre tap, an odd one
    two. The kernel gradient is the plain conv's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, None, 2, 1)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        wt = w.transpose(0, 1).to(ct.dtype)  # (C, O, t, u)

        def pconv(k, pad):
            return F.conv2d(F.pad(ct, pad), k)

        k01 = torch.stack([wt[:, :, 1, 2], wt[:, :, 1, 0]], -1)[:, :, None]
        k10 = torch.stack([wt[:, :, 2, 1], wt[:, :, 0, 1]], -1)[..., None]
        k11 = torch.stack([
            torch.stack([wt[:, :, 2, 2], wt[:, :, 2, 0]], -1),
            torch.stack([wt[:, :, 0, 2], wt[:, :, 0, 0]], -1)], -2)
        p00 = pconv(wt[:, :, 1:2, 1:2], (0, 0, 0, 0))
        p01 = pconv(k01, (0, 1, 0, 0))
        p10 = pconv(k10, (0, 0, 0, 1))
        p11 = pconv(k11, (0, 1, 0, 1))
        b, c, h, wd = p00.shape
        dx = torch.stack([p00, p01, p10, p11], dim=2).reshape(
            b, c, 2, 2, h, wd).permute(0, 1, 4, 2, 5, 3)
        dx = dx.reshape(b, c, 2 * h, 2 * wd).to(x.dtype)
        dw = torch.ops.aten.convolution_backward(
            ct, x, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        return dx, dw


class DenseGradConv3x3s2(Conv):
    """3x3/stride-2 conv with the phase-decomposed input gradient
    (layers.py:_DenseGradConv3x3s2). Holds the plain ``weight``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            raise ValueError(f"dense_grad takes even sizes, got {(h, w)}")
        y = _Conv3x3s2DenseGrad.apply(x.to(self.dtype).permute(0, 3, 1, 2),
                                      self.weight.to(self.dtype))
        return y.permute(0, 2, 3, 1)


STRIDE2_CONVS = {"plain": Conv, "s2d": S2DConv3x3s2,
                 "dense_grad": DenseGradConv3x3s2}


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
        """ra = 0.9·ra + 0.1·batch for the running mean and (biased) var;
        nothing while a checkpointed region recomputes (``remat``)."""
        if _STATS_FROZEN:
            return
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
    ``Conv``): the conv in ``dtype``, BN in float32, the SiLU in the chain
    dtype, the output cast to ``dtype`` (hgr_tpu/models/layers.py:267).
    The chain dtype is ``bn_dtype()`` under a bf16 ``dtype``, else float32
    (layers.py:334-336).

    With a ``quant`` child (``add_quant``) and not in train mode it takes
    the int8 branch (layers.py:306, ``_quantized``).

    In train mode with ``fused_bn()`` and a float32 chain the BN(+SiLU) is
    ``ops/bn_act.bn_act`` on the conv output, with the running statistics
    updated from its two-pass biased variance (layers.py:259-263, :337-342);
    a bf16 chain keeps the plain route.

    ``stride2_impl`` ('plain' | 's2d' | 'dense_grad') picks the lowering of
    an eligible 3x3/stride-2 conv (layers.py:308-309); any other conv is
    plain."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 1,
                 strides: int = 1, padding: Optional[int] = None,
                 groups: int = 1, dilation: int = 1, use_act: bool = True,
                 dtype: torch.dtype = torch.float32,
                 stride2_impl: str = "plain"):
        super().__init__()
        if stride2_impl not in STRIDE2_CONVS:
            raise ValueError(f"stride2_impl must be one of "
                             f"{sorted(STRIDE2_CONVS)}, got {stride2_impl!r}")
        p = autopad(kernel_size, padding, dilation)
        eligible = (kernel_size == 3 and strides == 2 and groups == 1
                    and dilation == 1 and p == 1)
        conv = STRIDE2_CONVS[stride2_impl if eligible else "plain"]
        self.conv = conv(c_in, features, kernel_size, strides, p, groups,
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
        chain = (bn_dtype() if self.dtype == torch.bfloat16
                 else torch.float32)
        if self.training and fused_bn() and chain == torch.float32:
            bn = self.bn
            y, mean, var = bn_act(self.conv(x), bn.weight, bn.bias, bn.eps,
                                  self.use_act, group=bn.sync_group)
            bn.update_stats(mean, var)
            return y.to(self.dtype)
        y = self.bn(self.conv(x)).to(chain)
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
