"""YOLOv7-tiny hand detector (port of hgr_tpu/models/yolo.py).

The standard YOLOv7-tiny topology (leaky-ReLU 0.1 convs, ELAN-tiny
blocks, max-pool downsampling, the SPP-CSP neck, three detection scales
with the P3/8, P4/16 and P5/32 anchors) as an ``nn.Module`` whose convs
run in NCHW through cuDNN. Dtypes follow the JAX module: each ConvAct
convolves in ``dtype`` (bf16 on the serving path), normalizes in f32
with its running statistics, applies the leaky ReLU in f32 and casts to
``dtype``; the three ``detect{i}`` 1x1 convs run in f32.

The public layout is the JAX package's: ``YOLOv7Tiny`` takes (B, H, W,
3) images in [0, 1] and returns the raw per-scale maps (B, h, w,
3 (5 + nc)) channels-last, which ``decode_predictions`` reads as (b, h, w,
anchor, field) as hgr_tpu/models/yolo.py:206 does. Module and parameter
names follow the Flax tree (``stem1.conv.weight``, ``stem1.bn.mean``,
``detect0.bias``, ...), so ``utils/convert.py:from_flax`` maps a Flax
variable tree (``load_npz_weights``, the ONNX porter) onto the
``state_dict`` and ``to_flax`` back.

In training mode (``.train()``) every BatchNorm normalizes with the batch
statistics and updates its running statistics once per forward, as
Flax's ``nn.BatchNorm(momentum=0.97)`` does (hgr_tpu/models/yolo.py:70);
``models/yolo_loss.py`` is the loss and ``tools/train_detector_smoke.py``
the trainer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hgr_tpu_torch.utils.convert import load_weights_npz

# BatchNorm epsilon of the yolov7-tiny Conv blocks (torch BatchNorm2d
# eps=1e-3 in the upstream cfg); the ONNX porter builds exact identity BNs
# with it.
BN_EPS = 1e-3

# yolov7-tiny anchors (w, h) per scale, cfg/training/yolov7-tiny.yaml
ANCHORS = (
    ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),      # P3, stride 8
    ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0)),     # P4, stride 16
    ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0)),  # P5, stride 32
)
STRIDES = (8, 16, 32)


# the running-stat momentum of the detector's BatchNorms (yolo.py:70)
BN_MOMENTUM = 0.97

# the std of a unit normal truncated to [-2, 2]: Flax's variance_scaling
# divides by it so that its truncated draws keep the asked-for variance
_TRUNC_NORMAL_STD = 0.87962566103423978


class _BatchNorm(nn.Module):
    """BatchNorm over NCHW channels in f32 (or the input's wider type), as
    Flax computes it:
    (x - mean) * (rsqrt(var + eps) * weight) + bias.

    Eval mode normalizes with the running statistics. Train mode takes
    the batch's, Flax's fast variance in f32: mean(x) and var =
    max(mean(x²) − mean(x)², 0) (the classifier's ``layers.BatchNorm``
    rule), and updates the running statistics under ``no_grad``:
    ra = 0.97·ra + 0.03·batch."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # at least f32, as Flax promotes (a float64 model stays float64)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvAct(nn.Module):
    """conv(bias=False) + BN + LeakyReLU(0.1), the yolov7-tiny Conv
    (hgr_tpu/models/yolo.py:50)."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 1,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(c_in, features, kernel_size, strides,
                              kernel_size // 2, bias=False)
        self.bn = _BatchNorm(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None,
                     c.stride, c.padding)
        return F.leaky_relu(self.bn(y), 0.1).to(self.dtype)


class ElanTiny(nn.Module):
    """ELAN-tiny: two 1x1 branches, two chained 3x3 convs, concat
    [d, c, b, a], 1x1 out (hgr_tpu/models/yolo.py:75)."""

    def __init__(self, c_in: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cv1 = ConvAct(c_in, hidden, 1, dtype=dtype)
        self.cv2 = ConvAct(c_in, hidden, 1, dtype=dtype)
        self.cv3 = ConvAct(hidden, hidden, 3, dtype=dtype)
        self.cv4 = ConvAct(hidden, hidden, 3, dtype=dtype)
        self.out = ConvAct(4 * hidden, out, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        b = self.cv2(x)
        c = self.cv3(b)
        d = self.cv4(c)
        return self.out(torch.cat([d, c, b, a], dim=1))


def _maxpool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Max pool with -inf padding (k - 1) // 2, as ``nn.max_pool``
    pads."""
    return F.max_pool2d(x, k, s, (k - 1) // 2)


class SppCspTiny(nn.Module):
    """SPP-CSP tiny: 1x1 reduce, max pools 5/9/13, concat [p13, p9, p5,
    b], 1x1, merged with a parallel 1x1 branch
    (hgr_tpu/models/yolo.py:101)."""

    def __init__(self, c_in: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cv1 = ConvAct(c_in, hidden, 1, dtype=dtype)
        self.cv2 = ConvAct(c_in, hidden, 1, dtype=dtype)
        self.cv3 = ConvAct(4 * hidden, hidden, 1, dtype=dtype)
        self.out = ConvAct(2 * hidden, out, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        b = self.cv2(x)
        y = torch.cat([_maxpool(b, 13, 1), _maxpool(b, 9, 1),
                       _maxpool(b, 5, 1), b], dim=1)
        y = self.cv3(y)
        return self.out(torch.cat([y, a], dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv7Tiny(nn.Module):
    """The full detector (hgr_tpu/models/yolo.py:124). Input (B, H, W, 3)
    in [0, 1] with H, W multiples of 32; returns the three raw head maps
    (B, H/s, W/s, 3 (5 + num_classes)) in f32, channels-last.

    Parameters are float32 on the CPU, drawn as the JAX module's init
    draws them, from ``generator`` (a fresh one seeded with 0 when None):
    each ConvAct's conv U(+-1/sqrt(fan_in)) (``torch_kernel_init``), the
    three ``detect{i}`` convs Flax's default ``lecun_normal`` (a normal of
    std sqrt(1/fan_in) truncated at two of its pre-correction sigmas) with
    zero biases, BN identity. Move with ``.to(device)``; call
    ``.eval()`` before an inference forward (a module starts in training
    mode, where BatchNorm takes batch statistics and updates its running
    ones).
    """

    def __init__(self, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = dtype
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem1 = ConvAct(3, 32, 3, 2, d)
        self.stem2 = ConvAct(32, 64, 3, 2, d)
        self.elan1 = ElanTiny(64, 32, 64, d)
        self.elan2 = ElanTiny(64, 64, 128, d)
        self.elan3 = ElanTiny(128, 128, 256, d)
        self.elan4 = ElanTiny(256, 256, 512, d)
        self.spp = SppCspTiny(512, 256, 256, d)
        self.up4_conv = ConvAct(256, 128, 1, dtype=d)
        self.route4 = ConvAct(256, 128, 1, dtype=d)
        self.neck4 = ElanTiny(256, 64, 128, d)
        self.up3_conv = ConvAct(128, 64, 1, dtype=d)
        self.route3 = ConvAct(128, 64, 1, dtype=d)
        self.neck3 = ElanTiny(128, 32, 64, d)
        self.down4 = ConvAct(64, 128, 3, 2, d)
        self.neck4b = ElanTiny(256, 64, 128, d)
        self.down5 = ConvAct(128, 256, 3, 2, d)
        self.neck5b = ElanTiny(512, 128, 256, d)
        no = 3 * (5 + num_classes)
        for i, ch in enumerate((128, 256, 512)):
            setattr(self, f"head{i}_conv", ConvAct(ch // 2, ch, 3, dtype=d))
            setattr(self, f"detect{i}", nn.Conv2d(ch, no, 1, bias=True))
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, mod in self.named_modules():
                if not isinstance(mod, nn.Conv2d):
                    continue
                fan_in = mod.weight[0].numel()
                if name.startswith("detect"):
                    s = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
                    nn.init.trunc_normal_(mod.weight, 0.0, s, -2.0 * s,
                                          2.0 * s, generator=gen)
                    mod.bias.zero_()
                else:
                    bound = 1.0 / math.sqrt(fan_in)
                    mod.weight.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last
        x = self.elan1(self.stem2(self.stem1(x)))                 # /4
        p3 = self.elan2(_maxpool(x, 2, 2))                        # /8
        p4 = self.elan3(_maxpool(p3, 2, 2))                       # /16
        p5 = self.elan4(_maxpool(p4, 2, 2))                       # /32
        n5 = self.spp(p5)
        u4 = _upsample2(self.up4_conv(n5))
        n4 = self.neck4(torch.cat([self.route4(p4), u4], dim=1))
        u3 = _upsample2(self.up3_conv(n4))
        n3 = self.neck3(torch.cat([self.route3(p3), u3], dim=1))
        n4b = self.neck4b(torch.cat([self.down4(n3), n4], dim=1))
        n5b = self.neck5b(torch.cat([self.down5(n4b), n5], dim=1))
        outs = []
        for i, feat in enumerate((n3, n4b, n5b)):
            h = getattr(self, f"head{i}_conv")(feat)
            o = getattr(self, f"detect{i}")(
                h.to(torch.promote_types(h.dtype, torch.float32)))
            outs.append(o.permute(0, 2, 3, 1))
        return outs


def decode_predictions(outs: Sequence[torch.Tensor], num_classes: int = 1,
                       anchors=ANCHORS, strides=STRIDES) -> torch.Tensor:
    """Raw channels-last head maps -> (B, N, 5 + nc) rows [cx, cy, w, h,
    obj, cls...] in input pixels (the yolov7 IDetect decode):
    xy = (2 sig(txy) - 0.5 + grid) stride, wh = (2 sig(twh))^2 anchor.
    Each map's channels are (anchor, field), so the maps must be
    channels-last: an NCHW map read this way scrambles anchors and
    fields and still yields boxes."""
    rows = []
    for out, anc, stride in zip(outs, anchors, strides):
        b, h, w, _ = out.shape
        na, no = len(anc), 5 + num_classes
        o = out.float().reshape(b, h, w, na, no)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=out.device),
            torch.arange(w, dtype=torch.float32, device=out.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        sig = torch.sigmoid(o)
        xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * stride
        anc_t = torch.tensor(anc, dtype=torch.float32, device=out.device)
        wh = (sig[..., 2:4] * 2.0) ** 2 * anc_t
        rows.append(torch.cat([xy, wh, sig[..., 4:]], dim=-1).reshape(
            b, h * w * na, no))
    return torch.cat(rows, dim=1)


def _xyxy(rows: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def best_box(decoded: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 box per image (boxes (B, 4) [x0, y0, x1, y1], scores (B,)):
    score = obj * max class score, the first maximum wins."""
    score = decoded[..., 4] * decoded[..., 5:].max(dim=-1).values
    idx = torch.argmax(score, dim=-1)
    ar = torch.arange(decoded.shape[0], device=decoded.device)
    return _xyxy(decoded[ar, idx]), score[ar, idx]


def nms(decoded: torch.Tensor, score_thresh: float = 0.25,
        iou_thresh: float = 0.45, max_det: int = 100
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size batched NMS: the top ``max_det`` scores (ties in index
    order, as ``lax.top_k``), then greedy same-class suppression in score
    order. Returns (boxes (B, k, 4) xyxy, scores (B, k), classes (B, k));
    suppressed slots have score 0."""
    cls_scores = decoded[..., 5:]
    score = decoded[..., 4] * cls_scores.max(dim=-1).values
    cls_idx = torch.argmax(cls_scores, dim=-1)
    score = torch.where(score >= score_thresh, score,
                        torch.zeros_like(score))
    k = min(max_det, score.shape[-1])
    order = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
    rows = torch.gather(decoded, 1, top_idx[..., None].expand(
        -1, -1, decoded.shape[-1]))
    classes = torch.gather(cls_idx, 1, top_idx)
    boxes = _xyxy(rows)
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / torch.clamp(union, min=1e-9)
    same_class = classes[:, :, None] == classes[:, None, :]
    keep = torch.ones(boxes.shape[:2], dtype=torch.bool,
                      device=decoded.device)
    ar = torch.arange(k, device=decoded.device)
    for i in range(k):
        overlap = (iou[:, i, :] > iou_thresh) & same_class[:, i, :]
        suppressed = (overlap & (ar[None, :] < i) & keep).any(dim=-1)
        keep[:, i] = ~suppressed & (top_scores[:, i] > 0)
    out_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    return boxes, out_scores, classes


def load_npz_weights(path: str) -> Dict[str, Any]:
    """Detector variables from an .npz with Flax-path keys
    ('params/stem1/conv/kernel', 'batch_stats/stem1/bn/mean', ...), as
    a nested tree of numpy arrays (``from_flax`` makes the state_dict)."""
    return load_weights_npz(path)
