"""YOLOv7-tiny, plain, in inference form (WongKinYiu/yolov7
cfg/training/yolov7-tiny.yaml; one class): leaky-ReLU 0.1 convs with
BatchNorm (eps 1e-3) on their running statistics, ELAN-tiny blocks,
max-pool downsampling, the SPP-CSP neck and three IDetect heads, then
the decode of the raw maps and the top-1 box (score = objectness times
the best class score).

Weights come from a ``.npz`` of Flax paths (``params/<module>/conv/
kernel`` HWIO, ``.../bn/scale|bias``, ``batch_stats/.../bn/mean|var``,
``params/detect<i>/kernel|bias``), read with numpy by ``load_npz``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hgr_bench.reference import Precision

ANCHORS = (((10, 13), (16, 30), (33, 23)),
           ((30, 61), (62, 45), (59, 119)),
           ((116, 90), (156, 198), (373, 326)))
STRIDES = (8, 16, 32)


class ConvAct(nn.Module):
    def __init__(self, prec, c_in, c_out, k=1, stride=1):
        super().__init__()
        self.prec = [prec]
        self.w = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.register_buffer("scale", torch.ones(c_out))
        self.register_buffer("shift", torch.zeros(c_out))
        self.register_buffer("mean", torch.zeros(c_out))
        self.register_buffer("var", torch.ones(c_out))
        self.stride, self.pad = stride, k // 2

    def forward(self, x):
        q = self.prec[0].q
        y = F.conv2d(q(x), q(self.w), None, self.stride, self.pad)
        mul = torch.rsqrt(self.var + 1e-3) * self.scale
        y = (y - self.mean[:, None, None]) * mul[:, None, None] \
            + self.shift[:, None, None]
        return F.leaky_relu(y, 0.1)


class Elan(nn.Module):
    def __init__(self, prec, c_in, hid, out):
        super().__init__()
        self.cv1 = ConvAct(prec, c_in, hid)
        self.cv2 = ConvAct(prec, c_in, hid)
        self.cv3 = ConvAct(prec, hid, hid, 3)
        self.cv4 = ConvAct(prec, hid, hid, 3)
        self.out = ConvAct(prec, 4 * hid, out)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        c = self.cv3(b)
        d = self.cv4(c)
        return self.out(torch.cat([d, c, b, a], dim=1))


class Spp(nn.Module):
    def __init__(self, prec, c_in, hid, out):
        super().__init__()
        self.cv1 = ConvAct(prec, c_in, hid)
        self.cv2 = ConvAct(prec, c_in, hid)
        self.cv3 = ConvAct(prec, 4 * hid, hid)
        self.out = ConvAct(prec, 2 * hid, out)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        pools = [F.max_pool2d(b, k, 1, k // 2) for k in (13, 9, 5)]
        y = self.cv3(torch.cat(pools + [b], dim=1))
        return self.out(torch.cat([y, a], dim=1))


def _pool2(x):
    return F.max_pool2d(x, 2, 2)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv7Tiny(nn.Module):
    """(B, 3, H, W) RGB in [0, 1] -> three raw maps (B, 3·(5 + nc), h, w)."""

    def __init__(self, prec: Precision = None, nc: int = 1):
        super().__init__()
        p = prec or Precision()
        self.prec = [p]
        self.stem1, self.stem2 = ConvAct(p, 3, 32, 3, 2), ConvAct(p, 32, 64,
                                                                   3, 2)
        self.elan1, self.elan2 = Elan(p, 64, 32, 64), Elan(p, 64, 64, 128)
        self.elan3, self.elan4 = Elan(p, 128, 128, 256), Elan(p, 256, 256,
                                                              512)
        self.spp = Spp(p, 512, 256, 256)
        self.up4_conv, self.route4 = ConvAct(p, 256, 128), ConvAct(p, 256,
                                                                   128)
        self.neck4 = Elan(p, 256, 64, 128)
        self.up3_conv, self.route3 = ConvAct(p, 128, 64), ConvAct(p, 128, 64)
        self.neck3 = Elan(p, 128, 32, 64)
        self.down4, self.neck4b = ConvAct(p, 64, 128, 3, 2), Elan(p, 256, 64,
                                                                  128)
        self.down5, self.neck5b = ConvAct(p, 128, 256, 3, 2), Elan(p, 512,
                                                                   128, 256)
        no = 3 * (5 + nc)
        for i, ch in enumerate((128, 256, 512)):
            setattr(self, f"head{i}_conv", ConvAct(p, ch // 2, ch, 3))
            self.register_parameter(f"detect{i}_w", nn.Parameter(
                torch.empty(no, ch, 1, 1)))
            self.register_parameter(f"detect{i}_b", nn.Parameter(
                torch.empty(no)))
        self.nc = nc

    def forward(self, x) -> List[torch.Tensor]:
        q = self.prec[0].q
        x = self.elan1(self.stem2(self.stem1(x)))
        p3 = self.elan2(_pool2(x))
        p4 = self.elan3(_pool2(p3))
        p5 = self.elan4(_pool2(p4))
        n5 = self.spp(p5)
        n4 = self.neck4(torch.cat([self.route4(p4), _up2(self.up4_conv(n5))],
                                  dim=1))
        n3 = self.neck3(torch.cat([self.route3(p3), _up2(self.up3_conv(n4))],
                                  dim=1))
        n4b = self.neck4b(torch.cat([self.down4(n3), n4], dim=1))
        n5b = self.neck5b(torch.cat([self.down5(n4b), n5], dim=1))
        outs = []
        for i, f in enumerate((n3, n4b, n5b)):
            h = getattr(self, f"head{i}_conv")(f)
            outs.append(F.conv2d(q(h), q(getattr(self, f"detect{i}_w")),
                                 getattr(self, f"detect{i}_b")))
        return outs


def load_npz(model: YOLOv7Tiny, path: str) -> YOLOv7Tiny:
    """Fill ``model`` from a ``.npz`` of Flax paths (every array used,
    every tensor filled)."""
    z = np.load(path)
    params: Dict[str, torch.Tensor] = {}
    for key in z.files:
        coll, *mod, leaf = key.split("/")
        a = np.asarray(z[key], np.float32)
        if mod[-1].startswith("detect"):
            name = f"{mod[-1]}_{'w' if leaf == 'kernel' else 'b'}"
        else:
            target = {"kernel": "w", "scale": "scale", "bias": "shift",
                      "mean": "mean", "var": "var"}[leaf]
            name = ".".join(m for m in mod if m not in ("conv", "bn")) \
                + "." + target
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        params[name] = torch.from_numpy(np.ascontiguousarray(a))
    state = model.state_dict()
    if set(params) != set(state):
        raise ValueError(f"detector weights do not cover the model: "
                         f"{sorted(set(params) ^ set(state))[:6]}")
    model.load_state_dict(params, strict=True)
    return model


def decode(outs: List[torch.Tensor], nc: int = 1) -> torch.Tensor:
    """Raw NCHW maps -> (B, rows, 5 + nc) [cx, cy, w, h, obj, cls...] in
    input pixels: xy = (2σ(t) - 0.5 + grid)·stride, wh = (2σ(t))²·anchor;
    a map's channels are (anchor, field)."""
    rows = []
    for out, anc, stride in zip(outs, ANCHORS, STRIDES):
        b, _, h, w = out.shape
        o = out.float().reshape(b, 3, 5 + nc, h, w).permute(0, 3, 4, 1, 2)
        gy, gx = torch.meshgrid(torch.arange(h, device=out.device),
                                torch.arange(w, device=out.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[None, :, :, None, :]
        s = torch.sigmoid(o)
        xy = (s[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (s[..., 2:4] * 2.0) ** 2 * torch.tensor(
            anc, dtype=torch.float32, device=out.device)
        rows.append(torch.cat([xy, wh, s[..., 4:]], -1).reshape(
            b, h * w * 3, 5 + nc))
    return torch.cat(rows, dim=1)


def xyxy_scores(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (B, R, 4) x0 y0 x1 y1, scores (B, R))."""
    cx, cy, w, h = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return boxes, rows[..., 4] * rows[..., 5:].max(dim=-1).values
