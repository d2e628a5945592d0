"""GELAN (CSP-ELAN) backbone (port of hgr_tpu/models/gelan.py; reference
model/gelan.py:124-176). NHWC in and out.

Unported knobs of the JAX backbone (``remat``, ``early_dtype``,
``stride2_impl`` other than 'plain') are refused by ``MultiTaskNet``.
"""

from __future__ import annotations

import torch
from torch import nn

from hgr_tpu_torch.models.layers import ConvBnAct, ResBasicBlock, ResBottleneck

GELAN_SPEC = {
    # name -> (block type, blocks-per-chain per stage)
    "small": ("basic", (1, 1, 1, 1)),
    "large": ("basic", (2, 2, 2, 2)),
}


class GELANBlock(nn.Module):
    """CSP-ELAN block (reference model/gelan.py:124-142).

    y = [a, b] = chunk2(cv1(x)); y += [chain1(b), chain2(chain1(b))];
    out = cv4(concat(y)).
    """

    def __init__(self, c_in: int, c_out: int, c_hid1: int, c_hid2: int,
                 block: str = "basic", nblocks: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cls = ResBasicBlock if block == "basic" else ResBottleneck
        half = c_hid1 // 2
        self.cv1 = ConvBnAct(c_in, c_hid1, 1, 1, dtype=dtype)
        # Flax names the chain blocks cv2_<i> / cv3_<i> (gelan.py:66-69)
        for i in range(nblocks):
            self.add_module(f"cv2_{i}", cls(half if i == 0 else c_hid2,
                                            c_hid2, dtype=dtype))
        for i in range(nblocks):
            self.add_module(f"cv3_{i}", cls(c_hid2, c_hid2, dtype=dtype))
        self.cv4 = ConvBnAct(c_hid1 + 2 * c_hid2, c_out, 1, 1, dtype=dtype)
        self.nblocks = nblocks
        self.half = half

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.cv1(x)
        a, b = y0[..., :self.half], y0[..., self.half:]
        c = b
        for i in range(self.nblocks):
            c = getattr(self, f"cv2_{i}")(c)
        d = c
        for i in range(self.nblocks):
            d = getattr(self, f"cv3_{i}")(d)
        return self.cv4(torch.cat([a, b, c, d], dim=-1))


class GELANNet(nn.Module):
    """GELAN backbone (reference model/gelan.py:145-176).

    Input (B, H, W, 3) -> features (B, H/16, W/16, 512).
    """

    def __init__(self, variant: str = "small",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in GELAN_SPEC:
            raise ValueError(f"unknown GELAN variant {variant!r}")
        block, layers = GELAN_SPEC[variant]
        self.conv1 = ConvBnAct(3, 64, 3, 2, dtype=dtype)
        self.conv2 = ConvBnAct(64, 128, 3, 2, dtype=dtype)
        self.cspelan1 = GELANBlock(128, 128, 128, 64, block, layers[0],
                                   dtype=dtype)
        self.down1 = ConvBnAct(128, 256, 3, 2, dtype=dtype)
        self.cspelan2 = GELANBlock(256, 256, 256, 128, block, layers[1],
                                   dtype=dtype)
        self.down2 = ConvBnAct(256, 512, 3, 2, dtype=dtype)
        self.cspelan3 = GELANBlock(512, 512, 512, 256, block, layers[2],
                                   dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        x = self.down1(self.cspelan1(x))
        x = self.down2(self.cspelan2(x))
        return self.cspelan3(x)
