"""The yardstick's counts at the cells' shapes, against values worked out
by hand from the published layer lists (2 FLOPs a multiply-add)."""

import json
from pathlib import Path

import pytest
import torch

from hgr_bench import counts

ROOT = Path(__file__).resolve().parents[1]


def conv(cin, cout, k, out_hw):
    return 2 * k * k * cin * cout * out_hw[0] * out_hw[1]


def mtn_small_by_hand(size):
    """GELAN small -> proj -> ViT (dim 256, depth 4, 8 x 32 heads, mlp
    256) -> the x4 pose head, listed layer by layer."""
    s2, s4, s8, s16 = size // 2, size // 4, size // 8, size // 16
    f = conv(3, 64, 3, (s2, s2)) + conv(64, 128, 3, (s4, s4))
    for c, s in ((128, s4), (256, s8), (512, s16)):
        h2 = c // 2  # hid1 = c, hid2 = c / 2; n = 1 block a chain
        f += conv(c, c, 1, (s, s))                      # cv1
        f += 4 * conv(h2, h2, 3, (s, s))                # cv2_0, cv3_0
        f += conv(c + 2 * h2, c, 1, (s, s))             # cv4
    f += conv(128, 256, 3, (s8, s8)) + conv(256, 512, 3, (s16, s16))
    f += conv(512, 256, 1, (s16, s16))                  # proj
    n, d = s16 * s16 + 1, 256
    per_layer = (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
                 + 2 * 2 * n * d * 256)
    f += 4 * per_layer + 2 * d * 19
    f += 2 * s4 * s16 * s16 * d + 2 * s4 * s16 * s4 * d  # align-corners x4
    f += conv(d, 21, 1, (s4, s4))
    return f


def yolo_tiny_by_hand(size):
    s = [size // k for k in (2, 4, 8, 16, 32)]

    def elan(cin, hid, out, r):
        return (2 * conv(cin, hid, 1, (r, r)) + 2 * conv(hid, hid, 3, (r, r))
                + conv(4 * hid, out, 1, (r, r)))

    f = conv(3, 32, 3, (s[0], s[0])) + conv(32, 64, 3, (s[1], s[1]))
    f += elan(64, 32, 64, s[1]) + elan(64, 64, 128, s[2])
    f += elan(128, 128, 256, s[3]) + elan(256, 256, 512, s[4])
    r = s[4]
    f += 2 * conv(512, 256, 1, (r, r)) + conv(1024, 256, 1, (r, r)) \
        + conv(512, 256, 1, (r, r))                      # SPP-CSP
    f += conv(256, 128, 1, (r, r)) + conv(256, 128, 1, (s[3], s[3]))
    f += elan(256, 64, 128, s[3])
    f += conv(128, 64, 1, (s[3], s[3])) + conv(128, 64, 1, (s[2], s[2]))
    f += elan(128, 32, 64, s[2])
    f += conv(64, 128, 3, (s[3], s[3])) + elan(256, 64, 128, s[3])
    f += conv(128, 256, 3, (r, r)) + elan(512, 128, 256, r)
    for ch, hw in ((128, s[2]), (256, s[3]), (512, s[4])):
        f += conv(ch // 2, ch, 3, (hw, hw)) + conv(ch, 18, 1, (hw, hw))
    return f


CFG = json.loads((ROOT / "configs" / "mtn_small.json").read_text())


@pytest.mark.parametrize("size", [192, 448])
def test_mtn_forward_flops(size):
    assert counts.mtn_forward_flops(CFG, (size, size)) == \
        mtn_small_by_hand(size)


def test_mtn_forward_flops_192_pinned():
    # 2.196 GMAC; SURVEY.md's profiler reading "≈ 4.38 GFLOP" is FLOPs
    assert mtn_small_by_hand(192) == 4_391_450_112


def test_yolo_forward_flops_416():
    assert counts.yolo_forward_flops(416) == yolo_tiny_by_hand(416)


@pytest.mark.parametrize("b,n,fwd_bytes,fwd_flops,bwd_flops", [
    (256, 145, 256 * 145 * 1024 * 2, 4 * 256 * 8 * 145 ** 2 * 32,
     8 * 256 * 8 * 145 ** 2 * 32),
    (64, 785, 64 * 785 * 1024 * 2, 4 * 64 * 8 * 785 ** 2 * 32,
     8 * 64 * 8 * 785 ** 2 * 32),
])
def test_attention_counts(b, n, fwd_bytes, fwd_flops, bwd_flops):
    nb, nf = counts.attention_fwd(b, n, 8, 32)
    assert (nb, nf) == (fwd_bytes, fwd_flops)
    nb, nf = counts.attention_bwd(b, n, 8, 32)
    assert (nb, nf) == (fwd_bytes * 7 // 4, bwd_flops)


def test_attention_bound_192():
    # (256, 145) forward: 76.0 MB at 3.35 TB/s = 22.7 us; 5.5 GFLOP at
    # 989 TFLOP/s = 5.6 us: bound by bytes
    nb, nf = counts.attention_fwd(256, 145, 8, 32)
    assert counts.bound_s(nb, nf) == pytest.approx(76_021_760 / 3.35e12)


@pytest.mark.parametrize("s,out,scale", [(256, 192, 1.0), (256, 192, 2.0),
                                          (512, 448, 1.5)])
def test_warp_footprint(s, out, scale):
    """A crop that upsamples the canvas by ``scale`` about its centre reads
    (out / scale)² canvas pixels."""
    m = torch.tensor([[[scale, 0.0, out / 2 - scale * s / 2],
                       [0.0, scale, out / 2 - scale * s / 2]]])
    fp = counts.warp_footprint_px(m, s, out, out)
    side = min(s, out / scale)
    assert float(fp[0]) == pytest.approx(side * side, rel=0.02)
    nb, nf = counts.warp(fp, torch.ones(1), out, out)
    assert nb == float(fp[0]) * 3 + out * out * 3
    assert nf == out * out * 45 + 60 * float(fp[0])
