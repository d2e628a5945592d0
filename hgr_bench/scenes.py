"""Seeded inputs of the serving cells: camera frames with one synthetic
hand each, and hand crops (copies of ``chip_smoke.py:_scenes`` and of
``data/synthetic.py:make_hand_image``, the crops the committed
detector weights were trained on). Backgrounds and noise are drawn on
the card in bulk; the hands are drawn with numpy and pasted on the
host, where the clients hold their inputs."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FINGER_CHAINS = [[0, 1, 2, 3, 4], [0, 5, 6, 7, 8], [0, 9, 10, 11, 12],
                 [0, 13, 14, 15, 16], [0, 17, 18, 19, 20]]


def hand(rng: np.random.RandomState, size: int) -> np.ndarray:
    """A (size, size, 3) BGR uint8 crop: a gradient background and 21
    joint blobs along five finger chains from a wrist near the centre."""
    img = np.zeros((size, size, 3), np.uint8)
    base = rng.randint(20, 120, 3)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(3):
        img[..., c] = np.clip(base[c] + 60 * yy + 40 * xx * rng.rand(), 0,
                              255).astype(np.uint8)
    wrist = np.array([size * (0.47 + 0.06 * rng.rand()),
                      size * (0.5 + 0.06 * rng.rand())])
    joints = np.zeros((21, 2), np.float32)
    joints[0] = wrist
    for f, chain in enumerate(FINGER_CHAINS):
        angle = np.deg2rad(-90 + (f - 2) * 18 + rng.randn() * 5)
        direction = np.array([np.cos(angle), np.sin(angle)])
        for k, j in enumerate(chain[1:], start=1):
            joints[j] = wrist + direction * size * 0.025 * k \
                + rng.randn(2) * 1.0
    joints = np.clip(joints, 2, size - 3)
    color = rng.randint(120, 255, 3).tolist()
    for x, y in joints.astype(int):
        img[max(0, y - 4):y + 5, max(0, x - 4):x + 5] = color
    return img


def frames(n: int, frame_hw: Tuple[int, int], side_range, seed: int,
           gen: torch.Generator) -> np.ndarray:
    """(n, H, W, 3) uint8 BGR frames: per frame a base colour, two
    gradients and N(0, 8) noise, drawn on the generator's device, and one
    hand of a side in ``side_range`` pasted at a place drawn from
    ``seed``."""
    fh, fw = frame_hw
    dev = gen.device
    base = torch.randint(30, 160, (n, 1, 1, 3), generator=gen, device=dev)
    ramps = torch.rand((n, 2, 1, 1, 3), generator=gen, device=dev) * 50
    yy = torch.linspace(0, 1, fh + 1, device=dev)[:fh, None, None]
    xx = torch.linspace(0, 1, fw + 1, device=dev)[None, :fw, None]
    out = np.empty((n, fh, fw, 3), np.uint8)
    rng = np.random.RandomState(seed % 2**32)
    for i in range(0, n, 64):
        j = min(n, i + 64)
        noise = torch.randn((j - i, fh, fw, 3), generator=gen, device=dev)
        img = (base[i:j] + ramps[i:j, 0] * yy + ramps[i:j, 1] * xx
               + noise * 8.0)
        out[i:j] = torch.clamp(img, 0, 255).to(torch.uint8).cpu().numpy()
    for i in range(n):
        side = rng.randint(side_range[0], side_range[1] + 1)
        x0, y0 = rng.randint(0, fw - side + 1), rng.randint(0, fh - side + 1)
        out[i, y0:y0 + side, x0:x0 + side] = hand(rng, side)
    return out


def crops(n: int, size: int, seed: int) -> np.ndarray:
    """(n, size, size, 3) uint8 BGR hand crops."""
    rng = np.random.RandomState(seed % 2**32)
    return np.stack([hand(rng, size) for _ in range(n)])
