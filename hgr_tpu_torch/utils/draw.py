"""Skeleton drawing: the 21-keypoint hand as 5 finger chains from the wrist
(the port's copy of hgr_tpu/utils/draw.py:28,46,64; reference
libs/draw.py:4-34: the same limb topology, a grayscale ramp per finger,
orange joints). Host-side numpy; cv2 draws when it imports (it is
imported inside the functions, never with the module), else the numpy
fallback does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Finger chains (reference libs/draw.py:5-9).
LIMBS = [
    [[0, 1], [1, 2], [2, 3], [3, 4]],
    [[0, 5], [5, 6], [6, 7], [7, 8]],
    [[0, 9], [9, 10], [10, 11], [11, 12]],
    [[0, 13], [13, 14], [14, 15], [15, 16]],
    [[0, 17], [17, 18], [18, 19], [19, 20]],
]
# Grayscale ramp per finger (reference libs/draw.py:12-25, BGR).
BONE_COLORS = [(33, 41, 48), (65, 75, 86), (96, 106, 116),
               (134, 143, 152), (168, 173, 180)]
JOINT_COLOR = (0, 165, 255)  # orange (reference libs/draw.py:31)


def draw_bones(img: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """Draw the 5 finger chains. ``annotations``: (21, 2) int pixel coords."""
    try:
        import cv2

        for chain, color in zip(LIMBS, BONE_COLORS):
            for a, b in chain:
                img = cv2.line(img, tuple(int(v) for v in annotations[a]),
                               tuple(int(v) for v in annotations[b]),
                               color, 3)
        return img
    except ImportError:
        for chain, color in zip(LIMBS, BONE_COLORS):
            for a, b in chain:
                _np_line(img, annotations[a], annotations[b], color, 3)
        return img


def draw_joints(img: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """Draw joint dots (reference libs/draw.py:30-34)."""
    try:
        import cv2

        for a in annotations:
            img = cv2.circle(img, tuple(int(v) for v in a), 1, JOINT_COLOR, 3)
        return img
    except ImportError:
        h, w = img.shape[:2]
        for a in annotations:
            x, y = int(a[0]), int(a[1])
            y0, y1 = max(0, y - 2), min(h, y + 3)
            x0, x1 = max(0, x - 2), min(w, x + 3)
            img[y0:y1, x0:x1] = JOINT_COLOR
        return img


def _np_line(img, p0, p1, color, thickness):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    h, w = img.shape[:2]
    t = thickness // 2
    for x, y in zip(xs, ys):
        y0, y1 = max(0, y - t), min(h, y + t + 1)
        x0, x1 = max(0, x - t), min(w, x + t + 1)
        img[y0:y1, x0:x1] = color
