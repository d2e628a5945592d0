"""Synthetic dataset in the reference annotation format (port of
hgr_tpu/data/synthetic.py).

Hand-crop-like images (a background gradient and 21 joint blobs along
five finger chains) with known landmarks, written as JPEGs with PIL and
per-split JSON as ``extract_data.py`` lays them out (reference
extract_data.py:152-165), so the reader -> loader -> train stack runs
end to end without HaGRID. The pixels and landmarks of a seed are the
JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from hgr_tpu_torch.config import DEFAULT_NAMES

# 5-finger chain topology (reference libs/draw.py:5-9).
FINGER_CHAINS = [
    [0, 1, 2, 3, 4], [0, 5, 6, 7, 8], [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16], [0, 17, 18, 19, 20],
]


def make_hand_image(
    rng: np.random.RandomState,
    size: int = 224,
    num_joints: int = 21,
    blob_color: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic crop: (img uint8 (size, size, 3) BGR, joints (J, 2)
    pixels). The hand sits in the central ~30% the training crop samples
    (reference libs/load.py:69-70); ``blob_color`` (BGR) keys the joint
    color, so a label-derived color makes the class learnable."""
    img = np.zeros((size, size, 3), np.uint8)
    base = rng.randint(20, 120, 3)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for c in range(3):
        img[..., c] = np.clip(
            base[c] + 60 * yy + 40 * xx * rng.rand(), 0, 255).astype(np.uint8)

    wrist = np.array([size * (0.47 + 0.06 * rng.rand()),
                      size * (0.5 + 0.06 * rng.rand())])
    joints = np.zeros((num_joints, 2), np.float32)
    joints[0] = wrist
    for f, chain in enumerate(FINGER_CHAINS):
        angle = np.deg2rad(-90 + (f - 2) * 18 + rng.randn() * 5)
        direction = np.array([np.cos(angle), np.sin(angle)])
        for k, j in enumerate(chain[1:], start=1):
            joints[j] = wrist + direction * size * 0.025 * k \
                + rng.randn(2) * 1.0
    joints = np.clip(joints, 2, size - 3)

    color = (list(blob_color) if blob_color is not None
             else rng.randint(120, 255, 3).tolist())
    for j in range(num_joints):
        x, y = int(joints[j, 0]), int(joints[j, 1])
        r = 4
        y0, y1 = max(0, y - r), min(size, y + r + 1)
        x0, x1 = max(0, x - r), min(size, x + r + 1)
        img[y0:y1, x0:x1] = color
    return img, joints


def write_synthetic_split(
    out_dir: str,
    split: str,
    num_images: int,
    names: Optional[Dict[str, int]] = None,
    image_size: int = 224,
    seed: int = 0,
) -> str:
    """Write ``<out_dir>/<split>/*.jpg`` and ``<out_dir>/annotations/
    <split>/<split>.json`` in the reference layout (libs/load.py:208-228:
    images at json_path.parents[2]/<json_stem>/<image_id>.jpg). Every
    17th sample has an empty landmark list (load.py:84-86). The joint
    color is keyed by the label, so the class is learnable from pixels.
    Returns the annotation directory of the split.
    """
    names = names or DEFAULT_NAMES
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, split)
    ann_dir = os.path.join(out_dir, "annotations", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    label_names = list(names.keys())
    annots = {}
    for i in range(num_images):
        label_id = i % len(label_names)
        # channels a third of the hue wheel apart (synthetic.py:99-104)
        hue = label_id / max(len(label_names), 1)
        blob = [int(60 + 195 * ((hue + k / 3.0) % 1.0)) for k in range(3)]
        img, joints = make_hand_image(rng, image_size, blob_color=blob)
        image_id = f"syn_{split}_{i:05d}"
        write_jpeg(os.path.join(img_dir, image_id + ".jpg"), img)
        landmark = [] if i % 17 == 16 else (joints / image_size).tolist()
        annots[image_id] = {"label": label_names[label_id],
                            "landmark": landmark}
    with open(os.path.join(ann_dir, split + ".json"), "w") as f:
        json.dump(annots, f)
    return ann_dir


def write_jpeg(path: str, img: np.ndarray) -> None:
    """A BGR uint8 image as a quality-95 JPEG (PIL)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(path,
                                                               quality=95)
