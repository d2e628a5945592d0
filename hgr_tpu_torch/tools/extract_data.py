"""Offline HaGRID preprocessing: pseudo-label hands, crop, emit JSONs
(port of hgr_tpu/tools/extract_data.py; a host tool, as the JAX one is).

    python -m hgr_tpu_torch.tools.extract_data --root_dir <raw HaGRID> \\
        [--output_dir data/hagrid_small] [--num_workers 8]

Capability parity with reference extract_data.py:
  * MediaPipe Hands pseudo-labels 21 landmarks (max 2 hands, conf 0.5,
    extract_data.py:44-83) — gated on the mediapipe package (not baked
    into this image); a pluggable estimator hook lets any detector fill
    the role (including our own trained pose head);
  * IoU > 0.5 matching of landmark bbox vs GT gesture bbox
    (extract_data.py:14-41,130-133);
  * 3x-context crop via the shared affine geometry
    (extract_data.py:135-144) — computed with hgr_tpu_torch.ops.affine,
    warped with cv2;
  * outputs crop JPEGs + per-split JSON {label, landmark(normalized)}
    (extract_data.py:152-165) — exactly the format
    hgr_tpu_torch.data.dataset reads.

Unlike the reference (strictly serial over 550k+ images), extraction
fans out over a thread pool.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def calculate_iou(bbox1: Sequence[float], bbox2: Sequence[float]) -> float:
    """IoU of two (x, y, w, h) boxes (reference extract_data.py:14-41)."""
    x1, y1, w1, h1 = bbox1
    x2, y2, w2, h2 = bbox2
    x_left = max(x1, x2)
    y_top = max(y1, y2)
    x_right = min(x1 + w1, x2 + w2)
    y_bottom = min(y1 + h1, y2 + h2)
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bottom - y_top)
    union = w1 * h1 + w2 * h2 - inter
    return inter / union


class MediaPipeHandEstimator:
    """MediaPipe Hands wrapper (reference extract_data.py:44-83)."""

    def __init__(self, max_hands: int = 2, min_conf: float = 0.5):
        import mediapipe as mp

        self.mp_hands = mp.solutions.hands
        self.max_hands = max_hands
        self.min_conf = min_conf

    def __call__(self, img_bgr: np.ndarray
                 ) -> Tuple[np.ndarray, List[List[float]]]:
        import cv2

        landmarks, landmark_bbox = [], []
        with self.mp_hands.Hands(
                static_image_mode=True, max_num_hands=self.max_hands,
                min_detection_confidence=self.min_conf) as hands:
            results = hands.process(
                cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB))
        if results.multi_hand_landmarks:
            for hand in results.multi_hand_landmarks:
                landmarks.append([[j.x, j.y] for j in hand.landmark])
            landmarks = np.asarray(landmarks)
            landmarks[:, :, 0] *= img_bgr.shape[1]
            landmarks[:, :, 1] *= img_bgr.shape[0]
            for joint in landmarks:
                x_min, y_min = joint[:, 0].min(), joint[:, 1].min()
                w = joint[:, 0].max() - x_min
                h = joint[:, 1].max() - y_min
                landmark_bbox.append([x_min, y_min, w, h])
        return np.asarray(landmarks), landmark_bbox


def process_image(
    image_path: str,
    annots: Dict,
    image_save_path: str,
    estimator: Callable,
    context_scale: float = 3.0,
) -> Dict[str, Dict]:
    """One image -> one crop+annotation per GT bbox
    (reference extract_data.py:113-165)."""
    import cv2
    import torch

    from hgr_tpu_torch.ops.affine import build_affine, transform_points

    img = cv2.imread(image_path)
    if img is None:
        return {}
    img_h, img_w = img.shape[:2]
    image_id = Path(image_path).stem

    landmarks, landmark_bbox = estimator(img)

    out = {}
    for idx, (bbox, label) in enumerate(
            zip(annots["bboxes"], annots["labels"])):
        x, y, w, h = bbox
        x, y = int(x * img_w), int(y * img_h)
        w, h = int(w * img_w), int(h * img_h)

        joints = np.zeros((0, 2))
        for i, l_bbox in enumerate(landmark_bbox):
            if calculate_iou([x, y, w, h], l_bbox) > 0.5:
                joints = landmarks[i]

        c = np.array([x + w / 2, y + h / 2], dtype=np.float32)
        original_size = max(w, h)
        target_size = (original_size, original_size)
        trans = build_affine(
            c, context_scale, 0.0, float(original_size),
            (float(target_size[0]), float(target_size[1]))).numpy()
        crop = cv2.warpAffine(img, trans, target_size,
                              flags=cv2.INTER_LINEAR)
        if joints.shape[0]:
            joints = transform_points(torch.as_tensor(joints),
                                      torch.from_numpy(trans)).numpy()
            joints[:, 0] /= target_size[0]
            joints[:, 1] /= target_size[1]

        cv2.imwrite(
            os.path.join(image_save_path, f"{image_id}-{idx}.jpg"), crop)
        out[f"{image_id}-{idx}"] = {
            "label": label,
            "landmark": joints.tolist(),
        }
    return out


class HagridDataExtractor:
    """Walks HaGRID annotation JSONs and emits the extracted dataset
    (reference extract_data.py:86-165), parallel over images."""

    def __init__(self, root_dir: str, output_dir: str,
                 estimator: Optional[Callable] = None,
                 num_workers: int = 8):
        self.root_dir = root_dir
        self.output_dir = output_dir
        self.estimator = estimator
        self.num_workers = num_workers

    def extract(self, annot_dir: str) -> None:
        estimator = self.estimator or MediaPipeHandEstimator()
        for json_file_path in sorted(glob.glob(
                os.path.join(self.root_dir, annot_dir, "*.json"))):
            with open(json_file_path) as f:
                data = json.load(f)
            # name = gesture (json stem) -> crop dir; action = SPLIT (the
            # annot_dir stem, e.g. 'train') -> annotations/<split>/ — the
            # layout data.dataset.read_annotations consumes (reference
            # extract_data.py:99-100,105-107).
            name = Path(json_file_path).stem
            action = Path(annot_dir).stem

            image_save_path = os.path.join(self.output_dir, name)
            os.makedirs(image_save_path, exist_ok=True)
            annots_save_path = os.path.join(
                self.output_dir, "annotations", action)
            os.makedirs(annots_save_path, exist_ok=True)

            tasks = [
                (os.path.join(self.root_dir, name, image_id + ".jpg"),
                 annots)
                for image_id, annots in data.items()]
            new_annots: Dict[str, Dict] = {}
            with concurrent.futures.ThreadPoolExecutor(
                    self.num_workers) as ex:
                futures = [
                    ex.submit(process_image, p, a, image_save_path,
                              estimator)
                    for p, a in tasks]
                for fut in concurrent.futures.as_completed(futures):
                    new_annots.update(fut.result())

            with open(os.path.join(
                    annots_save_path, name + ".json"), "w") as f:
                json.dump(new_annots, f, indent=4)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, default='',
                        help='root directory of raw HaGRID data')
    parser.add_argument('--output_dir', type=str,
                        default='data/hagrid_small')
    parser.add_argument('--num_workers', type=int, default=8)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    extractor = HagridDataExtractor(args.root_dir, args.output_dir,
                                    num_workers=args.num_workers)
    for split in ("annotations/train", "annotations/val",
                  "annotations/test"):
        extractor.extract(split)


if __name__ == "__main__":
    main()
