"""Two-stage inference: YOLOv7-tiny detect -> crop -> classify (port of
hgr_tpu/infer/detect.py; reference detect.py:48-207).

Per batch of full BGR uint8 frames, on the pipeline's device:

* letterbox to the detector size (reference letterbox, detect.py:15-45:
  r = min(new / h, new / w), half-pixel bilinear resize, pad 114), BGR ->
  RGB for the detector only, / 255;
* the top-1 box (detect.py:129), un-letterboxed, expanded to a square of
  its longer side (detect.py:130-138); the score gate 0.2 (detect.py:140)
  is applied on the host;
* the classifier crop by an affine warp of the ORIGINAL BGR frame
  (detect.py:92-117: / 255 and the ImageNet normalize, no channel swap),
  through the exact warp ``ops/warp.py:batched_affine_warp``, as the JAX
  pipeline uses its exact warp and not the Pallas kernel;
* argmax label, and the heatmap argmax landmarks mapped back to frame
  coordinates (detect.py:149-157).

The JAX package jits this graph per frame geometry; the port runs it
eagerly and keeps the per-geometry constants (letterbox geometry, resize
taps) in a cache of at most 8 geometries, as hgr_tpu/infer/detect.py
:87-101 bounds its graphs. Divisions by Python scalars go through
``ops/color.py:true_divide``: on CUDA a division by a scalar multiplies
by its reciprocal, which would move boxes and crops an ulp away from the
CPU's. The classifier's forward launches the attention forward kernel on
the card (4 launches per batch at the default depth). cv2 is imported
only for video and drawing (``annotate``, ``iter_frames``,
``detect_to_video``).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from hgr_tpu_torch.infer.weights import build_classifier
from hgr_tpu_torch.models.multitasknet import heatmaps_to_nchw
from hgr_tpu_torch.models.yolo import YOLOv7Tiny, best_box, decode_predictions
from hgr_tpu_torch.ops.affine import build_affine
from hgr_tpu_torch.ops.color import true_divide
from hgr_tpu_torch.ops.heatmap import get_max_preds
from hgr_tpu_torch.ops.resize import resize_bilinear, resize_taps
from hgr_tpu_torch.ops.warp import batched_affine_warp

_GEOMETRIES = 8  # frame geometries whose constants the pipeline keeps


def letterbox_params(h: int, w: int, new: int
                     ) -> Tuple[float, float, float, int, int]:
    """Letterbox geometry (reference detect.py:15-45, auto=False):
    (r, dw, dh, new_unpad_w, new_unpad_h); Python's round, half to
    even."""
    r = min(new / h, new / w)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw = (new - new_unpad[0]) / 2
    dh = (new - new_unpad[1]) / 2
    return r, dw, dh, new_unpad[0], new_unpad[1]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (no entry point falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} but torch sees no CUDA card; pass device "
            "'cpu' to run on the CPU")
    return dev


class HandGesturePipeline:
    """Both models, in eval mode on ``device``, and the per-frame graph.

    ``classifier_state`` / ``detector_state``: the port's state_dicts
    (``infer/weights.py``). ``dtype``: the compute type of both models
    (bf16 on the serving path). The card unless ``device='cpu'``.
    """

    def __init__(self, classifier_state: Dict[str, torch.Tensor],
                 detector_state: Dict[str, torch.Tensor],
                 class_names: Dict[str, int], det_img_size: int = 416,
                 cls_img_size: Tuple[int, int] = (192, 192),
                 score_thresh: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone: str = "auto", device="cuda"):
        self.device = resolve_device(device)
        # an int8 state (``quant`` entries) builds the int8 backbone, so
        # /detect serves the classifier /classify serves
        self.classifier = build_classifier(
            classifier_state, cls_img_size, dtype, backbone, self.device)
        self.detector = YOLOv7Tiny(num_classes=1, dtype=dtype)
        self.detector.load_state_dict(detector_state, strict=True)
        self.detector = self.detector.eval().to(self.device)
        self.det_img_size = det_img_size
        self.cls_img_size = tuple(cls_img_size)
        self.score_thresh = score_thresh
        self.id_to_name = {v: k for k, v in class_names.items()}
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)
        self._geometries: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.batches = 0  # batches run (each one classifier forward)

    def geometry(self, frame_h: int, frame_w: int) -> Dict[str, Any]:
        """The letterbox constants of one frame geometry, cached (at most
        ``_GEOMETRIES``, the oldest dropped first)."""
        key = (frame_h, frame_w)
        if key not in self._geometries:
            while len(self._geometries) >= _GEOMETRIES:
                self._geometries.pop(next(iter(self._geometries)))
            det = self.det_img_size
            r, dw, dh, uw, uh = letterbox_params(frame_h, frame_w, det)
            top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
            self._geometries[key] = {
                "r": r, "unpad_hw": (uh, uw),
                # F.pad order: channels, then W, then H
                "pad": (0, 0, left, det - uw - left, top, det - uh - top),
                "offset": torch.tensor([dw, dh, dw, dh], dtype=torch.float32,
                                       device=self.device),
                "taps": resize_taps((frame_h, frame_w), (uh, uw),
                                    self.device)}
        return self._geometries[key]

    def letterbox(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) BGR frames (float32, 0-255) -> the detector's
        (B, S, S, 3) RGB input in [0, 1]: resized by r, padded with 114."""
        geo = self.geometry(*frames.shape[1:3])
        resized = resize_bilinear(frames.flip(-1), geo["unpad_hw"],
                                  geo["taps"])
        return true_divide(F.pad(resized, geo["pad"], value=114.0), 255.0)

    def run(self, frames_u8: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) uint8 BGR frames on the pipeline's device ->
        (labels (B,), scores (B,), boxes (B, 4), landmarks (B, J, 2)) on
        the device, in frame pixels; enqueued, not synchronized."""
        geo = self.geometry(*frames_u8.shape[1:3])
        with torch.inference_mode():
            frames = frames_u8.float()
            outs = self.detector(self.letterbox(frames))
            boxes, scores = best_box(decode_predictions(outs, num_classes=1))

            boxes = torch.round(true_divide(boxes - geo["offset"], geo["r"]))
            side = torch.maximum(boxes[:, 2] - boxes[:, 0],
                                 boxes[:, 3] - boxes[:, 1])
            cx = (boxes[:, 0] + boxes[:, 2]) / 2.0
            cy = (boxes[:, 1] + boxes[:, 3]) / 2.0
            corner = torch.stack([cx - side / 2.0, cy - side / 2.0], dim=-1)

            cls_h, cls_w = self.cls_img_size
            m = build_affine(torch.stack([cx, cy], dim=-1),
                             torch.ones_like(side), torch.zeros_like(side),
                             side, (float(cls_w), float(cls_h)))
            crop = batched_affine_warp(frames, m, (cls_h, cls_w))
            cls_in = (true_divide(crop, 255.0) - self._mean) / self._std
            logits, hmap, _ = self.classifier(cls_in, need_attnmap=False)
            labels = torch.argmax(logits, dim=-1)
            hm = heatmaps_to_nchw(hmap)
            lm, _ = get_max_preds(hm)
            hm_wh = torch.tensor([hm.shape[-1], hm.shape[-2]],
                                 dtype=torch.float32, device=lm.device)
            lm = lm / hm_wh * side[:, None, None] + corner[:, None, :]
        self.batches += 1
        return labels, scores, boxes, lm

    def infer_frame(self, frame_bgr: np.ndarray):
        """One (H, W, 3) BGR uint8 frame -> its result dict, or None when
        the score fails the gate (reference detect.py:140)."""
        return self.infer_frames(frame_bgr[None])[0]

    def infer_frames(self, frames_bgr: np.ndarray) -> List[Optional[dict]]:
        """A (B, H, W, 3) batch of BGR uint8 frames -> per-frame dicts
        (None where the score gate fails)."""
        return self.finish_frames(self.dispatch_frames(frames_bgr))

    def dispatch_frames(self, frames_bgr: np.ndarray):
        """Stage the batch and enqueue the graph on the device's stream;
        returns a handle without waiting (pairs with ``finish_frames``,
        so the host can decode and encode while the card computes)."""
        x = torch.from_numpy(np.ascontiguousarray(frames_bgr, np.uint8))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return self.run(x)

    def finish_frames(self, handle) -> List[Optional[dict]]:
        """Bring a ``dispatch_frames`` handle to the host as per-frame
        dicts (label, label_name, score, box int32 (4,), landmarks int32
        (J, 2)), None where the score is at or below the gate."""
        labels, scores, boxes, lms = (t.cpu().numpy() for t in handle)
        boxes = boxes.astype(np.int32)
        lms = lms.astype(np.int32)
        results = []
        for i in range(len(scores)):
            if scores[i] <= self.score_thresh:
                results.append(None)
                continue
            results.append({
                "label": int(labels[i]),
                "label_name": self.id_to_name.get(int(labels[i]),
                                                  str(int(labels[i]))),
                "score": float(scores[i]),
                "box": boxes[i],
                "landmarks": lms[i],
            })
        return results

    def annotate(self, frame_bgr: np.ndarray, result) -> np.ndarray:
        """Skeleton, box and label drawn on the frame (reference
        detect.py:159-167); the box and label need cv2."""
        if result is None:
            return frame_bgr
        from hgr_tpu_torch.utils.draw import draw_bones, draw_joints

        frame = draw_bones(frame_bgr, result["landmarks"])
        frame = draw_joints(frame, result["landmarks"])
        try:
            import cv2
        except ImportError:
            return frame
        b = result["box"]
        frame = cv2.rectangle(frame, (int(b[0]), int(b[1])),
                              (int(b[2]), int(b[3])), (0, 255, 0), 2)
        return cv2.putText(
            frame, "Prediction: {}".format(result["label_name"]),
            (int(b[0]), int(b[1]) - 10), cv2.FONT_HERSHEY_SIMPLEX, 1,
            (0, 255, 0), 2)


def iter_frames(data_path: str) -> Iterator[np.ndarray]:
    """BGR frames of a video file (cv2) or of a directory's .png then .jpg
    images in name order (cv2, else PIL) (reference detect.py:179-205)."""
    if os.path.isfile(data_path):
        import cv2

        cap = cv2.VideoCapture(data_path)
        if not cap.isOpened():
            raise IOError(f"error opening video file {data_path}")
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                yield frame
        finally:
            cap.release()
        return
    files = sorted(glob.glob(os.path.join(data_path, "*.png")))
    files += sorted(glob.glob(os.path.join(data_path, "*.jpg")))
    for f in files:
        try:
            import cv2
        except ImportError:
            from PIL import Image

            with Image.open(f) as im:
                yield np.ascontiguousarray(
                    np.asarray(im.convert("RGB"))[..., ::-1])
            continue
        frame = cv2.imread(f)
        if frame is None:  # cv2 returns None instead of raising
            raise ValueError(f"fail to read {f}")
        yield frame


def detect_to_video(pipeline: HandGesturePipeline, data_path: str,
                    save_path: str, fps: float = 30.0,
                    out_size: Tuple[int, int] = (640, 360),
                    batch_frames: int = 1, show: bool = False,
                    pipeline_depth: int = 3) -> int:
    """A video or a directory of images -> an annotated mp4v video
    (reference detect.py:171-207); returns the frames written.

    Three overlapped stages, as the JAX package's: a decode thread fills a
    bounded queue with chunks of up to ``batch_frames`` same-geometry
    frames; the main thread dispatches each chunk to the device without
    waiting (up to ``pipeline_depth`` in flight) and annotates and encodes
    the oldest in FIFO order."""
    import cv2

    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, out_size)
    if not writer.isOpened():
        raise IOError(f"cv2 could not open an mp4v writer for {save_path}")
    n = 0
    stop_ev = threading.Event()
    depth = max(int(pipeline_depth), 1)
    chunks: "queue.Queue" = queue.Queue(maxsize=depth + 1)

    def put(item) -> None:
        while not stop_ev.is_set():
            try:
                chunks.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer() -> None:
        chunk: list = []
        try:
            for frame in iter_frames(data_path):
                if stop_ev.is_set():
                    return
                if chunk and frame.shape != chunk[0].shape:
                    put(chunk)
                    chunk = []
                chunk.append(frame)
                if len(chunk) >= batch_frames:
                    put(chunk)
                    chunk = []
            if chunk:
                put(chunk)
        except BaseException as exc:  # noqa: BLE001 — re-raised in main
            put(exc)
        finally:
            put(None)

    def drain_one(inflight) -> None:
        nonlocal n
        chunk, handle = inflight.popleft()
        for frame, result in zip(chunk, pipeline.finish_frames(handle)):
            frame = pipeline.annotate(frame, result)
            if (frame.shape[1], frame.shape[0]) != tuple(out_size):
                frame = cv2.resize(frame, tuple(out_size))
            writer.write(frame)
            n += 1
            if show:  # interactive preview (reference detect.py:191-192)
                cv2.imshow("frame", frame)
                if cv2.waitKey(50) & 0xFF == ord("q"):
                    stop_ev.set()
                    return

    t = threading.Thread(target=producer, name="video-decode", daemon=True)
    t.start()
    inflight: deque = deque()
    try:
        while not stop_ev.is_set():
            item = chunks.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if len(inflight) >= depth:
                drain_one(inflight)
            inflight.append((item, pipeline.dispatch_frames(np.stack(item))))
        while inflight and not stop_ev.is_set():
            drain_one(inflight)
    finally:
        stop_ev.set()  # unblocks a producer waiting on a full queue
        t.join(timeout=5.0)
        writer.release()
        if show:
            cv2.destroyAllWindows()
    return n
