"""Host batch loader: decode -> stage -> prefetch (port of
hgr_tpu/data/loader.py; replaces the reference's DataLoader workers,
libs/load.py:280-305).

Each batch is a dict of numpy arrays in the staged layout the train step
takes: canvas (B, S, S, 3) uint8, orig_to_canvas (B, 2, 3) f32, sizes_hw
(B, 2) f32, joints (B, J, 2) f32 in original pixels, joints_vis (B, J)
f32, label (B,) int32 and valid (B,) f32. Every batch has ``batch_size``
rows: without ``drop_last`` the tail batch repeats samples and ``valid``
masks the repeats. The shuffle of epoch e is ``RandomState(seed + e)``.
A whole batch is decoded and staged by the native library when it is
available and every file is a JPEG, else per image on a thread pool
(native decode, then PIL) with ``stage_image``. A producer thread keeps
``prefetch`` batches ready.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import warnings
from typing import Dict, Iterator

import numpy as np

from hgr_tpu_torch.data import native
from hgr_tpu_torch.data.dataset import AnnotationIndex
from hgr_tpu_torch.data.pipeline import stage_image


def _decode_image(path: str) -> np.ndarray:
    """Decode to BGR uint8 (the reference trains on cv2's BGR,
    libs/load.py:54): the native decoder, else PIL."""
    img = native.decode_jpeg_bgr(path)
    if img is not None:
        return img
    from PIL import Image

    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


class BatchLoader:
    """Iterable of staged numpy batches in the train step's layout."""

    def __init__(self, index: AnnotationIndex, batch_size: int,
                 canvas_size: int = 256, num_joints: int = 21,
                 shuffle: bool = False, seed: int = 42,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, window_frac: float = 0.75):
        self.index = index
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.window_frac = window_frac
        self.num_joints = num_joints
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = 0
        self._labels = index.labels()
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(self.num_workers)
            if self.num_workers > 1 else None)

    def __len__(self) -> int:
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _joints(self, i: int, h: float, w: float):
        """Sample i's landmarks denormalized to (h, w) pixels (reference
        libs/load.py:66-67), zero-padded to ``num_joints``, with their
        visibility."""
        lm = np.asarray(self.index.samples[i].landmark,
                        np.float32).reshape(-1, 2)
        joints = np.zeros((self.num_joints, 2), np.float32)
        vis = np.zeros((self.num_joints,), np.float32)
        if lm.shape[0]:
            joints[: lm.shape[0], 0] = lm[:, 0] * w
            joints[: lm.shape[0], 1] = lm[:, 1] * h
            vis[: lm.shape[0]] = 1.0
        return joints, vis

    def _load_one(self, i: int):
        img = _decode_image(self.index.samples[i].image_path)
        canvas, affine, (h, w) = stage_image(img, self.canvas_size,
                                             self.window_frac)
        joints, vis = self._joints(i, h, w)
        return canvas, affine, (h, w), joints, vis

    def _assemble(self, ids: np.ndarray, valid: int) -> Dict[str, np.ndarray]:
        bs, cs = self.batch_size, self.canvas_size
        batch = {
            "canvas": np.zeros((bs, cs, cs, 3), np.uint8),
            "orig_to_canvas": np.zeros((bs, 2, 3), np.float32),
            "sizes_hw": np.zeros((bs, 2), np.float32),
            "joints": np.zeros((bs, self.num_joints, 2), np.float32),
            "joints_vis": np.zeros((bs, self.num_joints), np.float32),
            "label": self._labels[ids].astype(np.int32),
        }
        if not self._native_batch(ids, batch):
            if self._pool is not None:
                results = list(self._pool.map(self._load_one, ids))
            else:
                results = [self._load_one(i) for i in ids]
            for k, (canvas, affine, hw, joints, vis) in enumerate(results):
                batch["canvas"][k] = canvas
                batch["orig_to_canvas"][k] = affine
                batch["sizes_hw"][k] = hw
                batch["joints"][k] = joints
                batch["joints_vis"][k] = vis
        mask = np.zeros((bs,), np.float32)
        mask[:valid] = 1.0
        batch["valid"] = mask
        return batch

    def _native_batch(self, ids: np.ndarray,
                      batch: Dict[str, np.ndarray]) -> bool:
        """Decode and stage the whole batch through the native library;
        False (nothing written that counts) when it is unavailable, a
        file is not a JPEG, or any decode fails."""
        if not native.available():
            return False
        paths = [self.index.samples[i].image_path for i in ids]
        if not all(p.endswith((".jpg", ".jpeg")) for p in paths):
            return False
        res = native.stage_batch(
            paths, self.canvas_size, num_threads=self.num_workers,
            out_canvases=batch["canvas"], out_affines=batch["orig_to_canvas"],
            out_sizes=batch["sizes_hw"], window_frac=self.window_frac)
        if res is None or not res[3].all():
            return False
        for k, i in enumerate(ids):
            h, w = batch["sizes_hw"][k]
            batch["joints"][k], batch["joints_vis"][k] = self._joints(i, h, w)
        return True

    def _batch_ids(self) -> Iterator:
        """(sample ids, number of real rows) per batch of one epoch; the
        tail is padded by repetition unless ``drop_last``."""
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, n, bs):
            ids = order[start:start + bs]
            if len(ids) < bs:
                if self.drop_last:
                    return
                yield np.resize(ids, bs), len(ids)
                return
            yield ids, bs

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate with a producer thread ``prefetch`` batches ahead. A
        producer exception re-raises here; leaving the iterator early sets
        the producer's stop flag, drains the queue and joins the thread."""
        work: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        sentinel = object()
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    work.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ids, valid in self._batch_ids():
                    if stop.is_set() or not put(self._assemble(ids, valid)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = work.get()
                if item is sentinel:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            try:
                while True:
                    work.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
            if t.is_alive():
                warnings.warn("loader producer thread still alive after a "
                              "5 s join; abandoning it", RuntimeWarning,
                              stacklevel=2)
