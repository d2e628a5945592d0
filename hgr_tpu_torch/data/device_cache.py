"""Device-resident dataset cache: stage each sample once, then serve every
epoch by gathering on the card (port of hgr_tpu/data/device_cache.py,
single device).

``DeviceCacheLoader`` streams the split once through the host loader
(decode + stage) into preallocated device tensors, and every batch after
that is an ``index_select`` on the device: no host-to-device canvas bytes
per epoch. The shuffle order, tail padding and ``valid`` masks come from
``BatchLoader._batch_ids`` with the same seed, so a cached epoch and a
streaming epoch see the same batches. The cache holds each key as flat
``(n, features)`` rows (``_flat_shapes``), the JAX package's layout.

Disk snapshot (``snapshot_dir``): the first build also writes the staged
flat rows as per-key ``.npy`` files plus ``manifest.json``, keyed by a
fingerprint of the annotations and staging parameters and one of the
image files' byte sizes; later runs fill the cache from the files and
skip decode and staging. The format is the JAX package's byte for byte
(same ``SNAPSHOT_VERSION``, fingerprints, manifest and files), so a
snapshot written by either package serves the other. A split whose image
files are all gone is served on the annotation fingerprint alone; a stale
or partial snapshot is rebuilt (data files, then the manifest, commit by
atomic rename).

The sharded cache over several cards waits for multi-GPU training
(ROADMAP A12).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import warnings
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from hgr_tpu_torch.data.loader import BatchLoader
from hgr_tpu_torch.train.state import resolve_device

_CACHED_KEYS = ("canvas", "orig_to_canvas", "sizes_hw", "joints",
                "joints_vis", "label")

SNAPSHOT_VERSION = 1
_MANIFEST = "manifest.json"


def index_fingerprint(index, canvas_size: int, num_joints: int,
                      window_frac: float) -> str:
    """Identity of the staged content of a split: the annotations (image
    paths, labels, landmarks) and the staging parameters. Pixel content
    is covered by ``sizes_fingerprint``."""
    h = hashlib.sha256()
    h.update(f"v{SNAPSHOT_VERSION}|{canvas_size}|{num_joints}|"
             f"{window_frac:.6f}|{len(index)}".encode())
    for s in index.samples:
        h.update(s.image_path.encode())
        h.update(b"|")
        h.update(s.label.encode())
        h.update(np.asarray(s.landmark, np.float32).tobytes())
        h.update(b"\n")
    return h.hexdigest()


def sizes_fingerprint(index):
    """(digest of the image files' byte sizes, number of missing files)."""
    h = hashlib.sha256()
    missing = 0
    for s in index.samples:
        try:
            h.update(str(os.path.getsize(s.image_path)).encode())
        except OSError:
            missing += 1
            h.update(b"?")
        h.update(b"|")
    return h.hexdigest(), missing


def _snapshot_load(snap_dir: str, fingerprint: str, get_sizes_fp, n: int,
                   spec) -> Optional[Dict[str, np.ndarray]]:
    """Memory-mapped snapshot rows, or None when absent, stale or corrupt.
    ``get_sizes_fp`` returns ``sizes_fingerprint(index)`` (memoized by the
    caller: the writer of a rebuild needs the same digest)."""
    try:
        with open(os.path.join(snap_dir, _MANIFEST)) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    stale = (man.get("version") != SNAPSHOT_VERSION
             or man.get("n") != n
             or man.get("fingerprint") != fingerprint)
    if not stale and "sizes_fingerprint" in man:
        sizes_fp, missing = get_sizes_fp()
        # changed image bytes under unchanged annotations are stale, but a
        # split whose files are all gone is served on the annotations
        stale = sizes_fp != man["sizes_fingerprint"] and missing < n
    if stale:
        warnings.warn(
            f"device-cache snapshot at {snap_dir} is stale (dataset or "
            "staging params changed); rebuilding from images",
            RuntimeWarning, stacklevel=3)
        return None
    out = {}
    for k, (flat, _, dt) in spec.items():
        try:
            arr = np.load(os.path.join(snap_dir, k + ".npy"), mmap_mode="r")
        except (OSError, ValueError):
            return None
        if arr.shape != (n, flat) or arr.dtype != np.dtype(dt):
            return None
        out[k] = arr
    return out


class _SnapshotWriter:
    """Writes staged flat rows into per-key ``.npy.tmp`` memmaps, then
    commits by atomic rename: data files first, the manifest last."""

    def __init__(self, snap_dir: str, fingerprint: str, n: int, spec,
                 meta: Dict):
        self.dir, self.fingerprint, self.n, self.meta = (
            snap_dir, fingerprint, n, meta)
        os.makedirs(snap_dir, exist_ok=True)
        with contextlib.suppress(OSError):  # invalidate any prior snapshot
            os.remove(os.path.join(snap_dir, _MANIFEST))
        self.mm = {
            k: np.lib.format.open_memmap(
                os.path.join(snap_dir, k + ".npy.tmp"), mode="w+",
                dtype=np.dtype(dt), shape=(n, flat))
            for k, (flat, _, dt) in spec.items()
        }

    def write(self, key: str, start: int, rows: np.ndarray) -> None:
        self.mm[key][start:start + len(rows)] = rows

    def commit(self) -> None:
        for k, m in self.mm.items():
            m.flush()
            os.replace(os.path.join(self.dir, k + ".npy.tmp"),
                       os.path.join(self.dir, k + ".npy"))
        man = {"version": SNAPSHOT_VERSION, "fingerprint": self.fingerprint,
               "n": self.n, **self.meta}
        tmp = os.path.join(self.dir, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(man, f, indent=2)
        os.replace(tmp, os.path.join(self.dir, _MANIFEST))


def _flat_shapes(cs: int, num_joints: int):
    """Per key: (flat row length, trailing shape of a sample, dtype)."""
    return {
        "canvas": (cs * cs * 3, (cs, cs, 3), np.uint8),
        "orig_to_canvas": (6, (2, 3), np.float32),
        "sizes_hw": (2, (2,), np.float32),
        "joints": (num_joints * 2, (num_joints, 2), np.float32),
        "joints_vis": (num_joints, (num_joints,), np.float32),
        "label": (1, (), np.int32),
    }


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32}


class DeviceCacheLoader(BatchLoader):
    """``BatchLoader`` whose split lives on ``device``: built on the first
    iteration (from the snapshot when one is valid), then every batch is
    gathered there. Batches are tensors on ``device``; ``valid`` stays a
    numpy mask, as in the JAX package."""

    def __init__(self, *args, snapshot_dir: str = "", device="cuda",
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.snapshot_dir = snapshot_dir
        self.device = resolve_device(device)
        self._cache: Optional[Dict[str, torch.Tensor]] = None
        self.loaded_from_snapshot = False

    def _build_cache(self) -> None:
        n = len(self.index)
        spec = _flat_shapes(self.canvas_size, self.num_joints)
        cache = {k: torch.zeros((n, flat), dtype=_TORCH_DTYPES[np.dtype(dt)],
                                device=self.device)
                 for k, (flat, _, dt) in spec.items()}

        def write(block: Dict[str, np.ndarray], start: int) -> None:
            for k, v in block.items():
                # a snapshot's memmap is read-only: np.require copies it
                rows = torch.from_numpy(np.require(v, requirements="CW"))
                cache[k][start:start + len(v)].copy_(rows)

        self.loaded_from_snapshot = self._fill(write, spec, n)
        self._cache = cache
        self._spec = spec

    def _fill(self, write, spec, n: int) -> bool:
        """Fill the cache from the snapshot (host reads only) or by
        streaming the split through the host loader, writing the snapshot
        on the way when one is configured. Returns whether the snapshot
        served it."""
        snap_dir = self.snapshot_dir
        fp = ""
        sizes: list = []  # the per-file stat sweep, once for load + write

        def sizes_fp_once():
            if not sizes:
                sizes.append(sizes_fingerprint(self.index))
            return sizes[0]

        if snap_dir:
            fp = index_fingerprint(self.index, self.canvas_size,
                                   self.num_joints, self.window_frac)
            mm = _snapshot_load(snap_dir, fp, sizes_fp_once, n, spec)
            if mm is not None:
                # ~64 MB blocks (rows are canvas-dominated)
                rows = max(1, (64 << 20) // (self.canvas_size ** 2 * 3))
                for start in range(0, n, rows):
                    stop = min(n, start + rows)
                    write({k: mm[k][start:stop] for k in spec}, start)
                return True

        writer = None
        if snap_dir:
            writer = _SnapshotWriter(snap_dir, fp, n, spec, meta={
                "sizes_fingerprint": sizes_fp_once()[0],
                "canvas_size": self.canvas_size,
                "num_joints": self.num_joints,
                "window_frac": self.window_frac,
            })
        # stream in index order: batch b covers samples [b*bs, b*bs+valid)
        saved = (self.shuffle, self._epoch, self.drop_last)
        self.shuffle, self.drop_last = False, False
        try:
            start = 0
            for batch in BatchLoader.__iter__(self):
                valid = min(self.batch_size, n - start)
                flat = {k: np.ascontiguousarray(batch[k][:valid]).reshape(
                    valid, spec[k][0]) for k in _CACHED_KEYS}
                if writer is not None:
                    for k, v in flat.items():
                        writer.write(k, start, v)
                write(flat, start)
                start += valid
            if start != n:
                raise RuntimeError(f"cache fill covered {start}/{n} samples")
            if writer is not None:
                writer.commit()
        finally:
            self.shuffle, self._epoch, self.drop_last = saved
        return False

    def __iter__(self) -> Iterator[Dict]:
        if self._cache is None:
            self._build_cache()
        bs = self.batch_size
        for ids, valid in self._batch_ids():
            idx = torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
                self.device)
            batch = {k: torch.index_select(v, 0, idx).reshape(
                (bs,) + self._spec[k][1]) for k, v in self._cache.items()}
            mask = np.zeros((bs,), np.float32)
            mask[:valid] = 1.0
            batch["valid"] = mask
            yield batch
