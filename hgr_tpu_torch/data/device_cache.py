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

``ShardedDeviceCacheLoader`` is one data rank's cache on a pure-DP mesh
(hgr_tpu/data/device_cache.py:413-549): rank s keeps the contiguous
global samples [s·n_local, (s+1)·n_local) on its own device, shuffles
them within the shard each epoch, and yields its block of every global
batch. Its rows come from the same snapshot format: with a snapshot
directory the coordinator builds (or validates) the whole split's
snapshot, and after a barrier every rank reads its rows from it; without
one each rank stages its own samples. With ``microbatches`` (the step's
``grad_accum``) a rank yields its share of every microbatch of the global
batch (``parallel/mesh.py:shard_rows``), as the streaming loader does:
each rank gathers its block from its own cache, then one
``all_to_all_single`` over the data group moves every row to the rank
that holds it, on the calling thread, once a batch, in lockstep.
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
import torch.distributed as dist

from hgr_tpu_torch.data.dataset import AnnotationIndex
from hgr_tpu_torch.data.loader import BatchLoader
from hgr_tpu_torch.parallel import distributed
from hgr_tpu_torch.parallel.mesh import shard_rows
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


class ShardedDeviceCacheLoader(DeviceCacheLoader):
    """The device cache of data rank ``shard_index`` of ``shard_count``.

    Shard s owns the global samples [s·n_local, min((s+1)·n_local, N))
    with n_local = ceil(N / shard_count). Every epoch it permutes its own
    rows with ``RandomState(seed + epoch·10007 + s)`` (no shuffle: index
    order), pads its sequence by repetition to len(self) blocks of
    batch_size / shard_count rows (``valid`` masks the repeats) and yields
    its block of each global batch: the blocks of the ranks, in rank
    order, are the JAX loader's global batch on a {'data': shard_count}
    mesh. Rows past N (a shard with fewer real samples) hold an identity
    affine and canvas-sized dims, so the masked augment stays finite.

    With ``microbatches`` a > 1 it yields instead this rank's rows
    ``shard_rows(batch_size, shard_count, shard_index, a)`` of that global
    batch, exchanged with the other ranks of ``group`` (the mesh's data
    group: a collective, so every rank iterates alike); ``valid`` of
    every rank's block follows from the shard sizes, with no exchange."""

    def __init__(self, index, batch_size: int, shard_index: int,
                 shard_count: int, snapshot_dir: str = "", device="cuda",
                 group=None, microbatches: int = 1, **kwargs):
        super().__init__(index, batch_size, snapshot_dir=snapshot_dir,
                         device=device, **kwargs)
        if batch_size % (shard_count * microbatches):
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"'data' axis size x microbatches "
                             f"({shard_count} x {microbatches})")
        self.shard, self.shards = shard_index, shard_count
        self.group, self.microbatches = group, microbatches
        n = len(self.index)
        self.n_local = -(-n // shard_count)
        self.lo = shard_index * self.n_local
        self.n_real = max(0, min(self.n_local, n - self.lo))

    def __len__(self) -> int:
        return -(-self.n_local // (self.batch_size // self.shards))

    def _build_cache(self) -> None:
        n, cs = self.n_local, self.canvas_size
        spec = _flat_shapes(cs, self.num_joints)
        cache = {k: torch.zeros((n, flat), dtype=_TORCH_DTYPES[np.dtype(dt)],
                                device=self.device)
                 for k, (flat, _, dt) in spec.items()}
        cache["orig_to_canvas"][:] = torch.tensor([1.0, 0, 0, 0, 1.0, 0])
        cache["sizes_hw"][:] = float(cs)
        lo, hi = self.lo, self.lo + self.n_real

        def write(block: Dict[str, np.ndarray], start: int) -> None:
            """Keep the block's rows that fall in this shard."""
            stop = start + len(next(iter(block.values())))
            a, b = max(start, lo), min(stop, hi)
            for k, v in block.items():
                if a < b:
                    rows = np.require(v[a - start:b - start],
                                      requirements="CW")
                    cache[k][a - lo:b - lo].copy_(torch.from_numpy(rows))

        if self.snapshot_dir:
            if distributed.is_coordinator():
                self.loaded_from_snapshot = self._fill(write, spec,
                                                       len(self.index))
            distributed.barrier()  # the snapshot is whole from here on
            if not distributed.is_coordinator():
                self.loaded_from_snapshot = self._fill(write, spec,
                                                       len(self.index))
        else:
            self._stage_own(write, spec)
        self._cache = cache
        self._spec = spec

    def _stage_own(self, write, spec) -> None:
        """Decode and stage this shard's samples only."""
        sub = AnnotationIndex(self.index.samples[self.lo:self.lo + self.n_real],
                              self.index.names)
        if not len(sub):
            return
        own = BatchLoader(sub, self.batch_size, canvas_size=self.canvas_size,
                          num_joints=self.num_joints, shuffle=False,
                          drop_last=False, num_workers=self.num_workers,
                          window_frac=self.window_frac)
        start = 0
        for batch in own:
            valid = min(self.batch_size, len(sub) - start)
            write({k: np.ascontiguousarray(batch[k][:valid]).reshape(
                valid, spec[k][0]) for k in _CACHED_KEYS}, self.lo + start)
            start += valid

    def _epoch_plan(self) -> Iterator:
        """(local row ids, valid) of this shard's block of each batch of
        one epoch; advances the epoch counter."""
        bl = self.batch_size // self.shards
        nb = len(self)
        order = np.arange(self.n_real)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch * 10007
                                        + self.shard)
            rng.shuffle(order)
        padded = (np.resize(order, nb * bl) if self.n_real
                  else np.zeros(nb * bl, np.int64))
        valid = np.zeros(nb * bl, np.float32)
        valid[:self.n_real] = 1.0
        self._epoch += 1
        for b in range(nb):
            yield padded[b * bl:(b + 1) * bl], valid[b * bl:(b + 1) * bl]

    def _exchange_plan(self):
        """(local rows of this rank's block in the order it sends them, on
        the device; rows sent to each rank; rows received from each rank;
        the global batch rows this rank ends up with) of every batch."""
        bs, d = self.batch_size, self.shards
        bl = bs // d
        wants = [shard_rows(bs, d, t, self.microbatches) for t in range(d)]
        own = np.arange(self.shard * bl, (self.shard + 1) * bl)
        send = [w[(w >= own[0]) & (w <= own[-1])] - own[0] for w in wants]
        mine = wants[self.shard]
        recv = [int(((mine >= s * bl) & (mine < (s + 1) * bl)).sum())
                for s in range(d)]
        order = torch.from_numpy(np.concatenate(send)).to(self.device)
        return order, [len(x) for x in send], recv, mine

    def _exchange(self, flat: Dict[str, torch.Tensor], plan
                  ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch from every rank's block of
        flat rows: one all_to_all of the rows' bytes, in the order of the
        global batch (each source's rows ascend, sources in rank order)."""
        order, send, recv, _ = plan
        keys = list(flat)
        parts = [flat[k].view(torch.uint8) for k in keys]
        rows = torch.cat(parts, 1)[order]
        out = rows.new_empty((sum(recv), rows.shape[1]))
        dist.all_to_all_single(out, rows, recv, send, group=self.group)
        got, at = {}, 0
        for k, p in zip(keys, parts):
            got[k] = out[:, at:at + p.shape[1]].contiguous().view(
                flat[k].dtype)
            at += p.shape[1]
        return got

    def __iter__(self) -> Iterator[Dict]:
        if self._cache is None:
            self._build_cache()
        plan = (self._exchange_plan()
                if self.microbatches > 1 and self.shards > 1 else None)
        for b, (ids, valid) in enumerate(self._epoch_plan()):
            idx = torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
                self.device)
            flat = {k: torch.index_select(v, 0, idx)
                    for k, v in self._cache.items()}
            if plan is not None:
                flat = self._exchange(flat, plan)
                valid = self._global_valid(b)[plan[3]]
            batch = {k: v.reshape((len(v),) + self._spec[k][1])
                     for k, v in flat.items()}
            batch["valid"] = valid
            yield batch

    def _global_valid(self, b: int) -> np.ndarray:
        """``valid`` of global batch ``b``: every shard's block, in rank
        order (shard s holds min(n_local, N - s·n_local) real samples,
        first in its padded sequence)."""
        bl = self.batch_size // self.shards
        pos = np.arange(b * bl, (b + 1) * bl)
        n = len(self.index)
        return np.concatenate([
            (pos < max(0, min(self.n_local, n - s * self.n_local)))
            .astype(np.float32) for s in range(self.shards)])
