"""Full-HaGRID device-cache fit on one card (port of
hgr_tpu/tools/hagrid_fit.py).

Measures whether the whole HaGRID train split (410,800 crops, canvas
192: 110,880 bytes a row, 42.42 GiB) lives as a device-resident cache
beside the real train step, and exercises the sharded cache's layout at
that geometry. Two modes, with the JAX tool's flags and report keys:

* ``--mode virtual``: the REAL ``ShardedDeviceCacheLoader`` at full
  geometry, one shard of ``--devices`` after another on the one device
  (the port's sharded cache is one rank's object): each shard is
  allocated, filled through the loader's own ``write`` with random
  blocks of ~64 MB covering both edges of every shard (no decode; the
  rows of a geometry-only index point at no files), iterated for
  ``--batches`` batches and freed before the next. It asserts the JAX
  tool's invariants (equal shard bytes, each at most 1.01 x its nominal
  size, blocks of batch / devices rows that make up the global batch in
  rank order), that every gathered row holds what was written there,
  and that the written boundary rows read back unchanged.
  ``gather_ms_per_batch`` is timed with CUDA events on a card.

* ``--mode chip``: ballast in the cache's flat layout, ceil(n /
  ``--devices``) rows (``--devices 8`` is the JAX tool's per-chip load
  of an 8-chip split, ``--devices 1`` the whole split on this card),
  beside the real train step: MultiTaskNet with remat, bf16, de-mixed
  as the training CLI resolves it, a fixed uint8 canvas batch of
  ``--batch``, ``--grad_accum`` microbatches. It walks the JAX tool's
  ladder (canvas and accum 2, then accum 4, then canvas 144 and accum
  4): a rung that raises ``torch.cuda.OutOfMemoryError`` is recorded
  as ``fits: false`` with the error, everything is freed and the next
  rung runs; any other error propagates; the first rung that fits ends
  the walk. ``--probe_headroom`` then allocates 512 MB slabs beside
  the ballast, a real step after each, up to 24 (a probe that takes
  all 24 reports a lower bound).

Differences from the JAX tool: ``--devices`` also sets the chip mode's
split (JAX fixes 8); ``--donate`` is dropped, because the port's step
updates its state in place (``train/steps.py``) and holds no second
copy to donate; ``--out`` also writes the report to a file;
``gather_ms_per_batch_cpu`` is ``gather_ms_per_batch``; the chip mode's
step is de-mixed as the CLI resolves it (JAX's tool takes the merged
backward); the probe counts only slabs beside which a step ran, and an
out-of-memory error on the card is recoverable.

Runs on the card unless ``--device cpu``; without a card it raises.

    python -m hgr_tpu_torch.tools.hagrid_fit --mode virtual [--n 410800]
    python -m hgr_tpu_torch.tools.hagrid_fit --mode chip [--devices 1] \\
        [--batch 1024] [--probe_headroom] [--out report.json]
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
from hgr_tpu_torch.data.dataset import AnnotationIndex, Sample
from hgr_tpu_torch.data.device_cache import (
    _TORCH_DTYPES,
    ShardedDeviceCacheLoader,
    _flat_shapes,
)
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.train.state import create_train_state, resolve_device
from hgr_tpu_torch.train.steps import make_train_step, resolve_grad_demix

HAGRID_N = 410_800  # reference configs/hagrid.yaml:3-5 train-split crops
NUM_JOINTS = 21
IMAGE_SIZE = 192  # the model's crop in the chip mode
BLOCK_BYTES = 64 << 20  # one fill block's canvas bytes
SLAB_BYTES = 512 << 20  # one headroom slab
MAX_SLABS = 24


class Clock:
    """Milliseconds from ``start()`` to ``stop()``: CUDA events on a
    card, the host's clock (after the work) on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            e1.synchronize()
            return self._e0.elapsed_time(e1)
        return (time.perf_counter() - self._t0) * 1e3


def row_bytes(cs: int, num_joints: int = NUM_JOINTS) -> int:
    """Bytes of one cached sample: the flat rows of every key."""
    return int(sum(flat * np.dtype(dt).itemsize
                   for flat, _, dt in _flat_shapes(cs, num_joints).values()))


def memory(device: torch.device) -> Dict[str, Optional[float]]:
    """The allocator's peak and reserved bytes and the card's free and
    total memory, in GiB (None on the CPU)."""
    if device.type != "cuda":
        return {"max_memory_allocated_gb": None, "memory_reserved_gb": None,
                "mem_free_gb": None, "mem_total_gb": None}
    free, total = torch.cuda.mem_get_info(device)
    return {"max_memory_allocated_gb":
            torch.cuda.max_memory_allocated(device) / 2**30,
            "memory_reserved_gb": torch.cuda.memory_reserved(device) / 2**30,
            "mem_free_gb": free / 2**30, "mem_total_gb": total / 2**30}


def release(device: torch.device) -> None:
    """Return what nothing references any more to the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def geometry_index(n: int) -> AnnotationIndex:
    """Real ``Sample`` records over 19 classes that point at no files:
    the fill below never opens them."""
    names = {f"c{i}": i for i in range(19)}
    return AnnotationIndex(
        samples=[Sample(image_path=f"mem://{i}", label=f"c{i % 19}",
                        landmark=[]) for i in range(n)],
        names=names)


def fill_blocks(n: int, d: int, cs: int):
    """(start, rows) of the random blocks, in write order: ~64 MB each,
    at both edges of every shard (JAX hagrid_fit.py:65-89)."""
    rows = min(n, max(1, BLOCK_BYTES // (cs * cs * 3)))
    n_local = -(-n // d)
    starts = []
    for s in range(d):
        starts += [s * n_local, min((s + 1) * n_local, n) - rows]
    return [(start, rows) for start in sorted(
        {max(0, min(s, n - rows)) for s in starts})]


def random_block(spec, start: int, rows: int) -> Dict[str, np.ndarray]:
    """The block written at ``start``, drawn from ``RandomState(start)``
    (so it can be drawn again to check what was written)."""
    rng = np.random.RandomState(start)
    block = {}
    for k, (flat, _, dt) in spec.items():
        if np.dtype(dt) == np.uint8:
            block[k] = rng.randint(0, 255, (rows, flat), np.uint8)
        elif k == "label":
            block[k] = rng.randint(0, 19, (rows, flat)).astype(np.int32)
        else:
            block[k] = rng.rand(rows, flat).astype(np.float32) + 0.5
    return block


class VirtualShard(ShardedDeviceCacheLoader):
    """One shard of the virtual split: its rows come from the random
    blocks through the loader's own ``write`` (in place of decoding its
    samples), and the epoch plans it serves are kept in ``plans``."""

    def __init__(self, *args, blocks=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.blocks = list(blocks)
        self.written: Dict[int, Dict[str, np.ndarray]] = {}
        self.plans = []

    def _random_fill(self, write, spec) -> None:
        hi = self.lo + self.n_real
        for start, rows in self.blocks:
            if start < hi and start + rows > self.lo:
                block = random_block(spec, start, rows)
                write(block, start)
                self.written[start] = block

    def _stage_own(self, write, spec) -> None:
        self._random_fill(write, spec)

    def _fill(self, write, spec, n: int) -> bool:
        self._random_fill(write, spec)
        return False

    def _epoch_plan(self):
        for ids, valid in super()._epoch_plan():
            self.plans.append((ids, valid))
            yield ids, valid

    def expected(self, local_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """What rows ``local_ids`` of this shard hold: the last block
        written over each, else the shard's initial row (zeros, an
        identity affine and canvas-sized dims)."""
        spec, cs = self._spec, self.canvas_size
        out = {k: np.zeros((len(local_ids), flat), dt)
               for k, (flat, _, dt) in spec.items()}
        out["orig_to_canvas"][:] = [1.0, 0, 0, 0, 1.0, 0]
        out["sizes_hw"][:] = float(cs)
        rows = self.lo + np.asarray(local_ids, np.int64)
        for start, block in self.written.items():
            n_rows = len(block["label"])
            at = (rows >= start) & (rows < start + n_rows)
            for k in out:
                out[k][at] = block[k][rows[at] - start]
        return out


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def _same(got: Dict[str, torch.Tensor], want: Dict[str, np.ndarray]) -> bool:
    return all(np.array_equal(
        got[k].reshape(len(v), -1).cpu().numpy(), v) for k, v in want.items())


def run_virtual(args) -> dict:
    device = resolve_device(args.device)
    n, cs, d = args.n, args.canvas, args.devices
    index = geometry_index(n)
    blocks = fill_blocks(n, d, cs)
    clock = Clock(device)
    per_dev = np.zeros(d, np.int64)
    allocated = []
    build_s, gather_ms, iterated = 0.0, [], []
    first_blocks, first_valid, checked_rows = [], [], 0
    global_valid = None
    for s in range(d):
        release(device)
        base = (torch.cuda.memory_allocated(device)
                if device.type == "cuda" else 0)
        loader = VirtualShard(index, batch_size=args.batch, shard_index=s,
                              shard_count=d, canvas_size=cs, shuffle=True,
                              num_workers=0, device=device, blocks=blocks)
        t0 = time.perf_counter()
        it = iter(loader)
        batches = [next(it)]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        build_s += time.perf_counter() - t0
        per_dev[s] = sum(v.numel() * v.element_size()
                         for v in loader._cache.values())
        if device.type == "cuda":
            allocated.append(
                (torch.cuda.memory_allocated(device) - base) / 2**30)
        clock.start()
        for batch in it:
            batches.append(batch)
            if len(batches) >= args.batches:
                break
        gather_ms.append(clock.stop() / max(len(batches) - 1, 1))
        iterated.append(len(batches))
        it.close()
        # every block of batch / devices rows holds what its rows hold
        for batch, (ids, _) in zip(batches, loader.plans):
            _check(batch["canvas"].shape == (args.batch // d, cs, cs, 3),
                   batch["canvas"].shape)
            _check(_same(batch, loader.expected(ids)),
                   f"shard {s}: a gathered row differs from what was written")
        keys = sorted(batches[0])
        first_blocks.append(batches[0]["canvas"].shape[0])
        first_valid.append(batches[0]["valid"])
        global_valid = loader._global_valid(0)
        # the written boundary rows read back unchanged, by the gather
        for start, block in loader.written.items():
            lo = max(start, loader.lo) - loader.lo
            hi = min(start + len(block["label"]),
                     loader.lo + loader.n_real) - loader.lo
            got = {k: torch.index_select(
                v, 0, torch.arange(lo, hi, device=device))
                for k, v in loader._cache.items()}
            _check(_same(got, loader.expected(np.arange(lo, hi))),
                   f"shard {s}: rows {lo}..{hi} do not read back")
            checked_rows += hi - lo
        del loader, it, batches
    release(device)

    expected_row = row_bytes(cs)
    report = {
        "mode": "virtual", "device": str(device),
        "n": n, "canvas": cs, "devices": d,
        "row_bytes": expected_row,
        "total_cache_gb": round(float(per_dev.sum()) / 2**30, 2),
        "per_device_gb": [round(float(b) / 2**30, 3) for b in per_dev],
        "per_device_bytes": [int(b) for b in per_dev],
        "per_device_allocated_gb": allocated or None,
        "build_s": round(build_s, 1),
        "batch_keys": keys,
        "batch_canvas_shape": [sum(first_blocks), cs, cs, 3],
        "valid_sum_first_batch": float(np.concatenate(first_valid).sum()),
        "gather_ms_per_batch": round(float(np.mean(gather_ms)), 3),
        "batches_iterated": min(iterated),
        "filled_blocks": len(blocks),
        "boundary_rows_checked": checked_rows,
    }
    # invariants: equal shards, nominal byte size per device, the blocks
    # of batch / devices rows make up the global batch in rank order
    n_local = -(-n // d)
    nominal = expected_row * n_local
    _check(abs(per_dev.max() - per_dev.min()) <= 1, per_dev)
    _check(per_dev[0] <= nominal * 1.01, (per_dev[0], nominal))
    _check(first_blocks == [args.batch // d] * d, first_blocks)
    _check(np.array_equal(np.concatenate(first_valid), global_valid),
           "the blocks' valid masks are not the global batch's")
    return report


def _staged_batch(b: int, cs: int, device) -> Dict[str, torch.Tensor]:
    """The JAX tool's fixed batch: a random uint8 canvas, identity
    affines, canvas-sized dims, joints inside the canvas."""
    rng = np.random.RandomState(0)
    batch = {
        "canvas": rng.randint(0, 255, (b, cs, cs, 3), np.uint8),
        "orig_to_canvas": np.tile(np.asarray(
            [[1.0, 0, 0], [0, 1.0, 0]], np.float32), (b, 1, 1)),
        "sizes_hw": np.full((b, 2), float(cs), np.float32),
        "joints": (rng.rand(b, NUM_JOINTS, 2) * cs).astype(np.float32),
        "joints_vis": np.ones((b, NUM_JOINTS), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def chip_rung(args, device, n_local: int, cs: int, accum: int) -> dict:
    """One rung of the ladder: ballast, state, step, timings, memory and
    (with ``--probe_headroom``) the probed headroom. An out-of-memory
    error propagates to the ladder."""
    spec = _flat_shapes(cs, NUM_JOINTS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ballast = {k: torch.zeros((n_local, flat),
                              dtype=_TORCH_DTYPES[np.dtype(dt)],
                              device=device)
               for k, (flat, _, dt) in spec.items()}
    ballast_gb = sum(v.numel() * v.element_size()
                     for v in ballast.values()) / 2**30
    size = IMAGE_SIZE
    batch = _staged_batch(args.batch, cs, device)
    mcfg = ModelConfig(compute_dtype="bfloat16", remat=True,
                       image_size=(size, size))
    model = MultiTaskNet.from_config(
        mcfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, lr=1e-3, milestones_steps=(10**6,),
                               device=device)
    step = make_train_step(
        AugmentConfig(), image_size=(size, size),
        heatmap_size=(size // 4, size // 4), grad_accum=accum,
        grad_demix=resolve_grad_demix(TrainConfig(grad_accum=accum), mcfg))
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    float(m["total_loss"])
    compile_s = time.perf_counter() - t0
    clock = Clock(device)
    clock.start()
    for _ in range(args.iters):
        state, m = step(state, batch, gen)
    step_ms = clock.stop() / args.iters
    entry = {"canvas": cs, "grad_accum": accum, "fits": True,
             "ballast_gb": round(ballast_gb, 2),
             "step_ms": round(step_ms, 2),
             "crops_per_s": round(args.batch / step_ms * 1e3, 1),
             "compile_s": round(compile_s, 1),
             "loss": float(m["total_loss"]),
             "steps": 1 + args.iters, **memory(device)}
    print(json.dumps({"fit": entry}), flush=True)
    if args.probe_headroom:
        entry.update(probe_headroom(step, state, batch, gen))
    return entry


def probe_headroom(step, state, batch, gen) -> dict:
    """512 MB slabs beside everything the rung holds, a real step after
    each, until the card refuses one or MAX_SLABS are taken."""
    extra, stopped, steps = [], "limit", 0
    try:
        for _ in range(MAX_SLABS):
            slab = torch.zeros((SLAB_BYTES,), dtype=torch.uint8,
                               device=state.device)
            state, m = step(state, batch, gen)
            float(m["total_loss"])
            steps += 1
            extra.append(slab)
    except torch.cuda.OutOfMemoryError as exc:
        stopped = f"out of memory: {str(exc)[:200]}"
    slabs = len(extra)
    del extra
    return {"probed_headroom_gb": slabs * SLAB_BYTES / 2**30,
            "probe_lower_bound": slabs == MAX_SLABS,
            "probe_stopped_by": stopped, "probe_steps": steps}


def run_chip(args) -> dict:
    device = resolve_device(args.device)
    n_local = -(-args.n // args.devices)
    ladder = [(args.canvas, args.grad_accum), (args.canvas, 4), (144, 4)]
    results = []
    for cs, accum in ladder:
        try:
            entry = chip_rung(args, device, n_local, cs, accum)
        except torch.cuda.OutOfMemoryError as exc:
            entry = {"canvas": cs, "grad_accum": accum, "fits": False,
                     "error": str(exc)[:300]}
        release(device)  # after the handler: its traceback held the rung
        results.append(entry)
        if entry["fits"]:
            break  # the first fitting configuration is the answer
    return {"mode": "chip", "device": str(device), "n": args.n,
            "devices": args.devices, "n_local_rows": n_local,
            "batch": args.batch, "ladder": results}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["virtual", "chip"], required=True)
    ap.add_argument("--n", type=int, default=HAGRID_N)
    ap.add_argument("--canvas", type=int, default=192)
    ap.add_argument("--devices", type=int, default=8,
                    help="shards of the split (virtual) and the split the "
                         "chip mode's ballast is one share of")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--grad_accum", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--probe_headroom", action="store_true",
                    help="after a fitting rung, allocate 512 MB slabs, a "
                         "step after each, until the card refuses one "
                         "(at most 24)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="", help="also write the report here")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    report = run_virtual(args) if args.mode == "virtual" else run_chip(args)
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
