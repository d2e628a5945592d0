"""One epoch of ``fit`` served from the whole HaGRID split on the card:
the train cache at 410,800 rows (shuffled) and the val cache at 54,000,
canvas 192 (110,880 bytes a row: 42.42 GiB and 5.58 GiB), every row
filled through ``DeviceCacheLoader``'s own ``write`` from synthetic host
blocks, then ``train.loop.fit`` for one epoch at B = 256, bf16 de-mixed
(the training CLI's other defaults), in two arms in one process: fused
BN off and on (``models.layers._FUSED_BN``). From the repository root:

    python torch_artifacts/hagrid_fit/epoch.py --out DIR [--work DIR]
        [--n_train 410800 --n_val 54000 --control_n 16384
         --control_steps 50 --device cuda]

Synthetic rows: a random uint8 canvas (a pool of two blocks' rows,
each block taking its rows at its own offset into the pool), identity
``orig_to_canvas``, ``sizes_hw`` the canvas, joints inside the canvas
drawn per block, every joint visible, labels ``row % 19``. No n-row
host array is built.

Before any large cache exists, each arm runs its control: the same
step served from a ``--control_n``-row cache for ``--control_steps``
steps (after ``CONTROL_WARMUP``), timed as ``fit`` times an epoch. Then
both caches are filled (seconds and GB/s), rows above 2**31 elements
and near the end are read back by the gather, the first batch of the
epoch is held against the rows it names, and each arm runs ``fit``
(the same batch order in both arms). Writes DIR/epoch.json (the fill,
the checks, each arm's ``train_time_s``, steps/s, crops/s, loader-wait
share, val time, memory after the epoch, its control, and the decision
rule's readings) and DIR/fused_{off,on}.metrics.jsonl (``fit``'s own);
WORK (default build/hagrid_fit) keeps the checkpoints.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from hgr_tpu_torch.config import (  # noqa: E402
    DEFAULT_NAMES,
    AugmentConfig,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from hgr_tpu_torch.data.dataset import AnnotationIndex, Sample  # noqa: E402
from hgr_tpu_torch.data.device_cache import DeviceCacheLoader  # noqa: E402
from hgr_tpu_torch.models import MultiTaskNet, layers  # noqa: E402
from hgr_tpu_torch.tools.hagrid_fit import (  # noqa: E402
    BLOCK_BYTES,
    NUM_JOINTS,
    memory,
    release,
    row_bytes,
)
from hgr_tpu_torch.train.loop import EpochMetrics, fit, train_epoch  # noqa: E402
from hgr_tpu_torch.train.state import (  # noqa: E402
    create_train_state,
    resolve_device,
)
from hgr_tpu_torch.train.steps import (  # noqa: E402
    make_train_step,
    resolve_grad_demix,
)

HAGRID_VAL_N = 54_000  # reference configs/hagrid.yaml:4
BATCH, CANVAS, IMAGE_SIZE, SEED = 256, 192, 192, 42
CONTROL_WARMUP = 5
SLOWDOWN = 0.10  # the rule: an epoch's ms/step this far above its control
ELEMENTS_2_31 = 2**31


class SyntheticCache(DeviceCacheLoader):
    """A device cache whose rows are synthetic: ``_fill`` writes every
    row through the loader's own ``write``, block by block, with no
    decode. ``expected_rows(ids)`` is what any rows hold."""

    def __init__(self, index, *args, seed: int = 0, **kwargs):
        super().__init__(index, *args, **kwargs)
        cs = self.canvas_size
        self.block = min(len(index), max(1, BLOCK_BYTES // (cs * cs * 3)))
        self.seed = seed
        self.pool = np.random.RandomState(seed).randint(
            0, 255, (2 * self.block, cs * cs * 3), np.uint8)
        self.fill_s = None

    def _offset(self, b: int) -> int:
        return (b * 131 + self.seed) % self.block

    def _block_joints(self, b: int) -> np.ndarray:
        cs = self.canvas_size
        rng = np.random.RandomState([self.seed, b])
        return (cs * (0.1 + 0.8 * rng.rand(self.block, NUM_JOINTS * 2))
                ).astype(np.float32)

    def block_rows(self, b: int, n: int):
        """The host rows of block ``b`` (views of the pool: contiguous
        and writeable, so ``write`` copies them once, to the card)."""
        cs, start = self.canvas_size, b * self.block
        k = min(self.block, n - start)
        off = self._offset(b)
        return {
            "canvas": self.pool[off:off + k],
            "orig_to_canvas": np.tile(np.asarray(
                [1.0, 0, 0, 0, 1.0, 0], np.float32), (k, 1)),
            "sizes_hw": np.full((k, 2), float(cs), np.float32),
            "joints": self._block_joints(b)[:k],
            "joints_vis": np.ones((k, NUM_JOINTS), np.float32),
            "label": (np.arange(start, start + k) % 19).astype(
                np.int32)[:, None],
        }

    def expected_rows(self, ids) -> dict:
        """What rows ``ids`` hold (flat, as cached)."""
        ids = np.asarray(ids, np.int64)
        blocks = {int(b): self.block_rows(int(b), len(self.index))
                  for b in np.unique(ids // self.block)}
        return {k: np.stack([blocks[int(i // self.block)][k][
            int(i % self.block)] for i in ids]) for k in self._spec}

    def _fill(self, write, spec, n: int) -> bool:
        t0 = time.perf_counter()
        for b in range(-(-n // self.block)):
            write(self.block_rows(b, n), b * self.block)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fill_s = time.perf_counter() - t0
        return False


def synthetic_index(n: int) -> AnnotationIndex:
    """``n`` samples with labels ``row % 19`` that point at no files."""
    by_id = {v: k for k, v in DEFAULT_NAMES.items()}
    return AnnotationIndex(
        samples=[Sample(image_path=f"mem://{i}", landmark=[],
                        label=by_id[i % 19]) for i in range(n)],
        names=dict(DEFAULT_NAMES))


def make_cache(n: int, device, shuffle: bool, seed: int):
    return SyntheticCache(
        synthetic_index(n), BATCH, canvas_size=CANVAS,
        num_joints=NUM_JOINTS, shuffle=shuffle, seed=seed, drop_last=False,
        num_workers=1, device=device)


def configs():
    model_cfg = ModelConfig(compute_dtype="bfloat16",
                            image_size=(IMAGE_SIZE, IMAGE_SIZE))
    train_cfg = TrainConfig(batch_size=BATCH, epochs=1, canvas_size=CANVAS,
                            seed=SEED)
    data_cfg = DataConfig(names=dict(DEFAULT_NAMES), augments=AugmentConfig())
    return model_cfg, train_cfg, data_cfg


def fresh_state(model_cfg, train_cfg, device):
    model = MultiTaskNet.from_config(
        model_cfg, generator=torch.Generator().manual_seed(train_cfg.seed))
    return create_train_state(model, lr=train_cfg.lr, device=device)


def control(args, device, fused: bool) -> dict:
    """ms a step served from a ``control_n``-row cache, the same step and
    timing as ``fit``'s epoch (host clock to the last step's metrics)."""
    model_cfg, train_cfg, _ = configs()
    loader = make_cache(args.control_n, device, True, SEED)
    loader._build_cache()
    state = fresh_state(model_cfg, train_cfg, device)
    step = make_train_step(
        AugmentConfig(), image_size=model_cfg.image_size,
        heatmap_size=model_cfg.heatmap_size,
        grad_demix=resolve_grad_demix(train_cfg, model_cfg))
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    batches = iter(loader)
    metrics = EpochMetrics(19)
    layers._FUSED_BN = fused
    try:
        train_epoch(state, step, itertools.islice(batches, CONTROL_WARMUP),
                    gen, metrics)
        metrics.snapshot()
        metrics.reset()
        t0 = time.perf_counter()
        # the next batches are gathered as the steps ask for them
        state = train_epoch(state, step, itertools.islice(
            batches, args.control_steps), gen, metrics)
        snap = metrics.snapshot()
        seconds = time.perf_counter() - t0
    finally:
        layers._FUSED_BN = None
    out = {"rows": args.control_n, "steps": args.control_steps,
           "ms_per_step": seconds / args.control_steps * 1e3,
           "loader_wait_s": snap["loader_wait_s"],
           "loss": snap["total_loss"]}
    del loader, state, batches
    release(device)
    return out


def _same(got: dict, want: dict) -> bool:
    return all(np.array_equal(
        got[k].reshape(len(v), -1).cpu().numpy(), v) for k, v in want.items())


def check_rows(loader: SyntheticCache) -> dict:
    """Rows on both sides of 2**31 canvas elements, in the middle and at
    the end, gathered on the card against what was written there."""
    n = len(loader.index)
    flat = loader._spec["canvas"][0]
    edge = ELEMENTS_2_31 // flat
    ids = sorted({i for i in (0, 1, edge - 1, edge, edge + 1, n // 2,
                              n - 2, n - 1) if 0 <= i < n})
    idx = torch.tensor(ids, device=loader.device)
    got = {k: torch.index_select(v, 0, idx) for k, v in loader._cache.items()}
    return {"rows": ids, "read_back": _same(got, loader.expected_rows(ids))}


def check_first_batch(loader: SyntheticCache) -> bool:
    """The epoch's first batch holds the rows its plan names (the epoch
    counter is put back, so ``fit`` serves epoch 0 after it)."""
    epoch = loader._epoch
    ids, _ = next(loader._batch_ids())
    loader._epoch = epoch
    it = iter(loader)
    batch = next(it)
    it.close()
    loader._epoch = epoch
    got = {k: batch[k] for k in loader._spec}
    return _same(got, loader.expected_rows(ids))


def run_arm(name: str, fused: bool, args, device, train, val, out: str,
            work: str) -> dict:
    model_cfg, train_cfg, data_cfg = configs()
    train._epoch = 0  # both arms see the same batches
    state = fresh_state(model_cfg, train_cfg, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = f"fused_{name}"
    shutil.rmtree(os.path.join(work, "logs", run), ignore_errors=True)
    save = os.path.join(work, run)
    os.makedirs(os.path.join(save, "weight"), exist_ok=True)
    layers._FUSED_BN = fused
    try:
        state = fit(model_cfg, train_cfg, data_cfg, state, train, val,
                    None, save_path=save, log_dir=os.path.join(work, "logs"),
                    run_name=run)
    finally:
        layers._FUSED_BN = None
    mem = memory(device)
    src = os.path.join(work, "logs", run, "metrics.jsonl")
    shutil.copyfile(src, os.path.join(out, f"{run}.metrics.jsonl"))
    with open(src) as f:
        last = [json.loads(line) for line in f][-1]
    tt = last["train_time_s"]
    steps = state.step
    arm = {"fused_bn": fused, "steps": steps, "train_time_s": tt,
           "steps_per_s": steps / tt, "crops_per_s": last["train/samples"] / tt,
           "ms_per_step": tt / steps * 1e3,
           "loader_wait_s": last["train/loader_wait_s"],
           "loader_wait_share": last["train/loader_wait_s"] / tt,
           "val_time_s": last["epoch_time_s"] - tt,
           "train_samples": last["train/samples"],
           "val_samples": last["val/samples"],
           "train_loss": last["train/total_loss"],
           "val_loss": last["val/total_loss"], **mem}
    del state
    release(device)
    return arm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--work", default=os.path.join(REPO, "build",
                                                  "hagrid_fit"))
    p.add_argument("--n_train", type=int, default=410_800)
    p.add_argument("--n_val", type=int, default=HAGRID_VAL_N)
    p.add_argument("--control_n", type=int, default=16_384)
    p.add_argument("--control_steps", type=int, default=50)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if -(-args.control_n // BATCH) < CONTROL_WARMUP + args.control_steps:
        p.error(f"--control_n {args.control_n} holds fewer than "
                f"{CONTROL_WARMUP} + --control_steps batches of {BATCH}")
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    arms = (("off", False), ("on", True))
    controls = {name: control(args, device, fused) for name, fused in arms}

    train = make_cache(args.n_train, device, True, SEED)
    val = make_cache(args.n_val, device, False, SEED + 1)
    fill = {}
    for split, loader in (("train", train), ("val", val)):
        loader._build_cache()
        nbytes = sum(v.numel() * v.element_size()
                     for v in loader._cache.values())
        fill[split] = {"rows": len(loader.index), "gb": nbytes / 2**30,
                       "seconds": loader.fill_s,
                       "gb_per_s": nbytes / 1e9 / loader.fill_s}
    fill["row_bytes"] = row_bytes(CANVAS)
    fill["after_fill"] = memory(device)
    checks = {"train_rows": check_rows(train), "val_rows": check_rows(val),
              "first_batch": check_first_batch(train)}
    results = {}
    for name, fused in arms:
        results[name] = run_arm(name, fused, args, device, train, val,
                                args.out, args.work)
        results[name]["control"] = controls[name]
        results[name]["over_control"] = (results[name]["ms_per_step"]
                                         / controls[name]["ms_per_step"] - 1)
    report = {
        "device": str(device),
        "card": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else None),
        "n_train": args.n_train, "n_val": args.n_val, "batch": BATCH,
        "canvas": CANVAS, "fill": fill, "checks": checks,
        "arms": results,
        "rule": {
            "fault": not (checks["train_rows"]["read_back"]
                          and checks["val_rows"]["read_back"]
                          and checks["first_batch"]
                          and all(math.isfinite(a["train_loss"])
                                  and math.isfinite(a["val_loss"])
                                  for a in results.values())),
            "slowdown": {name: a["over_control"] > SLOWDOWN
                         for name, a in results.items()}},
    }
    with open(os.path.join(args.out, "epoch.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
