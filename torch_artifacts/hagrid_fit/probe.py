"""Where the full-HaGRID epoch's time went against its control: the
fused-BN-on epoch of ``epoch.py`` ran 10.3% over its 16,384-row control
(``epoch.json``). Three readings, written to OUT/probe.json. From the
repository root:

    python torch_artifacts/hagrid_fit/probe.py --out DIR

- ``epoch_windows_ms``: ms a step over each 50-step window of both
  committed epochs, from the ``time`` of ``fit``'s log lines
  (``fused_{off,on}.metrics.jsonl`` beside this script); no card needed.
- ``gather_ms``: one batch of 256 random rows gathered from every key of
  a cache (``index_select``, as ``DeviceCacheLoader`` serves it), CUDA
  events over ``GATHERS`` gathers, at 16,384 and 410,800 rows (the
  control's and the epoch's caches, filled as ``epoch.py`` fills them)
  and, canvas only, at 19,418 and 19,419 rows (either side of 2**31
  elements) and 51,350 (a shard of ``hagrid_fit --mode virtual``), in
  ``TURNS`` turns.
- ``step_turns``: the fused-on step served from the 16,384-row cache and
  from the 410,800-row cache in turns (``TURNS`` each, ``STEPS`` steps a
  turn after ``epoch.CONTROL_WARMUP`` from each, timed as ``fit`` times
  an epoch), with the card's SM clock, power draw and temperature from
  nvidia-smi after each turn.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import epoch as E  # noqa: E402  (it puts the repository on the path)

from hgr_tpu_torch.config import AugmentConfig  # noqa: E402
from hgr_tpu_torch.models import layers  # noqa: E402
from hgr_tpu_torch.tools.hagrid_fit import release  # noqa: E402
from hgr_tpu_torch.train.loop import EpochMetrics, train_epoch  # noqa: E402
from hgr_tpu_torch.train.state import resolve_device  # noqa: E402
from hgr_tpu_torch.train.steps import (  # noqa: E402
    make_train_step,
    resolve_grad_demix,
)

SMALL, LARGE = 16_384, 410_800
CANVAS_ONLY = (19_418, 19_419, 51_350)
GATHERS, TURNS, STEPS = 50, 4, 50


def epoch_windows_ms() -> dict:
    """ms a step between consecutive log lines of each committed epoch."""
    out = {}
    for arm in ("off", "on"):
        with open(os.path.join(HERE, f"fused_{arm}.metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        marks = [(r["step"], r["time"]) for r in rows if "epoch" not in r]
        out[arm] = [(t1 - t0) / (s1 - s0) * 1e3
                    for (s0, t0), (s1, t1) in zip(marks, marks[1:])]
    return out


def card_reading() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def gather_ms(cache: dict, device, rng) -> float:
    n = next(iter(cache.values())).shape[0]
    idx = torch.from_numpy(rng.randint(0, n, E.BATCH).astype(np.int64)).to(
        device)

    def gather():
        return [torch.index_select(v, 0, idx) for v in cache.values()]

    for _ in range(5):
        gather()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(GATHERS):
        gather()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / GATHERS


def batches(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    report = {"epoch_windows_ms": epoch_windows_ms()}
    small = E.make_cache(SMALL, device, True, E.SEED)
    large = E.make_cache(LARGE, device, True, E.SEED)
    small._build_cache()
    large._build_cache()
    caches = {str(SMALL): small._cache, str(LARGE): large._cache}
    for n in CANVAS_ONLY:
        caches[f"{n}_canvas"] = {"canvas": torch.zeros(
            (n, E.CANVAS * E.CANVAS * 3), dtype=torch.uint8, device=device)}
    rng = np.random.RandomState(0)
    report["gather_ms"] = {name: [] for name in caches}
    for _ in range(TURNS):
        for name, cache in caches.items():
            report["gather_ms"][name].append(gather_ms(cache, device, rng))
    for name in list(caches)[2:]:
        del caches[name]
    release(device)

    model_cfg, train_cfg, _ = E.configs()
    state = E.fresh_state(model_cfg, train_cfg, device)
    step = make_train_step(
        AugmentConfig(), image_size=model_cfg.image_size,
        heatmap_size=model_cfg.heatmap_size,
        grad_demix=resolve_grad_demix(train_cfg, model_cfg))
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    feeds = {"small": batches(small), "large": batches(large)}
    metrics = EpochMetrics(19)
    turns = {"small": [], "large": [], "card": []}
    layers._FUSED_BN = True
    try:
        for feed in feeds.values():
            train_epoch(state, step, itertools.islice(
                feed, E.CONTROL_WARMUP), gen, metrics)
        metrics.snapshot()
        for turn in range(TURNS):
            order = ("small", "large") if turn % 2 == 0 else ("large", "small")
            for name in order:
                metrics.reset()
                t0 = time.perf_counter()
                train_epoch(state, step, itertools.islice(
                    feeds[name], STEPS), gen, metrics)
                metrics.snapshot()
                turns[name].append((time.perf_counter() - t0) / STEPS * 1e3)
                turns["card"].append(f"{name}: {card_reading()}")
    finally:
        layers._FUSED_BN = None
    report["step_turns"] = turns
    report["card"] = torch.cuda.get_device_name(device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
