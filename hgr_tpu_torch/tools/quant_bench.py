"""int8 PTQ serving benchmark: the accuracy cost and the forward time (port
of hgr_tpu/tools/quant_bench.py).

Trains a classifier on a synthetic fixture through the port's own
training CLI (or takes ``--weights`` and ``--data_config``), quantizes
its GELAN backbone (``infer/quant.py``) from ``--calib_batches`` batches
of the train split's eval crops, and reports:

  * test macro F1 of the bf16 float model against the int8 backbone,
    through the eval pipeline (``infer/export.py:eval_exported``);
  * the forward at ``--bench_batch``, bf16 against int8, timed by CUDA
    events on the card (on the CPU the times are not measured: null).

  python -m hgr_tpu_torch.tools.quant_bench --workdir out/quantbench \\
      [--train_n 4096 --epochs 12 --batch 256 --bench_batch 4096]
  python -m hgr_tpu_torch.tools.quant_bench --workdir ... \\
      --weights run/weight/best.pt --data_config x.yaml

Writes <workdir>/quant_bench.json (the JAX tool's keys) and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

# the forward's timing: calls timed, after calls to warm it
TIME_ITERS, TIME_WARMUP = 30, 5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--weights", default="",
                    help="an existing checkpoint (.pt of the port, .npz, "
                         "reference .ckpt): skips training")
    ap.add_argument("--data_config", default="",
                    help="data config to calibrate and evaluate with "
                         "(with --weights)")
    ap.add_argument("--train_n", type=int, default=4096)
    ap.add_argument("--val_n", type=int, default=512)
    ap.add_argument("--test_n", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--calib_batches", type=int, default=4)
    ap.add_argument("--bench_batch", type=int, default=4096)
    ap.add_argument("--eval_batch", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def build_fixture(root: str, args):
    """Synthetic train/val/test splits under ``root`` (the JAX tool's
    fixture: seeds 0-2)."""
    from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    for seed, (split, n) in enumerate((("train", args.train_n),
                                       ("val", args.val_n),
                                       ("test", args.test_n))):
        write_synthetic_split(root, split, n, seed=seed)
    return DataConfig(path=root, names=dict(DEFAULT_NAMES))


def train_fixture_model(data_cfg, workdir: str, args) -> str:
    """Train through the port's training CLI; returns the best checkpoint."""
    from hgr_tpu_torch.cli import train as cli
    from hgr_tpu_torch.train.checkpoint import best_or_last

    argv = ["--data_config", "(the fixture's DataConfig)",
            "--suffix", "quantbench", "--batch_size", str(args.batch),
            "--epochs", str(args.epochs), "--lr", str(args.lr),
            "--lr_step", str(max(args.epochs - 4, 1)), "--seed", "42",
            "--log_dir", os.path.join(workdir, "logs"),
            "--save_dir", os.path.join(workdir, "output"),
            "--num_workers", "8", "--device", args.device]
    _, save = cli.run(cli.parse_args(argv), data_cfg)
    return best_or_last(save)


def calibration_batches(loader, n_batches: int, image_size, device):
    """The eval crops (identity augment, no jitter) of the first
    ``n_batches`` batches, on ``device``."""
    from hgr_tpu_torch.data.pipeline import (
        apply_augment_batch,
        identity_params,
    )
    from hgr_tpu_torch.train.loop import to_device

    out = []
    for i, batch in enumerate(loader):
        if i >= n_batches:
            break
        batch.pop("valid", None)
        b = to_device(batch, device)
        out.append(apply_augment_batch(
            b["canvas"], b["orig_to_canvas"], b["sizes_hw"], b["joints"],
            b["joints_vis"], identity_params(len(b["label"]), device),
            image_size=image_size,
            heatmap_size=(image_size[0] // 4, image_size[1] // 4),
            enable_jitter=False)["image"])
    return out


def time_forward_ms(fn, x) -> float:
    """Mean ms of ``fn(x)`` over TIME_ITERS calls by CUDA events, after
    TIME_WARMUP."""
    for _ in range(TIME_WARMUP):
        fn(x)
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIME_ITERS):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIME_ITERS


def run(args: argparse.Namespace, data_cfg=None) -> dict:
    """The benchmark; ``data_cfg`` stands in for ``--data_config`` (a
    caller without a YAML file). Returns what it writes."""
    from hgr_tpu_torch.config import load_data_config
    from hgr_tpu_torch.infer.detect import resolve_device
    from hgr_tpu_torch.infer.export import (
        eval_exported,
        make_inference_fn,
        split_loader,
    )
    from hgr_tpu_torch.infer.quant import quantize_model
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        load_classifier_weights,
        resolve_image_size,
    )

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    if args.weights:
        if data_cfg is None:
            if not args.data_config:
                raise SystemExit("--weights needs --data_config")
            data_cfg = load_data_config(args.data_config)
        ckpt = args.weights
    else:
        data_cfg = build_fixture(os.path.join(args.workdir, "fixture"),
                                 args)
        ckpt = train_fixture_model(data_cfg, args.workdir, args)
        print(f"trained checkpoint: {ckpt}", flush=True)

    image_size = resolve_image_size(ckpt, None)
    state = load_classifier_weights(ckpt, image_size)

    def model():
        return build_classifier(state, image_size, torch.bfloat16,
                                device=device,
                                num_joints=data_cfg.num_joints,
                                num_classes=data_cfg.num_classes)

    f_float = make_inference_fn(model())
    t0 = time.perf_counter()
    calib = calibration_batches(split_loader(data_cfg, data_cfg.train,
                                             args.eval_batch),
                                args.calib_batches, image_size, device)
    f_int8 = make_inference_fn(quantize_model(model(), calib,
                                              need_attnmap=False))
    calib_s = time.perf_counter() - t0
    calib_crops = sum(len(c) for c in calib)
    print(f"calibrated on {calib_crops} crops ({calib_s:.1f}s)", flush=True)

    res_f, res_q = (eval_exported(fn, split_loader(data_cfg, data_cfg.test,
                                                   args.eval_batch),
                                  data_cfg.num_classes, image_size, device)
                    for fn in (f_float, f_int8))

    t_float = t_int8 = None
    if device.type == "cuda":
        x = torch.from_numpy(np.random.RandomState(0).uniform(
            -2.1, 2.6, (args.bench_batch,) + image_size + (3,)
        ).astype(np.float32)).to(device)
        with torch.inference_mode():
            t_float = time_forward_ms(f_float, x)
            t_int8 = time_forward_ms(f_int8, x)
    out = {
        "ckpt": ckpt,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "test_f1_float": res_f["test_f1"],
        "test_f1_int8": res_q["test_f1"],
        "f1_delta": res_q["test_f1"] - res_f["test_f1"],
        "test_images": res_f["images"],
        "bench_batch": args.bench_batch,
        "fwd_ms_float": t_float,
        "fwd_ms_int8": t_int8,
        "crops_per_s_float": (args.bench_batch / t_float * 1e3
                              if t_float else None),
        "crops_per_s_int8": (args.bench_batch / t_int8 * 1e3
                             if t_int8 else None),
        "speedup": t_float / t_int8 if t_float else None,
        "calib_crops": calib_crops,
    }
    path = os.path.join(args.workdir, "quant_bench.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print(f"\nwrote {path}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
