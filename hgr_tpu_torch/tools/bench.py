"""Headline benchmark of the port: 192x192 crops/s on one CUDA card
(classify + pose), the counterpart of the repository's root ``bench.py``
with its flags and JSON fields.

The default measures the end-to-end input path: uint8 staged canvas ->
fused HSV jitter + two-pass warp (CUDA kernel) -> ImageNet normalize ->
bf16 MultiTaskNet forward without the attention map. ``--forward-only``
times the forward alone on preformed bf16 tensors. Each timed call ends
in ``torch.cuda.synchronize()``; the median is reported. ``vs_baseline``
is relative to the reference implementation's 14.0 crops/s (torch on
the CPU at bs=32, BASELINE.md).

    python -m hgr_tpu_torch.tools.bench [--batch N] [--iters 30]
        [--warmup 5] [--forward-only]

Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

REFERENCE_CROPS_PER_SEC = 14.0  # BASELINE.md, torch CPU bs=32


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--forward-only", action="store_true",
                        help="benchmark the pure 2-output forward on "
                             "preformed bf16 tensors instead of the "
                             "default end-to-end input path")
    args = parser.parse_args()

    import torch

    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data.pipeline import (
        apply_augment_batch,
        draw_augment_params,
    )
    from hgr_tpu_torch.models import MultiTaskNet

    if not torch.cuda.is_available():
        raise SystemExit("bench: torch sees no CUDA card")
    dev = torch.device("cuda")
    model = MultiTaskNet(dtype=torch.bfloat16).eval().to(dev)
    rng = np.random.RandomState(0)
    b = args.batch

    if args.forward_only:
        x = torch.from_numpy(rng.randn(b, 192, 192, 3).astype(
            np.float32)).to(dev, torch.bfloat16)

        def run():
            return model(x, need_attnmap=False)

        metric_name = "classify+pose crops/sec/chip @192x192"
    else:
        canvas = 256
        cfg = AugmentConfig()
        gen = torch.Generator(device=dev).manual_seed(0)
        inputs = dict(
            canvas=torch.from_numpy(rng.randint(
                0, 255, (b, canvas, canvas, 3)).astype(np.uint8)).to(dev),
            orig_to_canvas=torch.tensor(
                [[1.0, 0, 0], [0, 1.0, 0]], device=dev).repeat(b, 1, 1),
            sizes_hw=torch.full((b, 2), float(canvas), device=dev),
            joints=torch.from_numpy(
                (rng.rand(b, 21, 2) * canvas).astype(np.float32)).to(dev),
            joints_vis=torch.ones((b, 21), device=dev),
        )

        def run():
            params = draw_augment_params(gen, b, inputs["sizes_hw"], cfg)
            data = apply_augment_batch(
                inputs["canvas"], inputs["orig_to_canvas"],
                inputs["sizes_hw"], inputs["joints"], inputs["joints_vis"],
                params)
            return model(data["image"], need_attnmap=False)

        metric_name = ("e2e u8->augment->classify+pose crops/sec/chip "
                       "@192x192")

    with torch.inference_mode():
        for _ in range(args.warmup):
            run()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)

    med = float(np.median(times))
    crops_per_sec = b / med
    print(json.dumps({
        "metric": metric_name,
        "value": round(crops_per_sec, 1),
        "unit": "crops/s",
        "vs_baseline": round(crops_per_sec / REFERENCE_CROPS_PER_SEC, 2),
        "batch": b,
        "median_step_ms": round(med * 1e3, 3),
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
