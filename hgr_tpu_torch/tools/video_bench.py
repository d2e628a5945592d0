"""Offline video-path throughput: overlapped against serial (port of
hgr_tpu/tools/video_bench.py).

Writes a synthetic set of JPEG frames and runs the same work through
``infer/detect.py:detect_to_video`` at ``pipeline_depth=1`` (serial:
decode, infer, annotate and encode in turn) and at its default depth 3
(the decode thread and the in-flight window overlap them), each once to
warm and once timed, plus the decode floor: the frames decoded alone by
``infer/detect.py:iter_frames``, the decoder ``detect_to_video`` reads
them with. Random seeded weights: the timing does not depend on them.

    python -m hgr_tpu_torch.tools.video_bench [--frames 512] [--batch 16]
        [--h 480 --w 640] [--out result.json]

Prints a JSON line per stage and one with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="")
    ap.add_argument("--workdir", default="",
                    help="where the frames and videos go (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_frames(n: int, h: int, w: int, root: str) -> str:
    """``n`` JPEG frames (cv2) of a seeded noise background rolled 7 px a
    frame under a moving white disc, as the JAX tool draws them."""
    import cv2

    rng = np.random.RandomState(0)
    d = os.path.join(root, "frames")
    os.makedirs(d, exist_ok=True)
    base = rng.randint(0, 255, (h, w, 3), np.uint8)
    for i in range(n):
        img = np.roll(base, i * 7, axis=1).copy()
        cv2.circle(img, (w // 2 + (i * 5) % 60, h // 2), 40,
                   (255, 255, 255), -1)
        cv2.imwrite(os.path.join(d, f"f_{i:05d}.jpg"), img)
    return d


def decode_floor(d: str) -> float:
    """Frames/s of ``iter_frames`` alone over the directory ``d``."""
    from hgr_tpu_torch.infer.detect import iter_frames

    t0 = time.perf_counter()
    n = sum(1 for _ in iter_frames(d))
    return n / (time.perf_counter() - t0)


def run(args) -> Tuple[dict, int]:
    """The result and the pipeline's batches (one classifier forward
    each, warm-up runs included)."""
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline, detect_to_video
    from hgr_tpu_torch.infer.weights import (
        load_classifier_weights,
        load_detector_weights,
    )

    root = args.workdir or tempfile.mkdtemp(prefix="video_bench_")
    frames_dir = build_frames(args.frames, args.h, args.w, root)
    dec_fps = decode_floor(frames_dir)
    print(json.dumps({"decode_floor_fps": round(dec_fps, 1)}), flush=True)
    pipeline = HandGesturePipeline(
        load_classifier_weights("", seed=0), load_detector_weights("",
                                                                  seed=1),
        DEFAULT_NAMES, device=args.device)
    results = {"frames": args.frames, "batch_frames": args.batch,
               "decode_floor_fps": round(dec_fps, 1)}
    for depth, tag in ((1, "serial"), (3, "overlapped")):
        out = os.path.join(root, f"out_{depth}.mp4")
        for _ in range(2):  # the first run warms, the second is timed
            t0 = time.perf_counter()
            n = detect_to_video(pipeline, frames_dir, out,
                                batch_frames=args.batch,
                                pipeline_depth=depth)
            dt = time.perf_counter() - t0
        if n != args.frames:
            raise RuntimeError(f"{tag}: {n} of {args.frames} frames written")
        results[tag + "_fps"] = round(n / dt, 1)
        print(json.dumps({tag: {"fps": round(n / dt, 1), "frames": n,
                                "s": round(dt, 2)}}), flush=True)
    results["speedup"] = round(
        results["overlapped_fps"] / results["serial_fps"], 2)
    return results, pipeline.batches


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    results, _ = run(args)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
