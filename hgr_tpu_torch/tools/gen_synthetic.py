"""Parallel synthetic-dataset generator for scale rehearsals (port of
hgr_tpu/tools/gen_synthetic.py).

Writes a HaGRID-layout dataset (reference libs/load.py:208-228) of any
size by spreading ``data/synthetic.py:write_synthetic_split`` chunks over
worker processes. Each chunk gets its own image directory
``<out>/<split>_pNN/`` and annotation file
``<out>/annotations/<split>/<split>_pNN.json``: the reader globs every
``*.json`` of a split's annotation directory and resolves each file's
images from its own stem, so a chunked split reads as one. Chunk k of
the run takes seed ``--seed`` + k, as in the JAX tool, so a seed and a
chunking give the JAX tool's annotation JSON and pixels (the port
encodes with PIL at quality 95).

    python -m hgr_tpu_torch.tools.gen_synthetic --out_dir data/syn \\
        [--train 102400 --val 10240 --test 10240] [--image_size 192] \\
        [--chunk_size 10240] [--workers 8] [--seed 0]

Writes ``data_config_fragment.json`` (path and split entries) beside the
dataset.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import time
from typing import Dict, Optional, Sequence

from hgr_tpu_torch.data.synthetic import write_synthetic_split


def _gen_chunk(job):
    out_dir, split, part, count, image_size, seed = job
    chunk = f"{split}_p{part:02d}"
    t0 = time.time()
    ann_dir = write_synthetic_split(out_dir, chunk, count,
                                    image_size=image_size, seed=seed)
    # the chunk's json joins the split's annotation directory; its stem
    # still resolves the images from <out_dir>/<chunk>/
    split_ann = os.path.join(out_dir, "annotations", split)
    os.makedirs(split_ann, exist_ok=True)
    shutil.move(os.path.join(ann_dir, chunk + ".json"),
                os.path.join(split_ann, chunk + ".json"))
    os.rmdir(ann_dir)
    return chunk, count, time.time() - t0


def generate(out_dir: str, counts: Dict[str, int], image_size: int = 192,
             chunk_size: int = 10240, workers: int = 8,
             base_seed: int = 0) -> None:
    jobs = []
    seed = base_seed
    for split, total in counts.items():
        part, remaining = 0, total
        while remaining > 0:
            n = min(chunk_size, remaining)
            jobs.append((out_dir, split, part, n, image_size, seed))
            part += 1
            seed += 1
            remaining -= n
    t0 = time.time()
    with mp.get_context("spawn").Pool(workers) as pool:
        for chunk, count, dt in pool.imap_unordered(_gen_chunk, jobs):
            print(f"  {chunk}: {count} images in {dt:.1f}s", flush=True)
    print(f"total: {sum(counts.values())} images in {time.time() - t0:.1f}s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--train", type=int, default=102_400)
    p.add_argument("--val", type=int, default=10_240)
    p.add_argument("--test", type=int, default=10_240)
    p.add_argument("--image_size", type=int, default=192)
    p.add_argument("--chunk_size", type=int, default=10_240)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = build_parser().parse_args(argv)
    counts = {"train": args.train, "val": args.val, "test": args.test}
    generate(args.out_dir, counts, image_size=args.image_size,
             chunk_size=args.chunk_size, workers=args.workers,
             base_seed=args.seed)
    cfg = {"path": os.path.abspath(args.out_dir),
           "train": "annotations/train", "val": "annotations/val",
           "test": "annotations/test"}
    cfg_path = os.path.join(args.out_dir, "data_config_fragment.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"wrote {cfg_path}")
    return cfg_path


if __name__ == "__main__":
    main()
