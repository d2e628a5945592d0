"""Paired head-to-head statistics across seeds for the port's trainer:
F1 and pose (port of hgr_tpu/tools/h2h_stats.py).

Collects final TEST metrics per seed of three stacks trained on the same
synthetic fixture with the same recipe and seed label: the reference
(torch; its committed curves), the JAX package (its committed curves)
and the port (one ``tools/headtohead`` workdir per seed, ``s{SEED}/``,
the JAX tool's round-5 layout). It reports the JAX tool's paired
statistics for both metrics, twice: port - reference and port - JAX
(per-seed diffs, mean, sd, paired t, a sign count, and a bootstrap 95%
CI of the paired mean).

A pair shares the fixture, the recipe and the seed label, not the init
draws: the port initializes from torch's generator, the JAX package
from ``jax.random`` (the JAX tool's reference pairs were of this kind
too).

Committed finals read (recipe B, seeds 7, 42, 43, 123, 256, 999, 1337):
``--r4_dir`` (``reference_seed{S}.jsonl``, ``demix/ours_demix_seed{S}
.jsonl``), the round-3 ``recipeB/`` beside it (reference curves) and
``--r5_dir`` (``reference_seed{S}.jsonl``, ``ours_demix_seed{S}.jsonl``).

Usage:
  python -m hgr_tpu_torch.tools.h2h_stats \\
      [--r4_dir bench_artifacts/headtohead_r4] \\
      [--r5_dir bench_artifacts/headtohead_r5] \\
      [--r5_glob 'torch_artifacts/headtohead/s*'] [--out FILE]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PAIRING = ("pairs share the fixture, recipe and seed label, not the init "
           "draws (torch's generator in the port, jax.random in the JAX "
           "package, torch's in the reference)")


def _read_jsonl(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _final(rows, ref):
    """(test_f1, test_pose) from a metrics jsonl (ref or ours format).
    Takes the LAST test row — the best-checkpoint evaluation (some ours
    logs carry an interim test row before the final one)."""
    if ref:
        fins = [r for r in rows if "test_f1" in r]
        return ((fins[-1]["test_f1"], fins[-1]["test_pose_acc"])
                if fins else None)
    fins = [r for r in rows if "test/epoch_f1" in r]
    return ((fins[-1]["test/epoch_f1"], fins[-1]["test/pose_acc"])
            if fins else None)


# Reference seed-42 recipe-B finals: the r3 run's workdir was not
# committed; these are the documented numbers (BENCH_LOG round 3
# 'Recipe B' table / round 4 5-seed table, same run). Every other pair
# comes from committed/on-disk curves.
DOCUMENTED_REF = {"42": (0.1693, 0.5824)}


def _seed_files(pattern: str, stem: str):
    """(seed, path) of the files ``pattern`` matches, the seed read after
    ``stem`` in the name."""
    for p in glob.glob(pattern):
        yield os.path.basename(p).split(stem)[1].split(".")[0], p


def collect(r4_dir: str, r5_glob: str, r5_dir: str = ""):
    """seed -> {"ref": (f1, pose), "jax": (f1, pose)[, "port": (f1, pose)]}
    for every seed with a committed reference and JAX final; "port" where
    a workdir of ``r5_glob`` holds the port's run of that seed."""
    pairs = {}
    ref_dirs = [r4_dir, os.path.join(os.path.dirname(r4_dir),
                                     "headtohead_r3", "recipeB")]
    jax_files = [os.path.join(r4_dir, "demix", "ours_demix_seed*.jsonl")]
    if r5_dir:
        ref_dirs.append(r5_dir)
        jax_files.append(os.path.join(r5_dir, "ours_demix_seed*.jsonl"))
    # the r4 curves first; r3's recipeB covers seeds 42/43/1337 (same
    # recipe) where r4 has none
    for d in ref_dirs:
        for seed, p in _seed_files(os.path.join(d, "reference_seed*.jsonl"),
                                   "reference_seed"):
            v = _final(_read_jsonl(p), ref=True)
            if v:
                pairs.setdefault(seed, {}).setdefault("ref", v)
    for pattern in jax_files:
        for seed, p in _seed_files(pattern, "ours_demix_seed"):
            v = _final(_read_jsonl(p), ref=False)
            if v:
                pairs.setdefault(seed, {})["jax"] = v
    for seed, v in DOCUMENTED_REF.items():
        pairs.setdefault(seed, {}).setdefault("ref", v)
    pairs = {s: v for s, v in pairs.items() if "ref" in v and "jax" in v}
    for d in glob.glob(r5_glob) if r5_glob else []:
        seed = os.path.basename(d).lstrip("s")
        op = os.path.join(d, "ours_logs", "gelans_192x192_h2h",
                          "metrics.jsonl")
        if seed in pairs and os.path.exists(op):
            v = _final(_read_jsonl(op), ref=False)
            if v:
                pairs[seed]["port"] = v
    return pairs


def paired_stats(diffs: np.ndarray, rng=None) -> dict:
    n = len(diffs)
    mean = float(diffs.mean())
    sd = float(diffs.std(ddof=1)) if n > 1 else float("nan")
    t = mean / (sd / np.sqrt(n)) if n > 1 and sd > 0 else float("nan")
    rng = rng or np.random.RandomState(0)
    boots = np.array([
        rng.choice(diffs, size=n, replace=True).mean()
        for _ in range(10000)])
    return {
        "n": n,
        "mean": round(mean, 4),
        "sd": round(sd, 4),
        "paired_t": round(float(t), 2),
        "ours_ahead": int((diffs > 0).sum()),
        "boot95_ci": [round(float(np.percentile(boots, 2.5)), 4),
                      round(float(np.percentile(boots, 97.5)), 4)],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--r4_dir", default=os.path.join(
        REPO, "bench_artifacts", "headtohead_r4"))
    ap.add_argument("--r5_dir", default=os.path.join(
        REPO, "bench_artifacts", "headtohead_r5"),
                    help="the JAX package's round-5 finals (flat files)")
    ap.add_argument("--r5_glob", default=os.path.join(
        REPO, "torch_artifacts", "headtohead", "s*"),
                    help="the port's headtohead workdirs, one a seed")
    ap.add_argument("--out", default="")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    pairs = collect(args.r4_dir, args.r5_glob, args.r5_dir)
    seeds = sorted((s for s in pairs if "port" in pairs[s]), key=int)
    rows = []
    for s in seeds:
        rf1, rp = pairs[s]["ref"]
        jf1, jp = pairs[s]["jax"]
        of1, op = pairs[s]["port"]
        rows.append({"seed": int(s), "ref_f1": round(rf1, 4),
                     "jax_f1": round(jf1, 4), "port_f1": round(of1, 4),
                     "ref_pose": round(rp, 4), "jax_pose": round(jp, 4),
                     "port_pose": round(op, 4)})
        print(f"seed {s:>6}: F1 port {of1:.4f} ref {rf1:.4f} "
              f"({of1 - rf1:+.4f}) jax {jf1:.4f} ({of1 - jf1:+.4f}) | "
              f"pose port {op:.4f} ref {rp:.4f} ({op - rp:+.4f}) "
              f"jax {jp:.4f} ({op - jp:+.4f})")
    if not rows:
        raise SystemExit(f"no port run with a committed pair under "
                         f"{args.r5_glob}")
    result = {"seeds": rows, "pairing": PAIRING}
    for other in ("ref", "jax"):
        result[f"port_minus_{other}"] = {
            metric: paired_stats(np.array(
                [r[f"port_{metric}"] - r[f"{other}_{metric}"]
                 for r in rows]))
            for metric in ("f1", "pose")}
    print(json.dumps({k: result[k] for k in
                      ("port_minus_ref", "port_minus_jax")}, indent=1))
    print(PAIRING)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
