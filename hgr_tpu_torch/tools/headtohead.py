"""Head-to-head convergence of the port's trainer against the reference
(torch), same fixture, same recipe, same seed (port of
hgr_tpu/tools/headtohead.py).

Builds the shared synthetic fixture in the reference annotation format
(the JAX tool's: seeds 0 / 1 / 2 for train / val / test, 224 px images,
the same data YAML), trains the port with the recipe through its
training CLI (``python -m hgr_tpu_torch.cli.train``, a subprocess), and
writes a side-by-side epoch table and final-metric summary against the
reference's curve.

The reference itself is not in the repository, so it is never run
(``--skip_reference`` is the only behaviour): its curve comes from a
committed file, ``--reference_metrics`` (default: the workdir's
``reference_metrics.jsonl``, as the JAX tool reuses one). The JAX
package's ``--ours_platform`` is ``--device`` here (the card unless
``--device cpu``).

The defaults are the JAX tool's (recipe A). The committed per-seed runs
of the reference and the JAX package are recipe B, the training CLI's
defaults: bf16, ``--grad_demix auto`` (on under bf16) and

  python -m hgr_tpu_torch.tools.headtohead --workdir build/h2h/s42 \\
      --seed 42 --epochs 50 --lr 1e-3 --lr_step 30 40 --lr_factor 0.1 \\
      --batch_size 32 --sigma 2 --train_n 380 --val_n 190 --test_n 380 \\
      [--reference_metrics bench_artifacts/headtohead_r4/reference_seed7.jsonl]

``tools/h2h_stats`` pairs such workdirs (``s{SEED}/``) with the
committed finals. Outputs in <workdir>: fixture/, ours_out/, ours_logs/
(the run's metrics.jsonl), headtohead_summary.json, headtohead_table.md.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the training CLI's run name for the recipe (its default 192 px crop)
RUN_NAME = "gelans_192x192_h2h"


def _pythonpath_with_repo() -> str:
    """Prepend the repo to PYTHONPATH without clobbering the inherited
    value."""
    existing = os.environ.get("PYTHONPATH", "")
    return REPO + (os.pathsep + existing if existing else "")


def build_fixture(root: str, train_n: int, val_n: int, test_n: int,
                  image_size: int = 224) -> str:
    """Shared fixture + data-config YAML (reference configs/hagrid.yaml
    schema). Returns the config path."""
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    os.makedirs(root, exist_ok=True)
    for split, n, seed in (("train", train_n, 0), ("val", val_n, 1),
                           ("test", test_n, 2)):
        write_synthetic_split(root, split, n, image_size=image_size,
                              seed=seed)
    cfg = os.path.join(root, "data.yaml")
    with open(cfg, "w") as f:
        f.write(f"path: {root}\n"
                "train: annotations/train\n"
                "val: annotations/val\n"
                "test: annotations/test\n\n"
                "num_joints: 21\nnum_classes: 19\n\nnames:\n")
        for k, v in DEFAULT_NAMES.items():
            f.write(f"  {k}: {v}\n")
        f.write("\naugments:\n  rotate_factor: 20\n  scale_factor: 0.35\n"
                "  translate_factor: 0.02\n  horizontal_flip: true\n"
                "  color_jittering: true\n")
    return cfg


def read_jsonl(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def run_ours(cfg: str, workdir: str, args) -> str:
    """The port's run of the recipe; returns its metrics.jsonl."""
    save_dir = os.path.join(workdir, "ours_out")
    log_dir = os.path.join(workdir, "ours_logs")
    cmd = [sys.executable, "-m", "hgr_tpu_torch.cli.train",
           "--data_config", cfg, "--suffix", "h2h",
           "--batch_size", str(args.batch_size),
           "--epochs", str(args.epochs), "--lr", str(args.lr),
           "--lr_step", *[str(s) for s in args.lr_step],
           "--lr_factor", str(args.lr_factor), "--sigma", str(args.sigma),
           "--seed", str(args.seed), "--dtype", args.ours_dtype,
           "--num_workers", "2",
           "--save_dir", save_dir, "--log_dir", log_dir,
           "--device", args.device]
    env = dict(os.environ, PYTHONPATH=_pythonpath_with_repo())
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    return os.path.join(log_dir, RUN_NAME, "metrics.jsonl")


def summarize(ref_path: str, ours_path: str, workdir: str) -> dict:
    """The JAX tool's epoch table and summary; without a reference curve
    (``ref_path`` missing) its columns read n/a and its finals None."""
    ref = read_jsonl(ref_path) if os.path.exists(ref_path) else []
    ref_final = next((r for r in ref if "test_f1" in r), None)
    ref_epochs = [r for r in ref if "epoch" in r]

    ours = read_jsonl(ours_path)
    ours_final = next((r for r in ours if "test/epoch_f1" in r), None)
    ours_epochs = [r for r in ours if "epoch" in r]

    lines = ["| epoch | ref val_loss | ours val_loss | ref val_F1 | "
             "ours val_F1 | ref pose_acc | ours pose_acc |",
             "|---|---|---|---|---|---|---|"]
    for i, o in enumerate(ours_epochs):
        r = ref_epochs[i] if i < len(ref_epochs) else None
        cell = ((lambda k: f"{r[k]:.4f}") if r is not None
                else (lambda k: "n/a"))
        lines.append(
            f"| {int(o['epoch'])} | {cell('val_total_loss')} | "
            f"{o['val/total_loss']:.4f} | {cell('val_f1')} | "
            f"{o['val/epoch_f1']:.4f} | {cell('val_pose_acc')} | "
            f"{o['val/pose_acc']:.4f} |")
    summary = {
        "reference": {
            "test_f1": ref_final and ref_final["test_f1"],
            "test_pose_acc": ref_final and ref_final.get("test_pose_acc"),
            "final_val_f1": ref_epochs and ref_epochs[-1]["val_f1"],
            "final_val_pose_acc":
                ref_epochs and ref_epochs[-1]["val_pose_acc"],
            "epoch_time_s_median": sorted(
                r["epoch_time_s"] for r in ref_epochs)[len(ref_epochs) // 2]
                if ref_epochs else None,
        },
        "ours": {
            "test_f1": ours_final and ours_final["test/epoch_f1"],
            "test_pose_acc": ours_final and ours_final.get("test/pose_acc"),
            "final_val_f1": ours_epochs and ours_epochs[-1]["val/epoch_f1"],
            "final_val_pose_acc":
                ours_epochs and ours_epochs[-1]["val/pose_acc"],
            "epoch_time_s_median": sorted(
                o["epoch_time_s"] for o in ours_epochs)[len(ours_epochs) // 2]
                if ours_epochs else None,
        },
    }
    if (summary["reference"]["test_f1"] is not None
            and summary["ours"]["test_f1"] is not None):
        summary["test_f1_delta_ours_minus_ref"] = (
            summary["ours"]["test_f1"] - summary["reference"]["test_f1"])
    with open(os.path.join(workdir, "headtohead_table.md"), "w") as f:
        f.write("\n".join(lines) + "\n\n" + json.dumps(summary, indent=2)
                + "\n")
    with open(os.path.join(workdir, "headtohead_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("\n".join(lines[-6:]))
    print(json.dumps(summary, indent=2))
    return summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir",
                   default=os.path.join(REPO, "build", "headtohead"))
    p.add_argument("--train_n", type=int, default=380)
    p.add_argument("--val_n", type=int, default=190)
    p.add_argument("--test_n", type=int, default=380)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_step", nargs="+", type=int, default=[30])
    p.add_argument("--lr_factor", type=float, default=0.1)
    p.add_argument("--sigma", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ours_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, for the port's run")
    p.add_argument("--reference_metrics", default="",
                   help="the reference's committed curve (a reference "
                        "metrics jsonl); default: "
                        "<workdir>/reference_metrics.jsonl")
    p.add_argument("--skip_reference", action="store_true",
                   help="accepted for the JAX tool's command lines: the "
                        "reference is never run here")
    p.add_argument("--skip_ours", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    fixture = os.path.join(args.workdir, "fixture")
    cfg = build_fixture(fixture, args.train_n, args.val_n, args.test_n)

    ref_out = (args.reference_metrics
               or os.path.join(args.workdir, "reference_metrics.jsonl"))
    ours_out = os.path.join(args.workdir, "ours_logs", RUN_NAME,
                            "metrics.jsonl")
    if not args.skip_ours:
        ours_out = run_ours(cfg, args.workdir, args)
    return summarize(ref_out, ours_out, args.workdir)


if __name__ == "__main__":
    main()
