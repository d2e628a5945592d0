"""Convergence A/B for the BN normalize-chain dtype knob (port of
hgr_tpu/tools/bn_convergence_ab.py).

Runs the port's training CLI (``python -m hgr_tpu_torch.cli.train``)
twice on one synthetic fixture, with the same data, seed and
hyperparameters; only ``HGR_TPU_BN_DTYPE`` differs between the arms
(``float32``: the variable unset; ``bfloat16``). Each arm parses its
per-epoch validation lines and the final test F1 from the CLI's output
and reads the kernel launch counts the run wrote
(``<save_dir>/<run>/ranks/rank0.json``). Every other variable of the
caller's environment reaches both arms: run the tool once under
``HGR_TPU_FUSED_BN=on`` and once under ``off`` to compare the two BN
backward routes' convergence with no new flag (under bf16 BN no layer
takes the fused route, ``models/layers.py``).

    python -m hgr_tpu_torch.tools.bn_convergence_ab \\
        [--train_n 4096 --epochs 60 --batch 256] [--out DIR] [--arms f32]

Writes ``<out>/{f32,bf16}.json`` per arm and ``<out>/summary.json`` (the
JAX tool's keys); an arm left out of ``--arms`` is read back from its
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Optional, Sequence

from hgr_tpu_torch.tools.headtohead import _pythonpath_with_repo, build_fixture

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

EPOCH_RE = re.compile(
    r"epoch (\d+): train_loss=([\d.]+) val_loss=([\d.]+) "
    r"val_f1=([\d.]+) val_pose_acc=([\d.]+)")
TEST_RE = re.compile(r"Test F1 Score: ([\d.]+)")
ARMS = (("f32", "float32"), ("bf16", "bfloat16"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_n", type=int, default=4096)
    ap.add_argument("--val_n", type=int, default=512)
    ap.add_argument("--test_n", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workdir", type=str,
                    default=os.path.join(REPO, "build", "bn_convergence_ab",
                                         "work"))
    ap.add_argument("--out", type=str,
                    default=os.path.join(REPO, "build", "bn_convergence_ab"))
    ap.add_argument("--arms", type=str, nargs="+", default=["f32", "bf16"],
                    choices=["f32", "bf16"],
                    help="which arms to (re)run; an arm not listed is "
                         "loaded from its existing <out>/<arm>.json")
    ap.add_argument("--image_size", type=int, default=192)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def parse_arm(name: str, stdout: str) -> dict:
    """The per-epoch validation lines and the test F1 of a CLI run's
    output; raises where either is missing (a drifted log format, or a
    loss printed as nan, which EPOCH_RE does not match)."""
    epochs = [
        {"epoch": int(m[0]), "train_loss": float(m[1]),
         "val_loss": float(m[2]), "val_f1": float(m[3]),
         "val_pose_acc": float(m[4])}
        for m in EPOCH_RE.findall(stdout)]
    mtest = TEST_RE.search(stdout)
    if not epochs or mtest is None:
        raise RuntimeError(
            f"arm {name}: could not parse metrics from train output "
            f"(epochs={len(epochs)}, "
            f"test_f1={'found' if mtest else 'MISSING'}). stdout tail:\n"
            f"{stdout[-2000:]}")
    return {"epochs": epochs, "test_f1": float(mtest[1])}


def run_arm(name: str, cfg: str, workdir: str, args, bn_dtype: str) -> dict:
    env = dict(os.environ, PYTHONPATH=_pythonpath_with_repo())
    if bn_dtype == "bfloat16":
        env["HGR_TPU_BN_DTYPE"] = "bfloat16"
    else:
        env.pop("HGR_TPU_BN_DTYPE", None)
    save_dir = os.path.join(workdir, f"out_{name}")
    size = str(args.image_size)
    cmd = [
        sys.executable, "-m", "hgr_tpu_torch.cli.train",
        "--data_config", cfg, "--suffix", f"bnab_{name}",
        "--batch_size", str(args.batch), "--epochs", str(args.epochs),
        "--lr", str(args.lr), "--lr_step", str(max(args.epochs - 10, 1)),
        "--seed", "42", "--dtype", "bfloat16",
        "--log_dir", os.path.join(workdir, f"logs_{name}"),
        "--save_dir", save_dir, "--num_workers", "8",
        "--image_size", size, size, "--device", args.device,
    ]
    print("+", " ".join(cmd), f"[HGR_TPU_BN_DTYPE={bn_dtype}]", flush=True)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"arm {name} failed rc={proc.returncode}")
    ranks = os.path.join(save_dir, f"gelans_{size}x{size}_bnab_{name}",
                         "ranks", "rank0.json")
    with open(ranks) as f:
        ran = json.load(f)
    return {"bn_dtype": bn_dtype, **parse_arm(name, proc.stdout),
            "fused_bn": os.environ.get("HGR_TPU_FUSED_BN", "auto"),
            "steps": ran["step"], "launches": ran["launches"]}


def summarize(args, results: dict) -> dict:
    """The JAX tool's summary from the two arms' results."""
    return {
        "recipe": {"train_n": args.train_n, "epochs": args.epochs,
                   "batch": args.batch, "lr": args.lr, "seed": 42,
                   "dtype": "bfloat16"},
        "test_f1_f32bn": results["f32"]["test_f1"],
        "test_f1_bf16bn": results["bf16"]["test_f1"],
        "final_val_f32bn": results["f32"]["epochs"][-1]
        if results["f32"]["epochs"] else None,
        "final_val_bf16bn": results["bf16"]["epochs"][-1]
        if results["bf16"]["epochs"] else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cfg = build_fixture(os.path.join(args.workdir, "data"), args.train_n,
                        args.val_n, args.test_n)
    results = {}
    for name, dt in ARMS:
        path = os.path.join(args.out, f"{name}.json")
        if name not in args.arms:
            with open(path) as f:
                results[name] = json.load(f)
            continue
        results[name] = run_arm(name, cfg, args.workdir, args, dt)
        with open(path, "w") as f:
            json.dump(results[name], f, indent=1)
    summary = summarize(args, results)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
