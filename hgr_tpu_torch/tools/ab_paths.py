"""Serving forward and train step of two checkouts, in turns, on one card.

Each checkout runs its own ``chip_smoke.py`` phases in a process of its
own, with its own kernels built from its own sources: the bf16 forward
at the serving batch (B = 64) and the train step at B = 256 with fused BN
off and on. The checkouts run in the order given, then in reverse, so a
parent and a change compare within one call:

    python -m hgr_tpu_torch.tools.ab_paths build/parent .

Needs the card. Prints each run's model and train lines, then one JSON
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# one side: the checkout's own chip_smoke phases (argv[1] = checkout)
_SIDE = """
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from hgr_tpu_torch.utils.cuda_build import load_kernels
load_kernels(list(cs.SOURCES))
layers = cs._path_bn_layers(torch)
from hgr_tpu_torch.infer.weights import load_classifier_weights
state = load_classifier_weights("", (cs.IMAGE, cs.IMAGE), seed=0)
cs._zero_counts()
cs.model_phase(torch, state)
cs._zero_counts()
cs.train_phase(torch, len(layers))
"""


def _side(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _SIDE, tree],
                          capture_output=True, text=True, check=True)
    out = {"tree": tree}
    for line in proc.stdout.splitlines():
        if line.startswith('{"model"') or line.startswith('{"train"'):
            print(line, flush=True)
            out.update(json.loads(line))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, help="two checkouts (parent, change)")
    args = ap.parse_args(argv)
    order = args.trees + args.trees[::-1]
    runs = [_side(os.path.abspath(t)) for t in order]
    summary = {}
    for run in runs:
        side = summary.setdefault(run["tree"], {"forward_b64_ms": [],
                                                "step_ms": {}})
        side["forward_b64_ms"].append(run["model"]["bf16_ms_per_forward_b64"])
        for turn in run["train"]["turns"]:
            side["step_ms"].setdefault(f"fused_bn_{turn['fused_bn']}",
                                       []).append(turn["ms_per_step"])
    print(json.dumps({"ab": summary, "order": order}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
