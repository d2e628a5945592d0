"""Convert a JAX training run's orbax checkpoints into the port's.

    python -m hgr_tpu_torch.cli.convert_orbax <save_path>

``<save_path>`` is the run directory the JAX package's ``cli/train.py``
wrote: ``weight/{best,last}/`` (orbax, {step, params, batch_stats,
opt_state}), ``weight/best_metric.txt`` and ``weight/run_meta.json``
(hgr_tpu/train/loop.py:327-336). Each checkpoint becomes
``weight/{best,last}.pt`` beside it, written by the port's own
``CheckpointManager``: parameters, BatchNorm statistics, the AdamW
moments and step, and the best metric. Then

    python -m hgr_tpu_torch.cli.train --resume ... (the same save_path)

continues the JAX run at its step, with its moments and its schedule.

Reading orbax needs ``tensorstore`` (``utils/orbax_read.py``): run this
where the JAX run was written and take the ``.pt`` files to the card.
The checkpoint holds no schedule: a resumed run takes its lr from its
own ``--lr``/``--lr_step`` flags at the restored step, before every
update.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("save_path", help="the JAX run directory (holds weight/)")
    return ap


def _model_for(tree: dict):
    """A CPU MultiTaskNet with the tree's parameters (the CLI's widths;
    backbone, joints and classes from the tree's own shapes)."""
    from hgr_tpu_torch.infer.weights import infer_backbone_variant
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet
    from hgr_tpu_torch.utils.convert import from_flax

    dec = tree["params"]["decoder"]
    return MultiTaskNet(
        num_joints=int(dec["simple_decoder_conv"]["kernel"].shape[-1]),
        num_classes=int(dec["mlp_head_fc"]["kernel"].shape[-1]),
        backbone=infer_backbone_variant(from_flax(
            {"params": tree["params"]})))


def convert_run(save_path: str) -> dict:
    """Write ``weight/{best,last}.pt`` from the orbax checkpoints under
    ``save_path``; returns ``{name: step}`` of what it wrote."""
    from hgr_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_payload,
        payload_from_jax,
    )
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.utils.orbax_read import read_orbax

    weight = os.path.join(save_path, "weight")
    found = [n for n in ("last", "best")
             if os.path.isdir(os.path.join(weight, n))]
    if not found:
        raise FileNotFoundError(f"{weight} holds no orbax best/ or last/")
    metric: Optional[float] = None
    metric_file = os.path.join(weight, "best_metric.txt")
    if os.path.exists(metric_file):
        with open(metric_file) as f:
            metric = float(f.read().strip())
    ckpt = CheckpointManager(weight)
    wrote = {}
    for name in found:
        tree = read_orbax(os.path.join(weight, name))
        if "opt_state" not in tree:
            raise ValueError(f"{weight}/{name} holds bare variables, not a "
                             "training checkpoint: load it with "
                             "infer/weights.py:load_classifier_weights")
        state = create_train_state(_model_for(tree), device="cpu")
        load_payload(state, payload_from_jax(tree, state))
        if name == "last":
            ckpt.save_last(state)
        else:
            ckpt.save_best(state, metric)
        ckpt.wait()
        wrote[name] = state.step
    return wrote


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    wrote = convert_run(args.save_path)
    for name, step in wrote.items():
        print(f"{args.save_path}/weight/{name} -> {name}.pt (step {step})",
              flush=True)
    return wrote


if __name__ == "__main__":
    main()
