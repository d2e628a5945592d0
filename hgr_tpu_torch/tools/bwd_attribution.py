"""Attribute the train step's backward-pass time (port of
hgr_tpu/tools/bwd_attribution.py).

Splits the backward of the bf16 model between the GELAN backbone and the
ViT/decoder head, and isolates BatchNorm's batch-statistics coupling, by
differences of the medians of standalone graphs.

Graphs timed (bf16, model-ready images, no preprocess; train-mode BN
unless named):
  fwd_loss    full forward + multitask loss (autograd recording, as the
              forward inside the gradient graphs)
  grad_full   gradient of the full loss wrt every parameter
  fwd_bb      backbone-only forward (sum of squares readout)
  grad_bb     gradient of fwd_bb wrt the backbone's parameters
  grad_head   gradient of the full loss wrt the NON-encoder parameters,
              the encoder's ``requires_grad`` off: autograd then runs no
              encoder backward, so this is forward + head backward
  grad_evalbn grad_full with eval-mode BN (running statistics; no
              batch-statistics coupling in the backward)

Derived:
  backbone bwd ~ grad_bb - fwd_bb
  head bwd     ~ grad_head - fwd_loss
  full bwd     ~ grad_full - fwd_loss
  BN coupling  ~ grad_full - grad_evalbn

The loss is one merged loss with one backward, as in the JAX tool (not
the train step's two de-mixed pullbacks). Train-mode BN(+SiLU) layers
take the fused backward (``ops/bn_act.py``) when ``HGR_TPU_FUSED_BN`` is
on, as in the train step. Each graph is timed with CUDA events around
every call (``utils/profiling.py:median_ms``), median over ``--iters``.

    python -m hgr_tpu_torch.tools.bwd_attribution [--batch 1024]
        [--iters 20] [--platform cpu]

Prints one JSON line per figure with the JAX tool's keys (metric, value
in ms, unit, batch, device).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional, Sequence

import torch

WARMUP = 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--platform", type=str, default="",
                    help="the device: empty (the card) or 'cpu'")
    ap.add_argument("--image_size", type=int, default=192)
    return ap


DERIVED = (("derived: backbone bwd", "grad_bb", "fwd_bb"),
           ("derived: head bwd", "grad_head", "fwd_loss"),
           ("derived: full bwd", "grad_full", "fwd_loss"),
           ("derived: BN batch coupling", "grad_full", "grad_evalbn"))


def derive(results: Dict[str, float]) -> Dict[str, float]:
    """The JAX tool's derived figures (ms) from the graphs' medians."""
    return {name: results[a] - results[b] for name, a, b in DERIVED}


def graphs(model, batch: int, device) -> Dict[str, Callable[[], object]]:
    """name -> a call of the graphs above on ``model`` (bf16, on
    ``device``), with seeded inputs."""
    from hgr_tpu_torch.models.multitasknet import heatmaps_to_nchw
    from hgr_tpu_torch.ops.losses import multitask_loss

    h, w = model.image_size
    hm = 4 * model.decoder.feature_size[0]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(batch, h, w, 3, generator=gen, device=device,
                    dtype=torch.bfloat16)
    label = torch.randint(0, model.num_classes, (batch,), generator=gen,
                          device=device)
    target = torch.rand(batch, model.num_joints, hm, hm, generator=gen,
                        device=device)
    tw = torch.ones(batch, model.num_joints, 1, device=device)
    params = list(model.parameters())
    encoder = list(model.encoder.parameters())
    enc_ids = {id(p) for p in encoder}
    head = [p for p in params if id(p) not in enc_ids]

    def full_loss(train: bool):
        model.train(train)
        cls, hmap, _ = model(x, need_attnmap=False)
        total, _ = multitask_loss(cls, heatmaps_to_nchw(hmap), label,
                                  target, tw)
        return total

    def bb_loss():
        model.encoder.train()
        return (model.encoder(x).float() ** 2).sum()

    def grad(loss_fn, wrt):
        loss = loss_fn()
        return loss, torch.autograd.grad(loss, wrt)

    def grad_head():
        for p in encoder:
            p.requires_grad_(False)
        try:
            return grad(lambda: full_loss(True), head)
        finally:
            for p in encoder:
                p.requires_grad_(True)

    return {
        "fwd_loss": lambda: full_loss(True),
        "grad_full": lambda: grad(lambda: full_loss(True), params),
        "fwd_bb": bb_loss,
        "grad_bb": lambda: grad(bb_loss, encoder),
        "grad_head": grad_head,
        "grad_evalbn": lambda: grad(lambda: full_loss(False), params),
    }


def run(args, emit=None) -> Dict[str, float]:
    """Each graph's median ms, then the derived figures, each passed to
    ``emit(name, ms)`` as it is measured."""
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.state import resolve_device
    from hgr_tpu_torch.utils.profiling import median_ms

    device = resolve_device(args.platform or "cuda")
    model = MultiTaskNet(image_size=(args.image_size, args.image_size),
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    results: Dict[str, float] = {}
    for name, fn in graphs(model, args.batch, device).items():
        results[name] = median_ms(fn, iters=args.iters, warmup=WARMUP,
                                  device=device)
        if emit is not None:
            emit(name, results[name])
    derived = derive(results)
    if emit is not None:
        for name, ms in derived.items():
            emit(name, ms)
    return {**results, **derived}


def calls(args) -> int:
    """Calls of each graph in ``run`` (warm-up included)."""
    return args.iters + WARMUP


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    device = str(torch.device(args.platform or "cuda"))

    def emit(name, ms):
        print(json.dumps({"metric": name, "value": round(ms, 2),
                          "unit": "ms", "batch": args.batch,
                          "device": device}), flush=True)

    return run(args, emit)


if __name__ == "__main__":
    main()
