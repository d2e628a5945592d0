"""Attribute the 2-output forward's time across model sections (port of
hgr_tpu/tools/fwd_attribution.py).

Times standalone graphs of the bf16 eval-mode model on preformed
inputs and splits the forward by differences of their medians.

Graphs timed (bf16, preformed images, need_attnmap=False):
  full        the full 2-output forward
  bb          the GELAN encoder only
  bb_proj     encoder + the 1x1 projection (512 -> 256)
  pose        the pose head alone on preformed (B, 144, 256) tokens:
              reshape -> align-corners x4 upsample -> ReLU -> 1x1 conv
              256 -> 21 (models/vit.py:_pose_head)
  cls         the cls head alone (f32 LayerNorm + Linear) on (B, 256)

Derived:
  proj        ~ bb_proj - bb
  transformer ~ full - bb_proj - pose - cls   (with the pos-emb / concat
              glue)

Each graph is timed with CUDA events around every call on the card
(``utils/profiling.py:median_ms``; perf_counter on the CPU), median over
``--iters`` calls after 3 warm-up calls.

    python -m hgr_tpu_torch.tools.fwd_attribution [--batch 4096]
        [--iters 20] [--device cuda]

Prints one JSON object with the JAX tool's keys (milliseconds).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

WARMUP = 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--image_size", type=int, default=192)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def derive(res: Dict[str, float], batch: int) -> Dict[str, float]:
    """The JAX tool's derived figures from the graphs' medians (ms)."""
    out = dict(res)
    out["derived_proj"] = res["bb_proj"] - res["bb"]
    out["derived_transformer_glue"] = (
        res["full"] - res["bb_proj"] - res["pose"] - res["cls"])
    out["batch"] = batch
    out["crops_per_s_full"] = batch / (res["full"] / 1000.0)
    return out


def graphs(model, batch: int, device) -> Dict[str, tuple]:
    """name -> (callable, its input) of the graphs above, on ``model``'s
    own modules, with seeded bf16 inputs on ``device``."""
    h, w = model.image_size
    fh, fw = model.decoder.feature_size
    dim = model.decoder.dim
    gen = torch.Generator(device=device).manual_seed(1)
    img = torch.randn(batch, h, w, 3, generator=gen, device=device,
                      dtype=torch.bfloat16)
    tokens = torch.randn(batch, fh * fw, dim, generator=gen, device=device,
                         dtype=torch.bfloat16)
    cls_feat = torch.randn(batch, dim, generator=gen, device=device,
                           dtype=torch.bfloat16)
    dec = model.decoder
    return {
        "full": (lambda x: model(x, need_attnmap=False), img),
        "bb": (model.encoder, img),
        "bb_proj": (lambda x: model.proj(model.encoder(x)), img),
        "pose": (dec._pose_head, tokens),
        "cls": (lambda x: dec.mlp_head_fc(dec.mlp_head_norm(x.float())),
                cls_feat),
    }


def run(args) -> Dict[str, float]:
    """The medians and the derived figures; ``calls`` counts the calls of
    each graph (warm-up included)."""
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.state import resolve_device
    from hgr_tpu_torch.utils.profiling import median_ms

    device = resolve_device(args.device)
    size = (args.image_size, args.image_size)
    model = MultiTaskNet(image_size=size, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(device)
    res = {}
    with torch.inference_mode():
        for name, (fn, x) in graphs(model, args.batch, device).items():
            res[name] = median_ms(fn, x, iters=args.iters, warmup=WARMUP,
                                  device=device)
    return derive(res, args.batch)


def calls(args) -> int:
    """Calls of each graph in ``run`` (the full forward's: 4 attention
    forward launches each)."""
    return args.iters + WARMUP


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    res = run(build_parser().parse_args(argv))
    print(json.dumps({k: round(v, 2) if isinstance(v, float) else v
                      for k, v in res.items()}), flush=True)
    return res


if __name__ == "__main__":
    main()
