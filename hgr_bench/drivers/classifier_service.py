"""Crop-serving cells: ``ClassifierService`` as the serving CLI builds it
(``cli/serve.py:build_service``), the benchmark's seeded weights in the
configuration's dtype, warmed, then a closed loop of clients each
keeping one window of crops outstanding (``submit_many``).

``classify_crops_per_s`` counts every crop answered inside the window
over its length; the 95th percentile of the requests resolved inside
it, from the clients' side, is a per-layer reading
(``metrics/request_p95_ms.py``).

What decides ``correct``: a sample of the window's requests, drawn
from the seed, recomputed by the plain reference in float32 from the
same crops (``reference/serve.py:judge_classify``: ``probs``,
``landmark``), each against the traffic file's limit. The served
label's logit gap is printed, not compared: the controls read it 0 on
most seeds, as the program does (``PERF.md``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hgr_bench import clients, counts, scenes, weights
from hgr_bench.harness import Ctx, Outcome, free
from hgr_bench.reference import Precision, exact_float32, mtn
from hgr_bench.reference import serve as ref_serve


def reference_outputs(cfg, image, state0, crops, device, prec="float32",
                      block: int = 256):
    """(logits, heatmaps) of the plain reference over (B, H, W, 3) BGR
    crops of 0-255 values (a host array or a tensor), in blocks."""
    crops = torch.as_tensor(crops)
    with exact_float32(), torch.no_grad():
        model = mtn.from_config(cfg, image, Precision(prec)).to(device)
        model.load_state_dict(state0, strict=True)
        model.eval()
        outs = [model(ref_serve.normalize(crops[i:i + block].to(device)))
                for i in range(0, len(crops), block)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def sample(done, k: int, seed: int, end: float):
    """``k`` of the requests resolved inside the window, drawn from the
    seed (all, if fewer)."""
    ok = sorted((d for d in done if d[4] is None and d[1] <= end),
                key=lambda d: d[0])
    rng = np.random.RandomState(weights.subseed(seed, "sample") % 2**32)
    pick = rng.choice(len(ok), size=min(k, len(ok)), replace=False)
    return [ok[i] for i in sorted(pick)]


def run(ctx: Ctx) -> Outcome:
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.weights import build_classifier
    from hgr_tpu_torch.ops.attention import fused_attention_qkv
    from hgr_tpu_torch.serve.engine import ClassifierService

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    image = (tr["image_size"], tr["image_size"])
    dtype = getattr(torch, cfg["model"]["compute_dtype"])
    state0 = weights.serving_state(cfg, image, seed, dev)
    model = build_classifier(state0, image, dtype, cfg["model"]["backbone"],
                             device=dev)
    pool = scenes.crops(tr["pool"], image[0], weights.subseed(seed, "crops"))
    per = tr["window_crops"]

    def make_request(rng):
        idx = rng.randint(0, len(pool), per)
        return idx, [pool[i] for i in idx]

    svc = ClassifierService(model, class_names=dict(DEFAULT_NAMES),
                            max_batch=tr["max_batch"],
                            max_wait_ms=tr["max_wait_ms"],
                            pipeline_depth=tr["pipeline_depth"])
    res, stats, record, memory_peak = clients.serve_window(
        svc, svc.submit_many, make_request, ctx, per,
        lambda: fused_attention_qkv.launches)
    record.update(forward_flops=counts.mtn_forward_flops(cfg, image),
                  attention_shape=(None, image[0] // 16 * image[1] // 16 + 1,
                                   cfg["model"]["heads"],
                                   cfg["model"]["head_dim"]))

    del model, svc
    free(dev)
    picked = sample(res["done"], tr["check_requests"], seed, res["end"])
    crops_u8 = np.stack([pool[i] for d in picked for i in d[2]])
    served = [a for d in picked for a in d[3]]
    logits, hm = reference_outputs(cfg, image, state0, crops_u8, dev)
    checks = ref_serve.judge_classify(logits, hm, served)
    print(f"label logit gap {checks.pop('label')}", file=sys.stderr)
    limits = tr["limits"]
    return Outcome(
        attempted=stats["attempted"], failed=stats["failed"],
        metrics={"classify_crops_per_s": stats["items_per_s"],
                 "setup_s": res["start"] - ctx.started},
        checks={k: (v, limits[k]) for k, v in checks.items()},
        record=record, memory_peak_bytes=memory_peak)
