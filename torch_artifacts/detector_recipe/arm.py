"""One arm of the detector recipe: YOLOv7-tiny trained by
``hgr_tpu_torch.tools.train_detector_smoke`` at the JAX tool's defaults
(800 steps on 250 unique batches, B 16, 416 px, Adam 1e-3) and scored,
or the JAX tool's trained weights scored. From the repository root:

    python torch_artifacts/detector_recipe/arm.py repaired --seed S \\
        --npz build/detector_recipe/s{S}.npz --out DIR [tool flags...]
    python torch_artifacts/detector_recipe/arm.py before --seed S ...
    python torch_artifacts/detector_recipe/arm.py fixture --out DIR
    python torch_artifacts/detector_recipe/arm.py rule --out DIR

Arms:

- ``repaired``: the tool as it is, whose detect heads are drawn as the
  JAX package draws them (Flax's ``lecun_normal``, zero biases).
- ``before``: the same run with the three detect heads redrawn after
  the model's init as the port drew them until the repair: U(+-1/
  sqrt(fan_in)) weights and biases, from the same generator. The other
  variables, the scene pool, the steps and the eval are the repaired
  arm's.
- ``fixture``: ``tests/fixtures/yolo_smoke_weights.npz``, the JAX tool's
  seed-0 weights (float16), read by ``load_detector_weights`` and scored
  on seed 0's eval scenes, the scenes of the JAX tool's mean IoU 0.801
  and IoU > 0.5 share 0.938 (BENCH_LOG.md, "Detector smoke").

Each writes DIR/{arm}_s{S}/summary.json: the first loss, the mean of the
last 20, the tool's best-box mean IoU, IoU > 0.5 share and mean score on
its 64 eval scenes (``RandomState(S + 999)``), the hands that
``HandGesturePipeline`` localizes at IoU > 0.5 on ``chip_smoke.py``'s 64
frames of 360x640 (``_scenes(64, seed=5)``, ``_hits``) from the weights
as written (float16), the milliseconds a step and the pool's seconds.
``rule`` reads the summaries of seeds 0-4 and writes DIR/rule.json: each
arm's figures per seed and over the seeds, and the decision rule's three
tests (the fixture within 0.02 mean IoU of 0.801; the repaired arm's seed
0 at mean IoU >= 0.70; its IoU > 0.5 share over the five seeds >= 0.80).

Other flags go to the tool (``--steps 2 --size 224`` with ``--device
cpu`` for a rehearsal on the CPU). The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)  # the port's package and chip_smoke.py
FIXTURE = os.path.join(REPO, "tests", "fixtures", "yolo_smoke_weights.npz")
SEEDS = range(5)
# the JAX tool at its defaults, seed 0 (BENCH_LOG.md, "Detector smoke")
JAX_MEAN_IOU, JAX_SHARE = 0.801, 0.938


def redraw_heads_as_before(model, generator: torch.Generator) -> None:
    """The detect heads as the port drew them until the repair: weights
    and biases U(+-1/sqrt(fan_in))."""
    with torch.no_grad():
        for i in range(3):
            conv = getattr(model, f"detect{i}")
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=generator)
            conv.bias.uniform_(-bound, bound, generator=generator)


def train(arm: str, seed: int, npz: str, tool_flags) -> dict:
    """The tool's ``main`` at its defaults (plus ``tool_flags``); for the
    ``before`` arm with its model class's heads redrawn after the init."""
    from hgr_tpu_torch.models import yolo
    from hgr_tpu_torch.tools import train_detector_smoke as tool

    argv = ["--seed", str(seed), "--out", npz, *tool_flags]
    if arm == "repaired":
        return tool.main(argv)
    repaired = yolo.YOLOv7Tiny

    class Before(repaired):
        def __init__(self, *args, generator: torch.Generator, **kw):
            super().__init__(*args, generator=generator, **kw)
            redraw_heads_as_before(self, generator)

    yolo.YOLOv7Tiny = Before  # main looks the class up when it runs
    try:
        return tool.main(argv)
    finally:
        yolo.YOLOv7Tiny = repaired


def pipeline_hits(det_state, device) -> int:
    """Hands localized at IoU > 0.5 by the bf16 pipeline on chip_smoke's
    64 frames, the measure of its detector_train line."""
    import chip_smoke
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_classifier_weights

    pipe = HandGesturePipeline(
        load_classifier_weights("", (chip_smoke.IMAGE, chip_smoke.IMAGE),
                                seed=0),
        det_state, DEFAULT_NAMES, dtype=torch.bfloat16, device=device)
    scenes, gts = chip_smoke._scenes(chip_smoke.DET_EVAL, seed=5)
    return int(chip_smoke._hits(chip_smoke._pipeline_results(pipe, scenes),
                                gts))


def _card(device):
    return torch.cuda.get_device_name(0) if device != "cpu" else None


def fixture_readings(device, eval_n: int = 64, size: int = 416) -> dict:
    """The JAX tool's weights through the port's eval on seed 0's scenes,
    in bf16 (the tool's compute type) and in f32."""
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.models.yolo import YOLOv7Tiny
    from hgr_tpu_torch.tools import train_detector_smoke as tool

    state = load_detector_weights(FIXTURE)
    frames, gts = tool.make_batch(np.random.RandomState(999), eval_n, size)
    x = torch.from_numpy(frames).to(device)
    out = {}
    for tag, dtype in (("", torch.bfloat16), ("_f32", torch.float32)):
        model = YOLOv7Tiny(num_classes=1, dtype=dtype)
        model.load_state_dict(state)
        boxes, scores = tool.best_boxes(model.to(device), x)
        ious = tool.iou_xyxy(boxes, tool.cxcywh_to_xyxy(gts))
        out.update({f"mean_iou{tag}": float(ious.mean()),
                    f"iou_gt_0_5_share{tag}": float((ious > 0.5).mean()),
                    f"mean_score{tag}": float(scores.mean())})
    return {"arm": "fixture", "seed": 0, "device": device,
            "card": _card(device), "weights": os.path.relpath(FIXTURE, REPO),
            "eval_scenes": eval_n, **out,
        "pipeline_hits": pipeline_hits(state, device), "pipeline_frames": 64,
        "jax_mean_iou": JAX_MEAN_IOU, "jax_iou_gt_0_5_share": JAX_SHARE}


def arm_readings(arm: str, seed: int, npz: str, tool_flags, device) -> dict:
    from hgr_tpu_torch.infer.weights import load_detector_weights

    res = train(arm, seed, npz, tool_flags)
    losses, ious = res["losses"], res["ious"]
    return {"arm": arm, "seed": seed, "device": device,
            "card": _card(device),
            "steps": len(losses), "loss_first": losses[0],
            "loss_last20_mean": float(np.mean(losses[-20:])),
            "eval_scenes": len(ious), "mean_iou": float(ious.mean()),
            "iou_gt_0_5_share": float((ious > 0.5).mean()),
            "mean_score": float(res["scores"].mean()),
            "pipeline_hits": pipeline_hits(load_detector_weights(npz),
                                           device),
            "pipeline_frames": 64, "ms_per_step": res["ms_per_step"],
            "pool_seconds": res["pool_seconds"]}


def _load(out: str, name: str) -> dict:
    with open(os.path.join(out, name, "summary.json")) as f:
        return json.load(f)


def rule(out: str) -> dict:
    """Each arm per seed and over the seeds, and the decision rule."""
    fixture = _load(out, "fixture_s0")
    arms = {}
    for arm in ("repaired", "before"):
        rows = [_load(out, f"{arm}_s{s}") for s in SEEDS]
        arms[arm] = {
            "per_seed": {r["seed"]: {k: r[k] for k in (
                "mean_iou", "iou_gt_0_5_share", "mean_score",
                "pipeline_hits", "loss_first", "loss_last20_mean",
                "ms_per_step", "pool_seconds")} for r in rows},
            "mean_iou": float(np.mean([r["mean_iou"] for r in rows])),
            "iou_gt_0_5_share": float(np.mean(
                [r["iou_gt_0_5_share"] for r in rows])),
            "pipeline_hits": float(np.mean([r["pipeline_hits"]
                                            for r in rows]))}
    rep = arms["repaired"]
    tests = {
        "fixture_within_0_02_of_jax":
            abs(fixture["mean_iou"] - JAX_MEAN_IOU) <= 0.02,
        "repaired_seed0_mean_iou_at_least_0_70":
            rep["per_seed"][0]["mean_iou"] >= 0.70,
        "repaired_share_over_seeds_at_least_0_80":
            rep["iou_gt_0_5_share"] >= 0.80}
    return {"fixture": fixture, **arms, "tests": tests,
            "repaired_passes": (tests["repaired_seed0_mean_iou_at_least_0_70"]
                                and tests[
                                    "repaired_share_over_seeds_at_least_0_80"])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("arm", choices=("repaired", "before", "fixture", "rule"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--npz", help="where the trained arms write weights")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args, tool_flags = p.parse_known_args(argv)
    if args.arm == "rule":
        result, path = rule(args.out), os.path.join(args.out, "rule.json")
    else:
        if args.arm == "fixture":
            result = fixture_readings(args.device)
        else:
            result = arm_readings(args.arm, args.seed, args.npz,
                                  [*tool_flags, "--device", args.device],
                                  args.device)
        path = os.path.join(args.out, f"{args.arm}_s{args.seed}",
                            "summary.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
