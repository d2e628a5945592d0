"""The controls of the comparison that decides ``correct``, on the card
at a cell's own size, each judged by the cell's own comparison against
the float32 reference: ``fp8``, the plain reference put in the
program's place and computed in float8 e4m3 (the precision below the
configurations' bf16); ``program_int8``, the serving cells' program
with its own int8 path switched on (the serving CLI's ``--quantize``:
the classifier's backbone in int8, calibrated on the pool's crops);
``half``, a training cell's planted fault of a step that takes its loss
over half of each batch. ``program`` reads the program itself, the
cell's driver run in this one process seed after seed with a short
window: the lower end. The benchmark's runs never run this; it reads
the ends of each limit (``PERF.md``).

    python3 -m hgr_bench.control --workload <name> --seeds <n> [<n> ...] \\
        [--variant fp8|program_int8|half|program]

Prints one JSON line per seed: the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from hgr_bench import harness, scenes, weights
from hgr_bench.reference import Precision, exact_float32, yolo
from hgr_bench.reference import serve as ref_serve


def train_numbers(cfg, tr, seed, device, variant):
    from hgr_bench.drivers import train_epoch as D

    image = (tr["image_size"], tr["image_size"])
    n, cs, bsz = tr["rows"], tr["canvas_size"], tr["batch_size"]
    state0 = weights.mtn_state(cfg, image, seed, device)
    rows = D.make_rows(n, cs, D.staging_window(cfg["train"]["augments"]),
                       tr["orig_hw_range"],
                       weights.generator(seed, "rows", device), device)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        weights.subseed(seed, "order"))).numpy()
    layout = D.spec(cs)
    batches = []
    for i in range(tr["warm_steps"], tr["warm_steps"] + tr["check_steps"]):
        idx = torch.from_numpy(perm[i * bsz:(i + 1) * bsz].copy()).to(device)
        batches.append({k: torch.index_select(v, 0, idx).reshape(
            (bsz,) + layout[k][1]) for k, v in rows.items()})
    del rows
    harness.free(device)
    ref = D.reference(cfg, tr, state0, batches, seed, device)
    if variant == "half":
        other = D.reference(cfg, tr, state0, batches, seed, device,
                            keep_rows=0.5)
    else:
        other = D.reference(cfg, tr, state0, batches, seed, device,
                            prec=variant)
    return D.compare(other, ref)


def served_classify(logits, hm):
    """The answers a service would give from these outputs."""
    probs = torch.softmax(logits.float(), -1).cpu().numpy()
    hmn = hm.permute(0, 3, 1, 2).flatten(2)
    top = hmn.max(-1)
    cells = top.indices.cpu().numpy()
    w = hm.shape[2]
    lm = np.stack([cells % w, cells // w], -1).astype(np.float32) * 4.0
    lm[(top.values <= 0).cpu().numpy()] = 0.0
    return [{"probs": probs[i], "landmarks": lm[i]}
            for i in range(len(probs))]


def quantized_classifier(cfg, image, state0, calib, device):
    """The package's classifier in the configuration's dtype with its
    backbone quantized to int8 from the crops ``calib`` (the serving
    CLI's ``--quantize``)."""
    from hgr_tpu_torch.infer.quant import quantize_from_crops
    from hgr_tpu_torch.infer.weights import build_classifier

    model = build_classifier(state0, image,
                             getattr(torch, cfg["model"]["compute_dtype"]),
                             cfg["model"]["backbone"], device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calib.npy")
        np.save(path, calib)
        return quantize_from_crops(model, path)


def classify_numbers(cfg, tr, seed, device, variant):
    from hgr_bench.drivers.classifier_service import reference_outputs

    image = (tr["image_size"], tr["image_size"])
    state0 = weights.serving_state(cfg, image, seed, device)
    pool = scenes.crops(tr["pool"], image[0], weights.subseed(seed, "crops"))
    rng = np.random.RandomState(weights.subseed(seed, "sample") % 2**32)
    crops = pool[rng.randint(0, len(pool),
                             tr["check_requests"] * tr["window_crops"])]
    logits, hm = reference_outputs(cfg, image, state0, crops, device)
    if variant == "program_int8":
        from hgr_tpu_torch.serve.engine import ClassifierService

        svc = ClassifierService(quantized_classifier(
            cfg, image, state0, pool, device), max_batch=tr["max_batch"])
        try:
            served = svc.submit_many(list(crops)).result(timeout=600)
        finally:
            svc.stop()
    else:
        lo, hmo = reference_outputs(cfg, image, state0, crops, device,
                                    variant)
        served = served_classify(lo, hmo)
    return ref_serve.judge_classify(logits, hm, served)


def detect_numbers(cfg, tr, seed, device, variant):
    from hgr_bench.drivers import detector_service as D
    from hgr_bench.drivers.classifier_service import reference_outputs

    det = cfg["detector"]
    image = (cfg["classifier"]["image_size"],) * 2
    state0 = weights.serving_state(cfg, image, seed, device)
    pool = scenes.frames(tr["pool"], tuple(tr["frame_hw"]), tr["hand_side"],
                         weights.subseed(seed, "frames"),
                         weights.generator(seed, "frames", device))
    rng = np.random.RandomState(weights.subseed(seed, "sample") % 2**32)
    frames = pool[rng.randint(0, len(pool), tr["check_frames"])]
    if variant == "program_int8":
        from hgr_tpu_torch.config import DEFAULT_NAMES
        from hgr_tpu_torch.infer.detect import HandGesturePipeline
        from hgr_tpu_torch.infer.weights import load_detector_weights

        calib = scenes.crops(256, image[0], weights.subseed(seed, "crops"))
        model = quantized_classifier(cfg, image, state0, calib, device)
        pipe = HandGesturePipeline(
            model.state_dict(), load_detector_weights(D.detector_path(cfg)),
            dict(DEFAULT_NAMES), det_img_size=det["image_size"],
            cls_img_size=image, score_thresh=det["score_thresh"],
            dtype=getattr(torch, cfg["model"]["compute_dtype"]),
            backbone=cfg["model"]["backbone"], device=device)
        served = []
        for i in range(0, len(frames), tr["max_batch"]):
            served += pipe.infer_frames(frames[i:i + tr["max_batch"]])
        del pipe, model
        return D.reference_check(cfg, tr, state0, frames, served, device)
    with exact_float32(), torch.no_grad():
        model = yolo.load_npz(yolo.YOLOv7Tiny(Precision(variant)),
                              D.detector_path(cfg)).to(device).eval()
        rows, scores = ref_serve.detector_rows(
            model, torch.from_numpy(frames).to(device), det["image_size"])
        k = scores.argmax(-1)
        ar = torch.arange(len(frames), device=device)
        boxes, best = rows[ar, k], scores[ar, k]
        crops = ref_serve.crop_warp(torch.from_numpy(frames).to(
            device).float(), boxes, image[0])
    logits, hm = reference_outputs(cfg, image, state0, crops, device,
                                   variant)
    answers = served_classify(logits, hm)
    side = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    corner = torch.stack([(boxes[:, 0] + boxes[:, 2]) / 2 - side / 2,
                          (boxes[:, 1] + boxes[:, 3]) / 2 - side / 2], -1)
    served = []
    for i, a in enumerate(answers):
        if float(best[i]) <= det["score_thresh"]:
            served.append(None)
            continue
        lm = (torch.from_numpy(a["landmarks"]).to(device) / 4.0
              / hm.shape[2] * side[i] + corner[i])
        served.append({"label": int(np.argmax(a["probs"])),
                       "score": float(best[i]),
                       "box": boxes[i].cpu().numpy().astype(np.int32),
                       "landmarks": lm.cpu().numpy().astype(np.int32)})
    return D.reference_check(cfg, tr, state0, frames, served, device)


NUMBERS = {"train_epoch": train_numbers,
           "classifier_service": classify_numbers,
           "detector_service": detect_numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", default="fp8",
                   choices=("fp8", "program_int8", "half", "program"))
    p.add_argument("--seconds", type=float, default=1.0,
                   help="the window of a program reading")
    args = p.parse_args(argv)
    work, cfg, tr = harness.cell(harness.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    fn = NUMBERS[tr["driver"]]
    allowed = (("fp8", "half", "program") if tr["driver"] == "train_epoch"
               else ("fp8", "program_int8", "program"))
    if args.variant not in allowed:
        raise SystemExit(f"no {args.variant} control for {args.workload}")
    for seed in args.seeds:
        if args.variant == "program":
            ctx = harness.Ctx(work, cfg, tr, seed, args.seconds, False, dev,
                              time.monotonic())
            res = harness.driver(tr)(ctx)
            out = res.record.get("numbers") or {
                k: v for k, (v, _) in res.checks.items()}
        else:
            out = fn(cfg, tr, seed, dev, args.variant)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant, **out}), flush=True)
        harness.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
