"""Frame-serving cells: ``DetectorService`` around ``HandGesturePipeline``
as the serving CLI builds them (``cli/serve.py:build_detector_service``):
the configuration's detector weights (read by the package from the
committed ``.npz``), the benchmark's seeded classifier weights, both in
the configuration's dtype, warmed; then a closed loop of camera clients,
each with one frame outstanding.

``detect_frames_per_s`` counts every frame answered inside the window
over its length; the 95th percentile of the requests resolved inside
it, from the clients' side, is a per-layer reading
(``metrics/request_p95_ms.py``).

What decides ``correct``: a sample of the window's frames, drawn from
the seed, recomputed by the plain reference in float32
(``reference/serve.py``): the detector over the same frames
(``det_score``, ``det_box``), and the classifier over the crops of the
served boxes (``landmark``), each against the traffic file's limit.
The served label's logit gap is printed, not compared: the controls
read it 0 on most seeds, as the program does (``PERF.md``).
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from hgr_bench import clients, counts, scenes, weights
from hgr_bench.drivers.classifier_service import reference_outputs, sample
from hgr_bench.harness import REPO, Ctx, Outcome, free
from hgr_bench.reference import Precision, exact_float32, yolo
from hgr_bench.reference import serve as ref_serve


def detector_path(cfg) -> str:
    """The configuration's detector weights, after checking their
    digest: the cell's work is defined by these bytes."""
    path = REPO / cfg["detector"]["weights"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["detector"]["sha256"]:
        raise ValueError(f"{path}: sha256 {digest} is not the "
                         "configuration's")
    return str(path)


def reference_check(cfg, tr, state0, frames_u8, served, device,
                    prec="float32", block: int = 64):
    """The four numbers of the module docstring over the sampled frames."""
    det = cfg["detector"]
    size = det["image_size"]
    with exact_float32(), torch.no_grad():
        model = yolo.load_npz(yolo.YOLOv7Tiny(Precision(prec)),
                              detector_path(cfg)).to(device).eval()
        rows, scores = [], []
        for i in range(0, len(frames_u8), block):
            r, s = ref_serve.detector_rows(model, torch.from_numpy(
                frames_u8[i:i + block]).to(device), size)
            rows.append(r)
            scores.append(s)
    rows, scores = torch.cat(rows), torch.cat(scores)
    out = ref_serve.judge_detect(rows, scores, served, det["score_thresh"])
    hit = [i for i, a in enumerate(served) if a is not None]
    out.update(label=0.0, landmark=0.0)
    if hit:
        cls = cfg["classifier"]
        image = (cls["image_size"], cls["image_size"])
        boxes = torch.tensor(np.stack([served[i]["box"] for i in hit]),
                             dtype=torch.float32, device=device)
        with exact_float32(), torch.no_grad():
            crops = ref_serve.crop_warp(torch.from_numpy(
                frames_u8[hit]).to(device).float(), boxes, image[0])
        logits, hm = reference_outputs(cfg, image, state0, crops, device,
                                       prec)
        out.update(ref_serve.judge_detect_classify(
            logits, hm, boxes, [served[i] for i in hit]))
    return out


def run(ctx: Ctx) -> Outcome:
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.ops.attention import fused_attention_qkv
    from hgr_tpu_torch.serve.engine import DetectorService

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    det, cls = cfg["detector"], cfg["classifier"]
    image = (cls["image_size"], cls["image_size"])
    dtype = getattr(torch, cfg["model"]["compute_dtype"])
    state0 = weights.serving_state(cfg, image, seed, dev)
    pipe = HandGesturePipeline(
        state0, load_detector_weights(detector_path(cfg)),
        dict(DEFAULT_NAMES), det_img_size=det["image_size"],
        cls_img_size=image, score_thresh=det["score_thresh"], dtype=dtype,
        backbone=cfg["model"]["backbone"], device=dev)
    pool = scenes.frames(tr["pool"], tuple(tr["frame_hw"]), tr["hand_side"],
                         weights.subseed(seed, "frames"),
                         weights.generator(seed, "frames", dev))

    def make_request(rng):
        i = int(rng.randint(0, len(pool)))
        return i, pool[i]

    svc = DetectorService(pipe, frame_hw=tuple(tr["frame_hw"]),
                          max_batch=tr["max_batch"],
                          max_wait_ms=tr["max_wait_ms"])
    res, stats, record, memory_peak = clients.serve_window(
        svc, svc.submit, make_request, ctx, 1,
        lambda: fused_attention_qkv.launches)
    record["forward_flops"] = (counts.yolo_forward_flops(det["image_size"])
                               + counts.mtn_forward_flops(cfg, image))

    del pipe, svc
    free(dev)
    picked = sample(res["done"], tr["check_frames"], seed, res["end"])
    frames_u8 = np.stack([pool[d[2]] for d in picked])
    checks = reference_check(cfg, tr, state0, frames_u8,
                             [d[3] for d in picked], dev)
    print(f"label logit gap {checks.pop('label')}", file=sys.stderr)
    limits = tr["limits"]
    return Outcome(
        attempted=stats["attempted"], failed=stats["failed"],
        metrics={"detect_frames_per_s": stats["items_per_s"],
                 "setup_s": res["start"] - ctx.started},
        checks={k: (v, limits[k]) for k, v in checks.items()},
        record=record, memory_peak_bytes=memory_peak)
