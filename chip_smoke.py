#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
serving path through the entry points a user calls — MultiTaskNet
forwards and a ClassifierService with its HTTP handler — at the full
width of the 'small' 192x192 model with seeded random weights, and
checks that the path launched the kernels and that its outputs are
right.

    python3 chip_smoke.py

Prints one JSON object per line (and the card's name and power limit as
nvidia-smi prints them); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises and exits non-zero; without a CUDA card it exits
non-zero before printing a result.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

HEADS, HEAD_DIM = 8, 32
SCALE = HEAD_DIM**-0.5
IMAGE = 192
SERVE_BATCH = 64
# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; 989 TFLOP/s
# bf16 tensor cores, 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Kernel vs its plain version on the card: the JAX kernel tests' own
# tolerances (tests/test_attention_pallas.py); bf16 output is one rounding
# of an f32 sum whose order differs, so one bf16 ulp at |out| < 2.
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# Card f32 forward (TF32 off) vs the same weights' CPU forward: ~30
# layers of f32 sums in another order; the CPU port itself is held at
# 1e-4 against the JAX package.
MODEL_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` on the card by CUDA events over ``iters``
    back-to-back calls (warm L2: the inputs fit in the 50 MB cache)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_phase():
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    t0 = time.perf_counter()
    built = load_kernel("attention_qkv_fwd")
    usage = re.findall(r"Used \d+ registers[^\n]*", built.ptxas_log)
    spills = re.findall(r"\d+ bytes spill stores, \d+ bytes spill loads",
                        built.ptxas_log)
    emit({"build": {
        "kernel": "attention_qkv_fwd",
        "source": "hgr_tpu_torch/csrc/attention_qkv_fwd.cu",
        "nvcc_seconds": built.build_seconds,
        "load_seconds": time.perf_counter() - t0,
        "ptxas_float_bf16": usage,
        "spills": spills,
        # dynamic shared memory, which ptxas does not see
        "smem_bytes_per_block_n145": built.lib.attention_qkv_fwd_smem_bytes(
            145),
    }})


def kernel_phase(torch):
    """Kernel vs plain version at the serving shapes; times at B=64."""
    from hgr_tpu_torch.ops.attention import (
        attention_qkv_reference,
        fused_attention_qkv,
        split_heads,
    )

    import torch.nn.functional as F

    checks, main = [], None
    for b, n, dtype in [(64, 145, "bfloat16"), (64, 145, "float32"),
                        (1, 37, "bfloat16"), (1, 37, "float32")]:
        gen = torch.Generator(device="cuda").manual_seed(b * 1000 + n)
        qkv = torch.randn(b, n, 3 * HEADS * HEAD_DIM, device="cuda",
                          generator=gen).to(getattr(torch, dtype))
        out = fused_attention_qkv(qkv, HEADS, HEAD_DIM, SCALE)
        ref = attention_qkv_reference(qkv, HEADS, HEAD_DIM, SCALE)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row = {"shape": [b, n, 3 * HEADS * HEAD_DIM], "dtype": dtype,
               "max_abs_err": err, "tol": KERNEL_TOL[dtype]}
        check(err <= KERNEL_TOL[dtype],
              f"kernel vs plain at {row['shape']} {dtype}: {err}")
        if b == 64:
            q, k, v = split_heads(qkv, HEADS, HEAD_DIM)

            def kern():
                return fused_attention_qkv(qkv, HEADS, HEAD_DIM, SCALE)

            def plain():
                return attention_qkv_reference(qkv, HEADS, HEAD_DIM, SCALE)

            def library():
                return F.scaled_dot_product_attention(q, k, v, scale=SCALE)

            # plain, kernel, library, then the reverse order
            t = {"plain": [], "kernel": [], "library": []}
            for name in ["plain", "kernel", "library", "library", "kernel",
                         "plain"]:
                fn = {"plain": plain, "kernel": kern,
                      "library": library}[name]
                t[name].append(cuda_time_ms(torch, fn))
            lib_err = (library().transpose(1, 2).reshape(out.shape).float()
                       - out.float()).abs().max().item()
            nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
            flops = 4 * b * HEADS * n * n * HEAD_DIM
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            row.update({
                "ms": float(np.mean(t["kernel"])),
                "plain_ms": float(np.mean(t["plain"])),
                "library_ms": float(np.mean(t["library"])),
                "runs_ms": t,
                "library_max_abs_err": lib_err,
                "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
            if dtype == "bfloat16":
                main = row
        checks.append(row)
    emit({"kernel_checks": checks})
    return main


def model_phase(torch, state):
    """MultiTaskNet forwards on the card: bf16 and f32 at B=64, and the
    f32 forward at B=8 against the same weights on the CPU."""
    from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.ops.attention import fused_attention_qkv

    def build(dtype, device):
        m = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=dtype)
        m.load_state_dict(state, strict=True)
        return m.eval().to(device)

    rng = np.random.RandomState(0)
    crops = rng.randint(0, 256, (SERVE_BATCH, IMAGE, IMAGE, 3), np.uint8)
    x = (crops.astype(np.float32) / 255.0 - np.asarray(IMAGENET_MEAN,
         np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    x_cuda = torch.from_numpy(x).cuda()
    forwards = 0
    result = {}
    for name, dtype in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        model = build(dtype, "cuda")

        def fwd():
            nonlocal forwards
            forwards += 1
            return model(x_cuda, need_attnmap=False)

        with torch.inference_mode():
            ms = cuda_time_ms(torch, fwd, iters=20, warmup=3)
            logits, hmap, attn = fwd()
            torch.cuda.synchronize()
        check(attn is None, "need_attnmap=False returns no map")
        check(tuple(logits.shape) == (SERVE_BATCH, 19)
              and tuple(hmap.shape) == (SERVE_BATCH, IMAGE // 4, IMAGE // 4,
                                        21), f"{name} output shapes")
        check(bool(torch.isfinite(logits).all() and torch.isfinite(hmap)
                   .all()), f"{name} outputs finite")
        result[f"{name}_ms_per_forward_b64"] = ms
        result[f"{name}_crops_per_s_b64"] = SERVE_BATCH / ms * 1e3

    model_cuda = build(torch.float32, "cuda")
    model_cpu = build(torch.float32, "cpu")
    with torch.inference_mode():
        forwards += 1
        lc, hc, _ = model_cuda(x_cuda[:8], need_attnmap=False)
        lp, hp, _ = model_cpu(torch.from_numpy(x[:8]), need_attnmap=False)
    err_logits = (lc.cpu() - lp).abs().max().item()
    err_hmap = (hc.cpu() - hp).abs().max().item()
    check(max(err_logits, err_hmap) <= MODEL_TOL,
          f"card f32 vs CPU f32 forward: {err_logits}, {err_hmap}")
    launches = fused_attention_qkv.launches
    check(launches == 4 * forwards,
          f"attention launches {launches} != 4 x {forwards} forwards")
    result.update({
        "f32_b8_vs_cpu_max_abs_err_logits": err_logits,
        "f32_b8_vs_cpu_max_abs_err_heatmap": err_hmap, "tol": MODEL_TOL,
        "forwards": forwards, "attention_launches": launches,
    })
    emit({"model": result})
    return forwards


def serve_phase(torch, state):
    """2048 crops through ClassifierService from 4 client threads, then
    POST /classify through the port's HTTP handler."""
    from hgr_tpu_torch.cli.serve import make_handler
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.serve import ClassifierService

    model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=torch.bfloat16)
    model.load_state_dict(state, strict=True)
    model = model.eval().to("cuda")
    svc = ClassifierService(model, class_names=DEFAULT_NAMES,
                            max_batch=SERVE_BATCH, max_wait_ms=5.0,
                            pipeline_depth=4)
    httpd = None
    try:
        svc.warm()
        n_clients, per_client = 4, 512
        rng = np.random.RandomState(1)
        crops = rng.randint(0, 256, (n_clients, per_client, IMAGE, IMAGE, 3),
                            np.uint8)
        results = [None] * n_clients
        errors = []

        def client(i):
            try:
                futs = [svc.submit(c) for c in crops[i]]
                results[i] = [f.result(timeout=120.0) for f in futs]
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        seconds = time.perf_counter() - t0
        check(not errors, f"client errors: {errors[:1]}")
        check(all(not t.is_alive() for t in threads), "clients finished")
        answers = [r for rs in results for r in rs]
        check(len(answers) == n_clients * per_client, "every crop answered")
        for r in answers:
            p, lm = np.asarray(r["probs"]), np.asarray(r["landmarks"])
            check(p.shape == (19,) and bool(np.isfinite(p).all())
                  and abs(float(p.sum()) - 1.0) < 1e-3, "probs")
            check(lm.shape == (21, 2) and bool((lm >= 0).all())
                  and bool((lm < IMAGE).all()), "landmarks inside the crop")
        snap = svc.metrics.snapshot()

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        http_ok = 0
        for i in range(3):
            buf = io.BytesIO()
            np.save(buf, crops[0, i])
            req = urllib.request.Request(f"{base}/classify",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                check(r.status == 200, "POST /classify status")
                body = json.loads(r.read())
            p = np.asarray(body["probs"])
            lm = np.asarray(body["landmarks"])
            check(p.shape == (19,) and abs(float(p.sum()) - 1.0) < 1e-3
                  and body["label"] == int(p.argmax()), "HTTP probs")
            check(lm.shape == (21, 2) and bool((lm >= 0).all())
                  and bool((lm < IMAGE).all()), "HTTP landmarks")
            check(body["label"] == answers[i]["label"],
                  "HTTP answer equals the direct answer")
            http_ok += 1
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        check(stats["errors"] == 0, "no serving errors")
        emit({"serve": {
            "dtype": "bfloat16", "max_batch": SERVE_BATCH,
            "clients": n_clients, "crops": len(answers),
            "seconds": seconds, "crops_per_s": len(answers) / seconds,
            "request_latency_ms": snap.get("latency_ms"),
            "batches": snap["batches"], "batch_hist": snap["batch_hist"],
            "http_classify_ok": http_ok, "forwards": svc.forwards,
        }})
        return svc.forwards
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        svc.stop()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hgr_tpu_torch.infer.weights import load_classifier_weights
    from hgr_tpu_torch.ops.attention import fused_attention_qkv

    print(card_line(), flush=True)
    emit({"versions": {"python": sys.version.split()[0],
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda}})
    # float32 references are full float32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase()
    main_row = kernel_phase(torch)

    state = load_classifier_weights("", (IMAGE, IMAGE), seed=0)
    fused_attention_qkv.launches = 0  # the main path starts here
    forwards = model_phase(torch, state)
    forwards += serve_phase(torch, state)
    launches = fused_attention_qkv.launches  # ... and ends here
    check(launches == 4 * forwards,
          f"attention launches {launches} != 4 x {forwards} forwards")
    check(launches > 0, "the main path launched the attention kernel")

    emit({"kernels": [{
        "name": "attention_qkv_fwd",
        "route": "cuda",
        "source": "hgr_tpu_torch/csrc/attention_qkv_fwd.cu",
        "replaces": "hgr_tpu/ops/attention_pallas.py:51",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
