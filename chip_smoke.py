#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch
version on the card, then drives the main paths through the entry points
a user calls, at the full width of the 'small' 192x192 model with seeded
random weights:

- serving: MultiTaskNet forwards and a ClassifierService with its HTTP
  handler (the attention forward kernel);
- the train step: ``make_train_step`` with the CLI defaults (bf16,
  de-mixed pullbacks, no accumulation) on staged uint8 canvases (the
  fused jitter + warp kernel, the attention forward and backward
  kernels), in turns with the fused BN(+SiLU) route off and on (the two
  bn backward kernels);
- training from files: ``hgr_tpu_torch.cli.train``'s ``run`` on a
  synthetic JPEG dataset made from a seed, fused BN on: 2 epochs, the
  test split from the best checkpoint, a ``--resume`` epoch, then two
  ``--device_cache`` epochs.

Each path starts with the launch counts at 0 and checks that it launched
its kernels, as many times as the code gives, and that its outputs are
right. Scratch files go to build/chip_smoke/ in this checkout.

    python3 chip_smoke.py

Prints one JSON object per line (and the card's name and power limit as
nvidia-smi prints them); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
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
TRAIN_BATCH, CANVAS = 256, 256
# per kernel, its source (csrc/<name>.cu) and the TPU kernel it replaces
KERNELS = {
    "attention_qkv_fwd": ("attention_qkv_fwd",
                          "hgr_tpu/ops/attention_pallas.py:51"),
    "attention_qkv_bwd": ("attention_qkv_bwd",
                          "hgr_tpu/ops/attention_pallas.py:175"),
    "warp_twopass": ("warp_twopass", "hgr_tpu/ops/warp_pallas.py:251"),
    "bn_act_reduce": ("bn_act_bwd", "hgr_tpu/ops/bn_act_pallas.py:102"),
    "bn_act_elem": ("bn_act_bwd", "hgr_tpu/ops/bn_act_pallas.py:129"),
}
SOURCES = tuple(dict.fromkeys(src for src, _ in KERNELS.values()))
TRAIN_TURNS = ("off", "on", "on", "off")  # fused BN route, A/B turns
TURN_WARMUP, TURN_STEPS = 2, 6
# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; 989 TFLOP/s
# bf16 tensor cores, 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Kernel vs its plain version on the card: the JAX kernel tests' own
# tolerances (tests/test_attention_pallas.py); bf16 output is one rounding
# of an f32 sum whose order differs, so one bf16 ulp at |out| < 2.
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# Backward kernel vs its plain version: the JAX package's gradient
# tolerance 1e-4 in f32; in bf16 each gradient is one rounding of an f32
# sum taken in another order, one bf16 ulp (2^-8 relative) at most:
# atol 2e-2 plus rtol 2^-7.
GRAD_TOL = {"bfloat16": (2e-2, 2**-7), "float32": (1e-4, 1e-4)}
# Warp kernel vs its plain version, on the 0-255 scale: the JAX warp
# tests' 0.02 (tests/test_warp_pallas.py:35); both round every product
# and sum on its own (-fmad=false), so they are expected to agree exactly.
WARP_TOL = 0.02
# Card f32 train step (TF32 off) vs the same step on the CPU: per-tensor
# relative gradient error; f32 sums in other orders through ~30 layers,
# forward and two backwards.
STEP_GRAD_TOL = 1e-3
# Rough operation counts of the warp per output pixel, from the kernel
# source: the two-pass blend and positions (~45), and the HSV jitter of
# the source pixels it covers (~60), taken once per pixel.
WARP_FLOPS, JITTER_FLOPS = 45, 60
# Card f32 forward (TF32 off) vs the same weights' CPU forward: ~30
# layers of f32 sums in another order; the CPU port itself is held at
# 1e-4 against the JAX package.
MODEL_TOL = 1e-3
# bn kernels vs their plain versions on the card (ops/bn_act.py): T1 and
# T2 are f32 sums over M rows taken in another order (per-thread chunks,
# then fixed-order block and chunk sums, against torch's reduction), held
# at 1e-6 of the sum of the terms' magnitudes (the f32 error of a sum of
# 2.4 M terms is below ~1e-7 of it); dy is one rounding of f32 values that
# may differ by a few ulps (FMA contraction, expf): atol/rtol 1e-5 in f32,
# one bf16 ulp in bf16 (atol 2e-2 plus rtol 2^-7).
BN_SUM_TOL = 1e-6
BN_DY_TOL = {"bfloat16": (2e-2, 2**-7), "float32": (1e-5, 1e-5)}
BN_EPS = 1e-5
# f32 operations per element, from csrc/bn_act_bwd.cu: normalize 2; with
# the SiLU derivative 12 more (sigmoid 4, the product chain 8); the reduce
# accumulates 3, the elementwise pass combines 4.
BN_OPS = {("reduce", True): 17, ("reduce", False): 5,
          ("elem", True): 18, ("elem", False): 6}
# the loop phase: synthetic splits at the writer's 224 px
LOOP_SPLITS = (("train", 2048), ("val", 512), ("test", 512))


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
    """One nvcc per kernel source, all started together."""
    from hgr_tpu_torch.utils.cuda_build import load_kernels

    t0 = time.perf_counter()
    built = load_kernels(list(SOURCES))
    wall = time.perf_counter() - t0
    smem = {
        "attention_qkv_fwd": built["attention_qkv_fwd"].lib
        .attention_qkv_fwd_smem_bytes(145),
        "attention_qkv_bwd": built["attention_qkv_bwd"].lib
        .attention_qkv_bwd_smem_bytes(145),
        "warp_twopass": 0,
        "bn_act_bwd": 0,
    }
    for name in SOURCES:
        b = built[name]
        emit({"build": {
            "kernel": name,
            "source": f"hgr_tpu_torch/csrc/{name}.cu",
            "nvcc_seconds": b.build_seconds,
            "all_builds_wall_seconds": wall,
            "ptxas_float_bf16_u8": re.findall(r"Used \d+ registers[^\n]*",
                                              b.ptxas_log),
            "spills": re.findall(
                r"\d+ bytes spill stores, \d+ bytes spill loads",
                b.ptxas_log),
            # dynamic shared memory, which ptxas does not see
            "dynamic_smem_bytes_per_block_n145": smem[name],
        }})


def kernel_phase(torch):
    """Kernel vs plain version at the serving shapes; times at B=64 (the
    serving shape) and B=256 (the training shape)."""
    from hgr_tpu_torch.ops.attention import (
        attention_qkv_reference,
        fused_attention_qkv,
        split_heads,
    )

    import torch.nn.functional as F

    checks, main = [], None
    for b, n, dtype in [(64, 145, "bfloat16"), (64, 145, "float32"),
                        (256, 145, "bfloat16"), (1, 37, "bfloat16"),
                        (1, 37, "float32")]:
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
        if b >= 64:
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
            if (b, dtype) == (64, "bfloat16"):  # the serving shape
                main = row
        checks.append(row)
    emit({"kernel_checks": checks})
    return main


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _alternate(torch, fns, iters: int = 50) -> dict:
    """Mean CUDA-event time of each named fn, taken in the order given and
    then in reverse (plain, kernel, library, library, kernel, plain)."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(cuda_time_ms(torch, fns[name], iters=iters,
                                    warmup=min(5, iters)))
    return {"runs_ms": t, **{f"{n}_ms": float(np.mean(v))
                            for n, v in t.items()}}


def bwd_kernel_phase(torch):
    """Backward kernel vs plain version at the training shape (B=256) and
    smaller ones; times at B=256 and B=64 against the backward of
    scaled_dot_product_attention on split heads."""
    import torch.nn.functional as F

    from hgr_tpu_torch.ops.attention import (
        attention_qkv_bwd_reference,
        fused_attention_qkv_bwd,
        split_heads,
    )

    checks, main = [], None
    for b, n, dtype in [(TRAIN_BATCH, 145, "bfloat16"), (64, 145, "bfloat16"),
                        (64, 145, "float32"), (1, 37, "bfloat16"),
                        (1, 37, "float32")]:
        gen = torch.Generator(device="cuda").manual_seed(b * 1000 + n + 1)
        dt = getattr(torch, dtype)
        qkv = torch.randn(b, n, 3 * HEADS * HEAD_DIM, device="cuda",
                          generator=gen).to(dt)
        g = torch.randn(b, n, HEADS * HEAD_DIM, device="cuda",
                        generator=gen).to(dt)
        out = fused_attention_qkv_bwd(qkv, g, HEADS, HEAD_DIM, SCALE)
        ref = attention_qkv_bwd_reference(qkv, g, HEADS, HEAD_DIM, SCALE)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        atol, rtol = GRAD_TOL[dtype]
        excess = (diff - atol - rtol * ref.float().abs()).max().item()
        row = {"kernel": "attention_qkv_bwd", "shape": [b, n, 768],
               "dtype": dtype, "max_abs_err": diff.max().item(),
               "atol": atol, "rtol": rtol}
        check(excess <= 0, f"bwd kernel vs plain at {row['shape']} {dtype}: "
                           f"{row['max_abs_err']}")
        if b >= 64:
            q, k, v = (t.detach().requires_grad_()
                       for t in split_heads(qkv, HEADS, HEAD_DIM))
            o = F.scaled_dot_product_attention(q, k, v, scale=SCALE)
            g_h = g.reshape(b, n, HEADS, HEAD_DIM).permute(0, 2, 1, 3)
            row.update(_alternate(torch, {
                "plain": lambda: attention_qkv_bwd_reference(
                    qkv, g, HEADS, HEAD_DIM, SCALE),
                "kernel": lambda: fused_attention_qkv_bwd(
                    qkv, g, HEADS, HEAD_DIM, SCALE),
                "library": lambda: torch.autograd.grad(
                    o, (q, k, v), g_h, retain_graph=True),
            }))
            row["ms"] = row.pop("kernel_ms")
            row.update(_bound((2 * qkv.numel() + g.numel())
                              * qkv.element_size(),
                              10 * n * n * HEAD_DIM * HEADS * b, dtype))
            if b == TRAIN_BATCH:  # the training shape
                main = row
        checks.append(row)
    emit({"kernel_checks": checks})
    return main


def _warp_inputs(torch, b, rot, seed):
    from hgr_tpu_torch.ops.affine import build_affine

    rng = np.random.RandomState(seed)
    canvas = torch.from_numpy(rng.randint(
        0, 256, (b, CANVAS, CANVAS, 3), np.uint8)).cuda()
    m = build_affine(torch.full((b, 2), CANVAS / 2.0, device="cuda"),
                     torch.full((b,), 1.1, device="cuda"),
                     torch.full((b,), rot, device="cuda"),
                     torch.full((b,), 0.35 * CANVAS, device="cuda"),
                     (IMAGE, IMAGE))
    gains = torch.from_numpy(rng.uniform(0.7, 1.3, (b, 3)).astype(
        np.float32)).cuda()
    do_j = torch.from_numpy((rng.rand(b) < 0.5).astype(np.float32)).cuda()
    return canvas, m, gains, do_j


def warp_kernel_phase(torch):
    """Warp kernel vs plain version at B=256, S=256 -> 192: uint8 canvases
    with jitter at 0° and 90° (the transpose route), f32 and bf16
    canvases; times for each. No single PyTorch call computes this
    function (grid_sample has no jitter and no two-pass taps), so there
    is no library time."""
    from hgr_tpu_torch.ops.warp_fused import (
        warp_twopass,
        warp_twopass_reference,
    )

    checks, main = [], None
    for rot, dtype in [(0.0, "uint8"), (90.0, "uint8"), (30.0, "float32"),
                       (30.0, "bfloat16")]:
        canvas, m, gains, do_j = _warp_inputs(torch, TRAIN_BATCH, rot,
                                              seed=int(rot) + len(dtype))
        canvas = canvas.to(getattr(torch, dtype))
        kw = dict(jitter_gains=gains, do_jitter=do_j, round_output=True)
        out = warp_twopass(canvas, m, (IMAGE, IMAGE), **kw)
        ref = warp_twopass_reference(canvas, m, (IMAGE, IMAGE), **kw)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        row = {"kernel": "warp_twopass", "canvas": [TRAIN_BATCH, CANVAS,
                                                    CANVAS, 3],
               "dtype": dtype, "rot": rot, "jitter": True,
               "max_abs_err": diff.max().item(),
               "frac_above_tol": (diff > WARP_TOL).float().mean().item(),
               "tol": WARP_TOL}
        check(row["max_abs_err"] <= 1.0 and row["frac_above_tol"] < 0.01,
              f"warp kernel vs plain {dtype} rot {rot}: {row}")
        row.update(_alternate(torch, {
            "plain": lambda: warp_twopass_reference(canvas, m, (IMAGE, IMAGE),
                                                    **kw),
            "kernel": lambda: warp_twopass(canvas, m, (IMAGE, IMAGE), **kw),
        }))
        row["ms"] = row.pop("kernel_ms")
        out_px = TRAIN_BATCH * IMAGE * IMAGE
        row.update(_bound(
            canvas.numel() * canvas.element_size() + out.numel() * 4,
            out_px * (WARP_FLOPS + JITTER_FLOPS * do_j.mean().item()),
            "float32"))
        row["library_ms"] = None
        if main is None:
            main = row
        checks.append(row)
    main["max_abs_err"] = max(r["max_abs_err"] for r in checks)
    emit({"kernel_checks": checks})
    return main


def _staged_batch(b: int, seed: int) -> dict:
    """A staged training batch in the loader's layout, made with numpy:
    random uint8 canvases holding images of 200-400 px scaled into the
    canvas, joints inside the central window, valid all ones."""
    rng = np.random.RandomState(seed)
    sizes = rng.uniform(200, 400, (b, 2)).astype(np.float32)
    scale = CANVAS / sizes.max(axis=1)
    a = np.zeros((b, 2, 3), np.float32)
    a[:, 0, 0] = a[:, 1, 1] = scale
    return {
        "canvas": rng.randint(0, 256, (b, CANVAS, CANVAS, 3), np.uint8),
        "orig_to_canvas": a,
        "sizes_hw": sizes,
        "joints": (rng.uniform(0.35, 0.65, (b, 21, 2))
                   * sizes[:, None, ::-1]).astype(np.float32),
        "joints_vis": np.ones((b, 21), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int64),
        "valid": np.ones((b,), np.float32),
    }


def _counted():
    """Each kernel's wrapper, which carries its launch count."""
    from hgr_tpu_torch.ops import bn_act
    from hgr_tpu_torch.ops.attention import (
        fused_attention_qkv,
        fused_attention_qkv_bwd,
    )
    from hgr_tpu_torch.ops.warp_fused import warp_twopass

    return {"attention_qkv_fwd": fused_attention_qkv,
            "attention_qkv_bwd": fused_attention_qkv_bwd,
            "warp_twopass": warp_twopass,
            "bn_act_reduce": bn_act.bn_act_reduce,
            "bn_act_elem": bn_act.bn_act_elem}


def _counts():
    return {name: fn.launches for name, fn in _counted().items()}


def _zero_counts():
    for fn in _counted().values():
        fn.launches = 0


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _path_bn_layers(torch):
    """(H, W, C, act) of every ConvBnAct of MultiTaskNet small at the
    training size, in order: the shapes its train-mode forward gives the
    bn kernels (forward hooks on the convs, one B=1 forward)."""
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.models.layers import ConvBnAct

    model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=torch.bfloat16)
    model = model.eval().to("cuda")
    found = []
    hooks = [
        m.conv.register_forward_hook(
            lambda mod, args, out, act=m.use_act: found.append(
                (out.shape[1], out.shape[2], out.shape[3], act)))
        for m in model.modules() if isinstance(m, ConvBnAct)]
    with torch.no_grad():
        model(torch.zeros(1, IMAGE, IMAGE, 3, device="cuda"),
              need_attnmap=False)
    for h in hooks:
        h.remove()
    return found


def bn_kernel_phase(torch, path_layers):
    """The two bn kernels vs their plain versions at every distinct layer
    shape of the path at B=256, bf16, with the SiLU and without, and at one
    f32 shape; times of kernel, plain version and, without the SiLU (the
    only case one call computes), the library calls: for the reduce
    native_batch_norm_backward and batch_norm_backward_reduce (dgamma =
    T2, dbeta = T1), for the elementwise pass batch_norm_backward_elemt
    (SyncBatchNorm's, fed sum_dy = T1 and sum_dy_xmu = T2/r). Then the bn
    time of one train step: each layer's two kernels, times 2 pullbacks."""
    from hgr_tpu_torch.ops import bn_act as B

    shapes = sorted({(h, w, c) for h, w, c, _ in path_layers}, reverse=True)
    cases = [(shape, "bfloat16", act) for shape in shapes
             for act in (True, False)]
    f32_shape = path_layers[1][:3]  # conv2's 48x48x128
    cases += [(f32_shape, "float32", True), (f32_shape, "float32", False)]
    rows, by_case = [], {}
    for (h, w, c), dtype, act in cases:
        gen = torch.Generator(device="cuda").manual_seed(h * 1000 + c)
        dt = getattr(torch, dtype)
        m_rows = TRAIN_BATCH * h * w
        y = (torch.randn(m_rows, c, device="cuda", generator=gen) * 2
             + 0.3).to(dt)
        g = torch.randn(m_rows, c, device="cuda", generator=gen).to(dt)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = torch.randn(c, device="cuda", generator=gen) * 0.1
        _, mean, var = B.fwd_chain(y, gamma, beta, BN_EPS, act)
        r = torch.rsqrt(var + BN_EPS)
        t1, t2 = B.bn_act_reduce(y, g, mean, r, gamma, beta, act)
        p1, p2 = B.bn_act_reduce_reference(y, g, mean, r, gamma, beta, act)
        dz, xhat = B._dz_xhat(y, g, mean, r, gamma, beta, act)
        mag1, mag2 = dz.abs().sum(0), (dz * xhat).abs().sum(0)
        del dz, xhat
        t1m, t2m = p1 / m_rows, p2 / m_rows
        dy = B.bn_act_elem(y, g, mean, r, gamma, beta, t1m, t2m, act)
        ref = B.bn_act_elem_reference(y, g, mean, r, gamma, beta, t1m, t2m,
                                      act)
        torch.cuda.synchronize()
        sum_err = max(float(((t1 - p1).abs() / mag1).max()),
                      float(((t2 - p2).abs() / mag2).max()))
        diff = (dy.float() - ref.float()).abs()
        atol, rtol = BN_DY_TOL[dtype]
        excess = float((diff - atol - rtol * ref.float().abs()).max())
        base = {"shape": [TRAIN_BATCH, h, w, c], "dtype": dtype, "act": act}
        check(sum_err <= BN_SUM_TOL,
              f"bn_act_reduce vs plain at {base}: {sum_err}")
        elem_err = float(diff.max())
        check(excess <= 0, f"bn_act_elem vs plain at {base}: {elem_err}")
        del diff, dy
        es = y.element_size()
        reduce_fns = {
            "plain": lambda: B.bn_act_reduce_reference(y, g, mean, r, gamma,
                                                       beta, act),
            "kernel": lambda: B.bn_act_reduce(y, g, mean, r, gamma, beta,
                                              act)}
        elem_fns = {
            "plain": lambda: B.bn_act_elem_reference(
                y, g, mean, r, gamma, beta, t1m, t2m, act),
            "kernel": lambda: B.bn_act_elem(
                y, g, mean, r, gamma, beta, t1m, t2m, act)}
        lib, lib_err, elem_lib_err = None, {}, {}
        if not act:  # (dgamma, dbeta) = (T2, T1): the reduce's function
            def lib(mask):
                return lambda: torch.ops.aten.native_batch_norm_backward(
                    g, y, gamma, None, None, mean, r, True, BN_EPS, mask)

            reduce_fns["library"] = lib([False, True, True])
            reduce_fns["library_reduce_call"] = (
                lambda: torch.batch_norm_backward_reduce(
                    g, y, mean, r, gamma, False, True, True))
            _, l2, l1 = reduce_fns["library"]()
            _, _, k2, k1 = reduce_fns["library_reduce_call"]()
            lib_err = {
                "library_max_err_over_sum_of_abs": max(
                    float(((l1 - p1).abs() / mag1).max()),
                    float(((l2 - p2).abs() / mag2).max())),
                "library_reduce_call_max_err_over_sum_of_abs": max(
                    float(((k1 - p1).abs() / mag1).max()),
                    float(((k2 - p2).abs() / mag2).max()))}
            sum_dy_xmu = p2 / r  # Σ g·(y − mean)
            count = torch.tensor([m_rows], dtype=torch.int32, device="cuda")
            elem_fns["library"] = lambda: torch.batch_norm_backward_elemt(
                g, y, mean, r, gamma, p1, sum_dy_xmu, count)
            lib_dy = elem_fns["library"]()
            lib_diff = (lib_dy.float() - ref.float()).abs()
            lib_excess = float(
                (lib_diff - atol - rtol * ref.float().abs()).max())
            elem_lib_err["library_max_abs_err"] = float(lib_diff.max())
            check(lib_dy.dtype == y.dtype and lib_excess <= 0,
                  f"batch_norm_backward_elemt vs plain at {base}: "
                  f"{elem_lib_err}")
            del lib_dy, lib_diff
        red = {**base, **lib_err, "kernel": "bn_act_reduce",
               "max_abs_err": max(float((t1 - p1).abs().max()),
                                  float((t2 - p2).abs().max())),
               "max_err_over_sum_of_abs": sum_err, "tol": BN_SUM_TOL,
               **_alternate(torch, reduce_fns, iters=20),
               **_bound(2 * y.numel() * es + 6 * c * 4,
                        y.numel() * BN_OPS[("reduce", act)], "float32")}
        del ref
        elem = {**base, **elem_lib_err, "kernel": "bn_act_elem",
                "max_abs_err": elem_err, "atol": atol, "rtol": rtol,
                **_alternate(torch, elem_fns, iters=20),
                **_bound(3 * y.numel() * es + 6 * c * 4,
                         y.numel() * BN_OPS[("elem", act)], "float32")}
        for row in (red, elem):
            row["ms"] = row.pop("kernel_ms")
            row.setdefault("library_ms", None)
            if row.get("library_ms"):
                row["ms_over_library_ms"] = row["ms"] / row["library_ms"]
        if lib is not None:  # the whole backward, for the pair's yardstick
            elem["library_whole_backward_ms"] = cuda_time_ms(
                torch, lib([True, True, True]), iters=20, warmup=3)
        rows += [red, elem]
        by_case[((h, w, c), dtype, act)] = (red, elem)
        del y, g
        torch.cuda.empty_cache()
    emit({"kernel_checks": rows})

    pullbacks = 2  # de-mixed step: the bn backward runs in both pullbacks
    step = {"layers": len(path_layers), "pullbacks": pullbacks,
            "launches_per_kernel": len(path_layers) * pullbacks}
    for key in ("ms", "plain_ms", "bound_ms"):
        step[key] = pullbacks * sum(
            by_case[((h, w, c), "bfloat16", act)][i][key]
            for h, w, c, act in path_layers for i in (0, 1))
    emit({"bn_per_step_b256_bf16": step})
    # the kernels line: the largest act-free layers (cspelan1's cv2s at
    # 48x48x64), where a library call computes each kernel's function
    h, w, c, _ = max((x for x in path_layers if not x[3]),
                     key=lambda x: x[0] * x[1] * x[2])
    red, elem = by_case[((h, w, c), "bfloat16", False)]
    return red, elem, step


def train_phase(torch, n_bn: int):
    """The train step of the CLI defaults: bf16 MultiTaskNet small
    192x192, seeded random weights, grad_demix resolved from the defaults,
    B=256 staged uint8 canvases of side 256, in A/B turns with the fused
    BN route off and on (TRAIN_TURNS; each turn TURN_WARMUP + TURN_STEPS
    timed steps), the launches per step of each route checked against the
    counts the code gives (n_bn ConvBnAct layers)."""
    from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step, resolve_grad_demix

    tcfg = TrainConfig()
    demix = resolve_grad_demix(tcfg, ModelConfig(compute_dtype="bfloat16"))
    check(demix is True, "grad_demix 'auto' resolves on under bf16")
    model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, lr=tcfg.lr, device="cuda")
    step = make_train_step(AugmentConfig(), image_size=(IMAGE, IMAGE),
                           heatmap_size=(IMAGE // 4, IMAGE // 4),
                           sigma=tcfg.sigma,
                           class_loss_weight=tcfg.class_loss_weight,
                           grad_demix=demix)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _staged_batch(TRAIN_BATCH, seed=2).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # per step: 4 attention layers, their backward in each pullback, one
    # warp; on the fused route each ConvBnAct's two bn kernels per pullback
    pullbacks = 2 if demix else 1
    want = {route: {"attention_qkv_fwd": 4,
                    "attention_qkv_bwd": 4 * pullbacks, "warp_twopass": 1,
                    "bn_act_reduce": n_bn * pullbacks * (route == "on"),
                    "bn_act_elem": n_bn * pullbacks * (route == "on")}
            for route in ("off", "on")}
    turns, losses = [], []
    try:
        for route in TRAIN_TURNS:
            layers._FUSED_BN = route == "on"
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TURN_WARMUP):
                state, m = step(state, batch, gen)
                losses.append(m["total_loss"])
            torch.cuda.synchronize()
            c0 = _counts()
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TURN_STEPS):
                state, m = step(state, batch, gen)
                losses.append(m["total_loss"])
            end.record()
            end.synchronize()
            wall = time.perf_counter() - t0
            per_step = {k: v / TURN_STEPS
                        for k, v in _delta(_counts(), c0).items()}
            check(per_step == want[route],
                  f"fused BN {route}: launches per step {per_step} != "
                  f"{want[route]}")
            ms = start.elapsed_time(end) / TURN_STEPS
            turns.append({"fused_bn": route, "ms_per_step": ms,
                          "host_ms_per_step": wall / TURN_STEPS * 1e3,
                          "crops_per_s": TRAIN_BATCH / ms * 1e3,
                          "max_memory_allocated_gib":
                              torch.cuda.max_memory_allocated() / 2**30,
                          "launches_per_step": per_step})
    finally:
        layers._FUSED_BN = None
    counts = _counts()
    steps = len(TRAIN_TURNS) * (TURN_WARMUP + TURN_STEPS)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    after = model.state_dict()
    moved_params = sum(not torch.equal(before[k], after[k])
                       for k, _ in model.named_parameters())
    moved_stats = sum(not torch.equal(before[k], after[k])
                      for k in before if k.endswith((".mean", ".var")))
    n_params = sum(1 for _ in model.named_parameters())
    n_stats = sum(1 for k in before if k.endswith((".mean", ".var")))
    check(moved_params == n_params, f"params moved {moved_params}/{n_params}")
    check(moved_stats == n_stats, f"BN stats moved {moved_stats}/{n_stats}")
    routes = {}
    for route in ("off", "on"):
        mine = [t for t in turns if t["fused_bn"] == route]
        routes[route] = {
            "ms_per_step": float(np.mean([t["ms_per_step"] for t in mine])),
            "crops_per_s": float(np.mean([t["crops_per_s"] for t in mine])),
            "max_memory_allocated_gib": max(
                t["max_memory_allocated_gib"] for t in mine),
            "launches_per_step": mine[0]["launches_per_step"]}
    emit({"train": {
        "model": "MultiTaskNet small 192x192 (dim 256, depth 4, 8x32 "
                 "heads), seeded random weights",
        "dtype": "bfloat16", "grad_demix": demix, "batch": TRAIN_BATCH,
        "canvas": CANVAS, "params": sum(p.numel() for p in
                                        model.parameters()),
        "conv_bn_act_layers": n_bn, "steps": steps,
        "turns": turns, "routes": routes,
        "fused_over_plain_step_time":
            routes["on"]["ms_per_step"] / routes["off"]["ms_per_step"],
        "losses_first_last": [losses[0], losses[-1]],
        "final_metrics": {k: float(m[k]) for k in (
            "class_loss", "joints_loss", "cls_f1score", "pose_acc")},
        "launches": counts,
    }})
    return counts


class _fixed_draw:
    """Within the block, the train step takes ``params`` as its augment
    draw, on the batch's device (torch's random streams differ by device,
    so a card step and a CPU step would otherwise draw apart)."""

    def __init__(self, params):
        self.params = params

    def __enter__(self):
        from hgr_tpu_torch.data import pipeline
        from hgr_tpu_torch.train import steps

        self.steps, self.orig = steps, steps.draw_augment_params
        params = self.params

        def draw(generator, batch, sizes_hw, cfg):
            return pipeline.AugmentParams(**{
                k: v[:batch].to(sizes_hw.device) for k, v in params.items()})

        steps.draw_augment_params = draw

    def __exit__(self, *exc):
        self.steps.draw_augment_params = self.orig


def _grid_third_case(torch, b: int):
    """A batch and an augment draw under which every warp sample lies a
    third of a pixel off the canvas grid on both axes: images of 200 px,
    shifted by (1/3, 1/3) into the canvas, crop 0.35·200 = 70 px scaled
    to the 192 output (one canvas pixel per output pixel), rotations of
    multiples of 90°. Each output pixel is then (4a + 2b + 2c + d) / 9 of
    integers, at least 0.05 of a level from a rounding tie, so a one-ulp
    difference in the affine (the card's and the CPU's linalg.solve)
    cannot move a rounded pixel, and the two steps see the same image."""
    batch = _staged_batch(b, seed=3)
    batch["sizes_hw"][:] = 200.0
    batch["orig_to_canvas"][:] = [[1.0, 0.0, 1.0 / 3.0],
                                  [0.0, 1.0, 1.0 / 3.0]]
    batch["joints"] = np.random.RandomState(4).uniform(
        40, 160, (b, 21, 2)).astype(np.float32)
    rng = np.random.RandomState(5)
    params = {
        "scale": torch.full((b,), IMAGE / 70.0),
        "rot": torch.tensor([0.0, 90.0, 180.0, -90.0] * (b // 4)),
        "translate": torch.from_numpy(rng.randint(-3, 4, (b, 2)).astype(
            np.float32)),
        "flip": torch.tensor([0.0, 1.0] * (b // 2)),
        "jitter_gains": torch.from_numpy(rng.uniform(0.7, 1.3, (b, 3))
                                         .astype(np.float32)),
        "do_jitter": torch.tensor([1.0, 1.0, 0.0, 1.0] * (b // 4)),
    }
    return batch, params


def train_vs_cpu_phase(torch, fused: bool, n_bn: int):
    """One f32 de-mixed step at B=8 on the card (the kernels) against the
    same step on the CPU (warp_method 'kernel' runs the kernel's plain
    version there), with the fused BN route off or on; TF32 is off."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data.pipeline import AugmentParams, apply_augment_batch
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    batch, params = _grid_third_case(torch, 8)
    images = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        images[dev] = apply_augment_batch(
            t["canvas"], t["orig_to_canvas"], t["sizes_hw"], t["joints"],
            t["joints_vis"], AugmentParams(**{k: v.to(dev) for k, v in
                                              params.items()}),
            image_size=(IMAGE, IMAGE), heatmap_size=(IMAGE // 4, IMAGE // 4),
            warp_method="kernel")["image"].cpu()
    image_err = (images["cuda"] - images["cpu"]).abs().max().item()
    out, launches = {}, {}
    layers._FUSED_BN = fused
    try:
        with _fixed_draw(params):
            for dev in ("cpu", "cuda"):
                model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                                     generator=torch.Generator().manual_seed(
                                         1))
                state = create_train_state(model, device=dev)
                step = make_train_step(
                    AugmentConfig(), image_size=(IMAGE, IMAGE),
                    heatmap_size=(IMAGE // 4, IMAGE // 4), grad_demix=True,
                    debug_return_grads=True, warp_method="kernel")
                c0 = _counts()
                _, out[dev] = step(state, batch, torch.Generator(device=dev))
                torch.cuda.synchronize()
                launches = _delta(_counts(), c0)  # the card's step is last
    finally:
        layers._FUSED_BN = None
    bn = 2 * n_bn if fused else 0
    check(launches["bn_act_reduce"] == bn and launches["bn_act_elem"] == bn,
          f"card step with fused BN {fused}: bn launches {launches}")
    g_card, g_cpu = out["cuda"]["_grads"], out["cpu"]["_grads"]
    errs = {k: float((g_card[k].cpu() - w).norm()
                     / w.norm().clamp_min(1e-12)) for k, w in g_cpu.items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(out["cuda"]["total_loss"])
                   - float(out["cpu"]["total_loss"]))
    emit({"train_f32_b8_vs_cpu": {
        "fused_bn": fused, "card_launches": launches,
        "image_max_abs_err": image_err,
        "max_rel_grad_err": errs[worst], "worst_tensor": worst,
        "median_rel_grad_err": float(np.median(list(errs.values()))),
        "tol": STEP_GRAD_TOL, "loss_abs_err": loss_err,
        "loss": float(out["cpu"]["total_loss"]),
    }})
    # no pixel at another level (a level is 1/255/0.225 = 0.017)
    check(image_err < 1e-3, f"card vs CPU augment images: {image_err}")
    check(errs[worst] <= STEP_GRAD_TOL,
          f"card vs CPU f32 step grads: {worst} {errs[worst]}")
    check(loss_err <= 1e-4 * abs(float(out["cpu"]["total_loss"])),
          f"card vs CPU f32 step loss: {loss_err}")


def loop_phase(torch, n_bn: int):
    """Training from files through the CLI's ``run``: a synthetic dataset
    (LOOP_SPLITS, the writer's 224 px JPEGs, seeds 0-2), B=256, canvas
    256, bf16, HGR_TPU_FUSED_BN=on. Run 1: 2 epochs with the first 3 steps
    profiled, then the test split from the best checkpoint; run 2:
    ``--resume``, 1 epoch from the saved step; run 3: ``--resume
    --device_cache``, 2 epochs, the first 3 steps profiled. Checks the
    steps, the checkpoints, the logged metrics and every kernel's
    launches against the counts the code gives. Also times the streaming
    loader alone over the train split (no device work)."""
    import shutil

    from hgr_tpu_torch.cli import train as cli
    from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig
    from hgr_tpu_torch.data import native
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.data.pipeline import staging_window_fraction
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    for seed, (split, n) in enumerate(LOOP_SPLITS):
        write_synthetic_split(data, split, n, seed=seed)
    write_s = time.perf_counter() - t0
    cfg = DataConfig(path=data, names=dict(DEFAULT_NAMES))
    base = ["--data_config", "(a DataConfig built by chip_smoke.py)",
            "--batch_size", str(TRAIN_BATCH), "--canvas_size", str(CANVAS),
            "--image_size", str(IMAGE), str(IMAGE), "--dtype", "bfloat16",
            "--seed", "0", "--num_workers", "8", "--device", "cuda",
            "--save_dir", os.path.join(work, "out"),
            "--log_dir", os.path.join(work, "logs")]
    per_epoch = -(-LOOP_SPLITS[0][1] // TRAIN_BATCH)
    runs = [("2 epochs, 3 steps profiled, test", ["--epochs", "2",
                                                 "--profile", "3"], 2),
            ("--resume, 1 epoch", ["--epochs", "1", "--resume"], 1),
            ("--resume --device_cache, 2 epochs, 3 steps profiled",
             ["--epochs", "2", "--resume", "--device_cache", "--profile",
              "3"], 2)]
    run_rows, profiles, step, save = [], {}, 0, ""
    os.environ["HGR_TPU_FUSED_BN"] = "on"
    try:
        for name, argv, epochs in runs:
            t0 = time.perf_counter()
            state, save = cli.run(cli.parse_args(base + argv), cfg)
            seconds = time.perf_counter() - t0
            saved = torch.load(os.path.join(save, "weight", "last.pt"),
                               map_location="cpu", weights_only=True)["step"]
            check(state.step == saved == step + epochs * per_epoch,
                  f"{name}: ended at step {state.step} (saved {saved}), "
                  f"expected {step} + {epochs} x {per_epoch}")
            run_rows.append({"run": name, "seconds": seconds,
                             "start_step": step, "end_step": state.step})
            step = state.step
            if "--profile" in argv:
                with open(os.path.join(save, "profile",
                                       "profile_summary.json")) as f:
                    profiles[name] = json.load(f)
                check(profiles[name]["device_events"] > 0,
                      f"{name}: the profile saw device kernels")
    finally:
        os.environ.pop("HGR_TPU_FUSED_BN")
    counts = _counts()
    train_steps = step
    check(counts["bn_act_reduce"] == counts["bn_act_elem"]
          == 2 * n_bn * train_steps and counts["attention_qkv_bwd"]
          == 8 * train_steps, f"loop launches {counts} for {train_steps} "
                              f"train steps of {n_bn} ConvBnAct layers")
    with open(os.path.join(work, "logs", os.path.basename(save),
                           "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    epoch_lines = [x for x in lines if "epoch" in x]
    tests = [x["test/epoch_f1"] for x in lines if "test/epoch_f1" in x]
    check(len(epoch_lines) == 5 and len(tests) == 3,
          f"{len(epoch_lines)} epoch and {len(tests)} test log lines")
    epochs = []
    for i, e in enumerate(epoch_lines):
        check(np.isfinite(e["train/total_loss"])
              and np.isfinite(e["val/total_loss"]), f"epoch line {e}")
        epochs.append({
            "run": 1 + (i >= 2) + (i >= 3), "step": e["step"],
            "train_time_s": e["train_time_s"],
            "epoch_time_s": e["epoch_time_s"],
            "steps_per_s": per_epoch / e["train_time_s"],
            "loader_wait_s": e["train/loader_wait_s"],
            "loader_wait_share": e["train/loader_wait_s"]
            / e["train_time_s"],
            "train_loss": e["train/total_loss"],
            "val_loss": e["val/total_loss"], "val_f1": e["val/epoch_f1"]})
    # the streaming loader alone: one pass over the train split
    alone = BatchLoader(
        read_annotations(os.path.join(data, "annotations", "train"),
                         cfg.names), TRAIN_BATCH, canvas_size=CANVAS,
        window_frac=staging_window_fraction(cfg.augments), num_workers=8,
        drop_last=False)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in alone)
    loader_s = (time.perf_counter() - t0) / n_batches
    weight = os.path.join(save, "weight")
    emit({"loop": {
        "dataset": {split: n for split, n in LOOP_SPLITS},
        "image_px": 224, "write_seconds": write_s,
        "decode": "native libjpeg" if native.available() else "PIL",
        "batch": TRAIN_BATCH, "canvas": CANVAS, "dtype": "bfloat16",
        "fused_bn": True, "steps_per_epoch": per_epoch, "runs": run_rows,
        "epochs": epochs, "test_f1": tests,
        "loader_alone_s_per_batch": loader_s,
        "checkpoint_files": {f: os.path.getsize(os.path.join(weight, f))
                             for f in sorted(os.listdir(weight))},
        "launches": counts,
    }})
    for name, profile in profiles.items():
        emit({"loop_profile_3_steps": {"run": name, **profile}})
    return counts


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

    print(card_line(), flush=True)
    emit({"versions": {"python": sys.version.split()[0],
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda}})
    # float32 references are full float32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase()
    path_layers = _path_bn_layers(torch)
    rows = {"attention_qkv_fwd": kernel_phase(torch),
            "attention_qkv_bwd": bwd_kernel_phase(torch),
            "warp_twopass": warp_kernel_phase(torch)}
    rows["bn_act_reduce"], rows["bn_act_elem"], _ = bn_kernel_phase(
        torch, path_layers)

    # main path 1, serving: counts at 0 just before, read just after
    state = load_classifier_weights("", (IMAGE, IMAGE), seed=0)
    _zero_counts()
    forwards = model_phase(torch, state)
    forwards += serve_phase(torch, state)
    served = _counts()
    check(served["attention_qkv_fwd"] == 4 * forwards,
          f"attention launches {served} != 4 x {forwards} forwards")
    check(served["attention_qkv_fwd"] > 0,
          "the serving path launched the attention kernel")

    # main path 2, the train step, fused BN off and on
    n_bn = len(path_layers)
    _zero_counts()
    trained = train_phase(torch, n_bn)
    for name in KERNELS:
        check(trained[name] > 0, f"the train step launched {name}")
    train_vs_cpu_phase(torch, fused=False, n_bn=n_bn)
    train_vs_cpu_phase(torch, fused=True, n_bn=n_bn)

    # main path 3, training from files through the CLI
    _zero_counts()
    looped = loop_phase(torch, n_bn)
    for name in KERNELS:
        check(looped[name] > 0, f"the training loop launched {name}")

    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"hgr_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": served[name] + trained[name] + looped[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
    } for name, (source, replaces) in KERNELS.items()]})
    # the run used one card, whatever the host holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
