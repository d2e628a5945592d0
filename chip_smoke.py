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
  ``--device_cache`` epochs;
- multi-rank training through the same CLI (fused BN on): a 2x2 data x
  tensor-parallel mesh of four ranks sharing the card over gloo (the
  split-operand attention kernels on each rank's head group), then a
  {data: 2} mesh from the sharded device cache. The ranks are processes:
  each writes its launch counts beside the run and this script sums
  them. Then a 2x2 f32 step against the single-process step on the card,
  and the TP run's best checkpoint restored on one rank against the four
  ranks' eval forward;
- longer sequences and wider heads: a bf16 train step at 448 px (N =
  785, the attention backward key-chunked), an f32 step at 320 px (N =
  401) and a bf16 step of the model with 2 heads x 256, each with fused
  BN off and on, and the bf16 serving forward at 448 px (before the
  paths, the kernels' two routes are timed against each other over a
  sweep of lengths, with the same bits, and the f32 bodies' SASS is
  checked for the tensor cores' TF32 mma);
- two-stage detection: YOLOv7-tiny at 416 px with the repository's
  detector weights (tests/fixtures/yolo_smoke_weights.npz) -> crop ->
  MultiTaskNet small at 192 px, on synthetic 360x640 scenes with one
  hand each: the f32 pipeline on the card against the same pipeline on
  the CPU, the bf16 pipeline's rate at a batch of 16, POST /detect
  through the serving CLI's HTTP server (JPEG and .npy bodies from 4
  client threads), and ``hgr_tpu_torch.cli.detect`` on a directory of
  JPEG frames into an mp4v video;
- int8 serving: the backbone quantized from 256 seeded synthetic crops
  through the serving CLI's ``--quantize`` code, every int8 conv's int32
  accumulators card vs CPU vs the plain version, the int8 f32 forward
  card vs CPU, bf16 against int8 forwards at B=64 and 1024, int8
  ClassifierService under the serving load, and ``tools.quant_bench`` on
  the loop's checkpoint (the attention forward kernel; the warp kernel
  in the eval's crops);
- export: ``torch.export`` programs of the f32, bf16 and int8 forwards
  saved, loaded (the attention operator a node of each graph) and held
  against the eager forward, then ``hgr_tpu_torch.cli.export`` on the
  loop's checkpoint (pt2, its eval through the loaded program, and onnx);
- detector training: YOLOv7-tiny at 416 px (published widths), bf16,
  B = 16, Adam, 300 steps of ``tools/train_detector_smoke.py``'s step on
  seeded synthetic scenes (the loss must fall), best-box IoU on fresh
  scenes, the weights written as the JAX tool writes them and driving
  ``HandGesturePipeline``, the JAX tool's trained weights read on the
  same scenes and frames, and an f32 B = 2 step against the CPU;
- the classifier's precision and lowering knobs through
  ``make_train_step`` at B = 256: ``--dtype mixed`` (the f32 attention
  kernels at (256, 145, 768)), ``--early_dtype float32`` with fused BN
  (the f32 bn kernels in the early units), bf16 BN (no bn launches),
  remat, and the 's2d' and 'dense_grad' stride-2 lowerings; remat's
  running statistics and the lowerings' gradients against the plain
  model on the card, and the mixed and early steps against the CPU;
- the measurement tools: ``tools/serve_bench`` (2,048 requests from 64
  clients at max_batch 128, per-request crops, a crop pool on the card,
  and the int8 backbone), ``tools/video_bench`` (128 frames of 480x640
  through ``detect_to_video``, serial and overlapped, and the decode
  floor), ``tools/fwd_attribution`` at B = 1024 and
  ``tools/bwd_attribution`` at B = 256 with fused BN off and on, and
  ``tools/bn_convergence_ab`` at a tiny recipe (its two arms are runs of
  the training CLI in processes of their own, which write their launch
  counts);
- the batched de-mixed step (``grad_demix='batched'``: both pullbacks as
  one ``torch.autograd.grad(..., is_grads_batched=True)``) at the CLI
  defaults, fused BN off and on, in turns with the two-pullback step:
  step times, peak memory, the operators torch's legacy vmap loops over,
  the gradients against two pullbacks in bf16 and f32 and against the
  CPU; the 2x2 mesh checks run it too, and the 2x2 eval step's attention
  map against one rank's;
- ``--debug_images`` through the training CLI (the JAX loop's dump files
  and cadence), and ``tools/display_data`` on the card (32 sheets from
  one augmented batch);
- a model axis that does not divide the 8 heads: three ranks on the
  card over gloo on {data: 1, model: 3} (to_qkv sharded in thirds and
  gathered, the packed attention kernels over every head on each rank),
  the f32 step with two pullbacks and batched and the eval attention map
  against one process, then bf16 CLI-default steps beside one process's
  at the same batch;
- ``--device_cache --grad_accum 2`` on {data: 2} through the CLI (each
  rank's rows of every microbatch exchanged between the ranks' caches by
  one all_to_all a batch), and the first exchanged batch against the
  ranks' blocks, bit for bit;
- ``tools/hagrid_fit`` at 16,384 rows: the sharded device cache built
  shard by shard at canvas 192 (its invariants, every gathered row and
  the written boundary rows held to what was written), then the whole
  split's ballast beside the B = 1024 remat step in two microbatches.

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
    "attention_split_fwd": ("attention_qkv_fwd",
                            "hgr_tpu/ops/attention_pallas.py:294"),
    "attention_split_bwd": ("attention_qkv_bwd",
                            "hgr_tpu/ops/attention_pallas.py:302"),
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
# The f32 attention bodies run on the tensor cores by a three-way TF32
# split (three products for each of f32): their second bound counts 3x the
# operations at the 495 TFLOP/s TF32 peak.
TF32_PEAK_FLOPS, TF32_TERMS = 495e12, 3
# the route sweep: both routes of each attention kernel, timed in turns,
# their bits compared: bf16 at (64, n, 768) for each n here, and f32 at
# the --dtype mixed step's (256, 145, 768); the model's 8 heads of 32, and
# for the forward also 16 heads of 16 and 4 of 64 (the ring body's other
# widths): (kernel, batch, n, dtype, heads, head_dim)
ROUTE_FWD_LENGTHS = (145, 193, 257, 401, 481, 577, 689, 785, 961)
ROUTE_SWEEP = [(kernel, 64, n, "bfloat16", HEADS, HEAD_DIM)
               for kernel, lengths in (
                   ("fwd", ROUTE_FWD_LENGTHS),
                   ("bwd", (145, 161, 193, 257, 401, 481, 577, 688)))
               for n in lengths] + [
    (kernel, TRAIN_BATCH, 145, "float32", HEADS, HEAD_DIM)
    for kernel in ("fwd", "bwd")] + [
    ("fwd", 64, n, "bfloat16", h, d) for h, d in ((16, 16), (4, 64))
    for n in ROUTE_FWD_LENGTHS] + [
    # 2 heads of 128: the whole-sequence route to 48 keys (one register
    # chunk), and wherever one block holds the head on launch_on_route
    ("fwd", 64, n, "bfloat16", 2, 128) for n in (48, 49, 145, 193, 257,
                                                 785)]
# the padded head widths whose bf16 key-chunked forward and backward are
# the ring bodies (csrc/attention_qkv_{fwd,bwd}.cu): every width to 256
RING_WIDTHS = (16, 32, 64, 128, 256)
# the ring entry functions of each source, by their names in the source
RING_ENTRIES = {"attention_qkv_fwd": ("attention_fwd_mma_ring_kernel",),
                "attention_qkv_bwd": ("attention_bwd_mma_ring_q_kernel",
                                      "attention_bwd_mma_ring_k_kernel")}
# the SFU's exp rate an SM a clock (MUFU.EX2, 4 a sub-partition): the
# bf16 forward's exps set a floor of their own (sfu_floor_ms)
SFU_PER_SM_CLOCK = 16
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
# Rough operation counts of the warp, from the kernel source: the
# two-pass blend and positions (~45) per output pixel, and the HSV jitter
# (~60) once per canvas pixel of the footprint of a jittered image.
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
# launches a turn of each warp timing (wrapper, plain)
WARP_ITERS = 200
# the warp's shrinking case: a src->dst scale of 0.25
WARP_SHRINK = 0.25
# the loop phase: synthetic splits at the writer's 224 px
LOOP_SPLITS = (("train", 2048), ("val", 512), ("test", 512))
# the multi-rank phase: the global batch, and the f32 parity step's
MESH_BATCH, PARITY_BATCH = 128, 8
TP_MESH, DP_MESH = {"data": 2, "model": 2}, {"data": 2}
# path 18: a model axis that does not divide the 8 heads, and its bf16
# steps a rank (warm-up, timed); path 19's row check caches this many
# train samples
UNEVEN_MESH, UNEVEN_STEPS = {"data": 1, "model": 3}, (2, 6)
CACHE_CHECK_N = 512
# the rows a rank's kernels see in the mesh paths at MESH_BATCH: path 18's
# (every row: one data rank), the {data: 2} meshes' and path 19's eval
# shard, and path 19's microbatch (two data ranks, grad_accum 2)
MESH_RANK_BATCHES = (MESH_BATCH, MESH_BATCH // 2, MESH_BATCH // 4)
# the 2x2 eval step's attention map (f32, TF32 off) vs one rank's: softmax
# probabilities of logits whose f32 sums differ in order (the row-parallel
# reduces upstream)
TP_MAP_TOL = 1e-5
# the detect path: the detector's weights in the repository, the served
# frame geometry and batch, the HTTP run's frames and clients, the video's
# frames
DET_WEIGHTS = "tests/fixtures/yolo_smoke_weights.npz"
FRAME_HW, DET_BATCH = (360, 640), 16
DET_HTTP_FRAMES, DET_CLIENTS, VIDEO_FRAMES = 64, 4, 32
# card f32 detector heads (TF32 off) vs the CPU's: f32 sums through ~58
# convs in another order, heads of order 1-10
DET_HEAD_TOL = 1e-3
# a detection localizes its scene's hand at IoU > 0.5; the fixture's
# detector (trained from scratch on such scenes) localized 15 of 16 on
# the CPU, so at least 80% of the frames must
DET_HIT_IOU, DET_HIT_SHARE = 0.5, 0.8
# the int8 phase: seeded synthetic calibration crops, the crops held card
# vs CPU, the batches timed
QUANT_CALIB, QUANT_CHECK, QUANT_BATCHES = 256, 16, (64, 1024)
# int8 f32 forward, card vs CPU (TF32 off): the float model's MODEL_TOL.
# An int8 code moves only where an upstream f32 value, a few ulps apart
# between the devices, sits at a .5 boundary of its scale (a 1-ulp
# perturbation of 16 crops' inputs moved no logit bit on the CPU); one
# moved code changes one input of one conv by 1/127 of its range
INT8_MODEL_TOL = 1e-3
# int8 dense peak (H100 SXM data sheet): 1,979 TOP/s
INT8_PEAK_OPS = 1979e12
# bytes of an element of the int8 backbone's compute type (bf16)
INT8_IO_BYTES = 2
# the export CLI's batch on the loop's test split
CLI_EXPORT_BATCH = 64
# detector training: the batch, the pool of seeded scene batches cycled,
# the steps (the first 5 untimed), the fresh eval scenes, and YOLOv7-tiny's
# variables at the published widths with one class (6,014,038 parameters
# and 2 x 7,392 BatchNorm statistics)
DET_TRAIN_BATCH, DET_TRAIN_POOL, DET_TRAIN_STEPS = 16, 16, 300
DET_EVAL, DET_VARIABLES = 64, 6028822
# the detector's f32 B = 2 step card vs CPU: f32 alone moves its gradients
# by up to 3.3% per tensor (median 1.2%) from a float64 evaluation at a
# fresh init, on the CPU; the card's gradients must be as near float64 as
# the CPU's (within a factor 2 in norm over all tensors: two f32
# evaluations) and within DET_GRAD_TOL of the CPU's per tensor
DET_F64_FACTOR, DET_GRAD_TOL = 2.0, 0.1
# the precision and lowering knobs' train steps: warm-up and timed steps
KNOB_WARMUP, KNOB_STEPS = 2, 6
# a knob's B = 8 step, card vs CPU: its bf16 convolutions round apart on
# the two devices (cuDNN, oneDNN), so the step is held as the CPU tests
# hold a bf16 step against JAX: the gradients' difference within 0.1 of
# their norm over all tensors, the loss within 2e-2; the f32 decoder of
# 'mixed' (fed the bf16 backbone's features) within 1e-2 per tensor
KNOB_CPU_TOL, KNOB_LOSS_TOL, KNOB_F32_TOL = 0.1, 2e-2, 1e-2
# ConvBnAct layers of the first three GELAN units (conv1, conv2 and
# cspelan1's six), the layers --early_dtype float32 puts in f32
EARLY_BN_LAYERS = 8
# the tools' phases: serve_bench's load, video_bench's frames, the
# attribution batches (fwd at serving scale, bwd at the train step's
# batch) and timed calls, bn_convergence_ab's tiny recipe
SB_REQUESTS, SB_CLIENTS, SB_MAX_BATCH, SB_DEPTH = 2048, 64, 128, 4
VB_FRAMES, VB_HW, VB_BATCH = 128, (480, 640), 16
FWD_ATTR_BATCH, BWD_ATTR_BATCH, ATTR_ITERS = 1024, 256, 5
BN_AB_RECIPE = ["--train_n", "512", "--val_n", "256", "--test_n", "256",
                "--epochs", "2", "--batch", str(TRAIN_BATCH)]
# the batched de-mixed path: its A/B turns (batched, two pullbacks), the
# f32 gradient check's batch (train_vs_cpu_phase's, so that its f32
# attention and bn kernels run at shapes held against the CPU), and the
# JAX package's tolerances of batched against two pullbacks
# (tests/test_grad_demix.py:125-135): each gradient's difference within
# this share of its norm
BATCHED_TURNS = ("batched", "pullbacks", "pullbacks", "batched")
DEMIX_F32_B = 8
DEMIX_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# tools/display_data's default batch, which path 17 warps
DISPLAY_BATCH = 32
# path 20: tools/headtohead at a tiny recipe B (one seed, 2 epochs of 32 /
# 16 / 16 images at the recipe's batch of 32, whose attention and warp
# shapes the kernel phases check: MESH_BATCH // 4, DISPLAY_BATCH), then
# tools/h2h_stats over it and the committed finals
H2H_RECIPE = ["--seed", "42", "--epochs", "2", "--lr", "1e-3",
              "--lr_step", "30", "40", "--batch_size", "32", "--train_n",
              "32", "--val_n", "16", "--test_n", "16"]
# path 22: tools/hagrid_fit at HAGRID_N rows, its virtual mode in 8 shards
# at B = 256, its chip mode at its own B = 1024 in 2 microbatches (whose
# attention and warp shapes the kernel phases check), 3 timed steps
HAGRID_N, HAGRID_MICRO = 16384, 512
HAGRID_VIRTUAL = ["--mode", "virtual", "--n", str(HAGRID_N), "--devices",
                  "8", "--batch", "256"]
HAGRID_CHIP = ["--mode", "chip", "--n", str(HAGRID_N), "--devices", "1",
               "--iters", "3"]


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
    from hgr_tpu_torch.utils.cuda_build import _nvcc, load_kernels

    t0 = time.perf_counter()
    built = load_kernels(list(SOURCES))
    wall = time.perf_counter() - t0
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    emit({"nvcc": nvcc[-1] if nvcc else None})
    # dynamic shared memory per block, which ptxas does not see, and the
    # route (0 whole sequence, 1 key-chunked, 2 head widths above 256), by
    # body: float32 and bfloat16 (both on the tensor cores); at N=145 and
    # at 448 px's N=785, at the model's head width, at 256 and at 512
    smem = {name: {f"{dtype}_n{n}_d{d}": {
        "route": getattr(built[name].lib, f"{name}_route")(n, code, d),
        "bytes": getattr(built[name].lib, f"{name}_smem_bytes")(n, code, d)}
        for dtype, code in (("float32", 0), ("bfloat16", 1))
        for n in (145, 785) for d in (16, HEAD_DIM, 64, 256, 512)}
        for name in ("attention_qkv_fwd", "attention_qkv_bwd")}
    mma = _tensor_core_entries(built)
    # the ring bodies, forward and backward, at each padded head width
    # they serve: their registers, fitted per width by ptxas, and no spill
    ring = {f"{entry}<{dp}>": [line for line in _ptxas_lines(
        built[name].ptxas_log)
        if f"{entry}ILi{dp}E" in line.split(":")[0]]
        for name, entries in RING_ENTRIES.items() for entry in entries
        for dp in RING_WIDTHS}
    check(all(len(lines) == 1 and "0 bytes spill stores, 0 bytes spill "
              "loads" in lines[0] for lines in ring.values()),
          f"the ring bodies: missing or spilling {ring}")
    emit({"ring_ptxas": {k: lines[0] if len(lines) == 1 else lines
                         for k, lines in ring.items()}})
    for name in SOURCES:
        b = built[name]
        emit({"build": {
            "kernel": name,
            "source": f"hgr_tpu_torch/csrc/{name}.cu",
            "nvcc_seconds": b.build_seconds,
            "all_builds_wall_seconds": wall,
            # per entry function: its registers, shared memory, spills
            "ptxas": _ptxas_lines(b.ptxas_log),
            "dynamic_smem_per_block": smem.get(name, {}),
            "mma_per_entry": mma.get(name, {}),
        }})


def _ptxas_lines(log: str) -> list:
    """Each entry function of an nvcc -Xptxas -v log with its registers
    and spills."""
    return [f"{entry}: {used}; {spills}" for entry, spills, used in
            re.findall(r"Compiling entry function '(\w+)'.*?"
                       r"(\d+ bytes spill stores, \d+ bytes spill loads)"
                       r".*?(Used \d+ registers[^\n]*)", log, flags=re.S)]


def _tensor_core_entries(built) -> dict:
    """Per attention source, the tensor-core instructions in the SASS
    (cuobjdump) of each f32 entry function (``*_tf32_*`` and the f32
    bodies of head widths above 256, HMMA.1688.F32.TF32) and each bf16
    body of head widths above 256 (HMMA.16816.F32.BF16), with the FFMA
    count beside those of the wide bodies: every f32 body and every wide
    body runs its products on the tensor cores. Fails if one has none."""
    from hgr_tpu_torch.utils.cuda_build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    found = {}
    for name in ("attention_qkv_fwd", "attention_qkv_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(built[name].path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        entry, counts = None, {}
        for line in sass.splitlines():
            head = re.search(r"Function : (\w+)", line)
            if head:
                fn = head.group(1)
                wide = "attn_wide" in fn
                f32 = "tf32" in fn or (wide and "IfE" in fn)
                entry = fn if f32 or wide else None
                if entry:
                    counts[entry] = {"hmma": 0, "ffma": 0,
                                     "kind": "HMMA.1688.F32.TF32" if f32
                                     else "HMMA.16816.F32.BF16"}
            elif entry:
                if counts[entry]["kind"] in line:
                    counts[entry]["hmma"] += 1
                elif "FFMA" in line:
                    counts[entry]["ffma"] += 1
        check(counts and all(c["hmma"] for c in counts.values()),
              f"{name}: entries without tensor-core mma: {counts}")
        check(any("attn_wide" in e for e in counts),
              f"{name}: no body of head widths above 256 in the SASS")
        found[name] = counts
    return found


def kernel_phase(torch):
    """Kernel vs plain version at the serving and detect shapes; times at
    B=64 (the serving shape) and B=256 (the training shape)."""
    from hgr_tpu_torch.ops.attention import (
        attention_qkv_reference,
        fused_attention_qkv,
        split_heads,
    )

    checks, main = [], None
    # (16, bf16) and (4, f32): the detect path's classifier batches;
    # (1024, bf16): the int8 path's timed batch; (16, f32): its card vs
    # CPU forward; (1, bf16 and f32): the exported programs at batch 1;
    # (128, bf16): serve_bench's largest batch and path 18's rank batch;
    # (32, bf16): path 19's microbatch and path 20's recipe batch; (8,
    # f32): the mesh parity steps; (512, bf16): path 22's microbatch
    for b, n, dtype in [(64, 145, "bfloat16"), (64, 145, "float32"),
                        (256, 145, "bfloat16"), (DET_BATCH, 145, "bfloat16"),
                        (4, 145, "float32"), (1, 37, "bfloat16"),
                        (1, 37, "float32"), (1024, 145, "bfloat16"),
                        (1, 145, "bfloat16"), (1, 145, "float32"),
                        (QUANT_CHECK, 145, "float32"),
                        (TRAIN_BATCH, 145, "float32"),
                        (SB_MAX_BATCH, 145, "bfloat16"),
                        (MESH_BATCH // 4, 145, "bfloat16"),
                        (PARITY_BATCH, 145, "float32"),
                        (HAGRID_MICRO, 145, "bfloat16")]:
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
            library = _sdpa(torch, q, k, v)
            row.update(_alternate(torch, {
                "plain": lambda: attention_qkv_reference(qkv, HEADS, HEAD_DIM,
                                                         SCALE),
                "kernel": lambda: fused_attention_qkv(qkv, HEADS, HEAD_DIM,
                                                      SCALE),
                **library}))
            row["ms"] = row.pop("kernel_ms")
            _pick_library(row)
            lib_out = library[f"library_{row['library_backend']}"]()
            row["library_max_abs_err"] = (
                lib_out.transpose(1, 2).reshape(out.shape).float()
                - out.float()).abs().max().item()
            row.update(_bound((qkv.numel() + out.numel())
                              * qkv.element_size(),
                              4 * b * HEADS * n * n * HEAD_DIM, dtype))
            if (b, dtype) == (64, "bfloat16"):  # the serving shape
                main = row
        checks.append(row)
    emit({"kernel_checks": checks})
    return main


def _bound(nbytes: float, flops: float, dtype: str):
    """The least time of the function on the card: bytes over the memory
    rate against operations over the dtype's peak (f32: the CUDA cores').
    f32 rows also carry the bound of a tensor-core design that keeps f32
    accuracy (``tc_bound_ms``: three TF32 products per f32 one)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row = {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if dtype == "float32":
        t_tc = TF32_TERMS * flops / TF32_PEAK_FLOPS * 1e3
        row.update(tc_bound_ms=max(t_bytes, t_tc),
                   tc_bound_by="bytes" if t_bytes >= t_tc else "operations")
    return row


def _sfu_floor_ms(torch, b: int, h: int, n: int, route: int) -> float:
    """The least time of the bf16 forward's exps on this card: one exp2 a
    score on the whole-sequence route (one register chunk of keys holds
    the sequence), two on the key-chunked route (the max and sum sweep,
    then the P sweep, each exponentiating every score: P is rounded after
    it is normalised), at SFU_PER_SM_CLOCK an SM a clock at the card's
    highest SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exps = (1 if route == 0 else 2) * b * h * n * n
    return exps / (sms * SFU_PER_SM_CLOCK * mhz * 1e6) * 1e3


def _alternate(torch, fns, iters: int = 50) -> dict:
    """Mean CUDA-event time of each named fn, taken in the order given and
    then in reverse (plain, kernel, library, library, kernel, plain)."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(cuda_time_ms(torch, fns[name], iters=iters,
                                    warmup=min(5, iters)))
    return {"runs_ms": t, **{f"{n}_ms": float(np.mean(v))
                            for n, v in t.items()}}


def _sdpa(torch, q, k, v, g=None, scale=SCALE) -> dict:
    """scaled_dot_product_attention on heads-first q, k, v (its backward
    for the cotangent ``g``, when given), the yardstick of the attention
    kernels, under each of its flash, memory-efficient and cuDNN backends
    that takes these inputs: ``library_<backend>`` -> a call. The backend
    SDPA picks on its own (cuDNN where it takes the inputs) read 0.30 or
    0.63-0.69 ms for the same backward in different runs, so each is
    timed under its own name; library_ms is the lower of flash and
    memory-efficient (``_pick_library``), cuDNN's is kept beside it.
    Where neither flash nor memory-efficient takes the inputs (head
    widths above 256), the unfused math backend is the yardstick."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(backend):
        ins = (q, k, v) if g is None else tuple(
            t.detach().requires_grad_() for t in (q, k, v))
        try:
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(*ins, scale=scale)
        except RuntimeError:  # this backend does not take these inputs
            return None
        if g is None:
            def fn():
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(q, k, v,
                                                          scale=scale)
            return fn
        return lambda: torch.autograd.grad(o, ins, g, retain_graph=True)

    fns = {f"library_{name}": fn for name, fn in (
        (name, call(backend)) for name, backend in (
            ("flash", SDPBackend.FLASH_ATTENTION),
            ("efficient", SDPBackend.EFFICIENT_ATTENTION),
            ("cudnn", SDPBackend.CUDNN_ATTENTION))) if fn is not None}
    if "library_flash" not in fns and "library_efficient" not in fns:
        fns["library_math"] = call(SDPBackend.MATH)
        check(fns["library_math"] is not None,
              "SDPA ran under none of its backends")
    return fns


def _pick_library(row: dict) -> None:
    """library_ms: the lower of the flash and memory-efficient SDPA times
    in ``row`` (the math backend's where neither took the inputs)."""
    times = {name: row[f"library_{name}_ms"] for name in ("flash",
                                                          "efficient")
             if f"library_{name}_ms" in row}
    if not times:
        times = {"math": row["library_math_ms"]}
    row["library_backend"] = min(times, key=times.get)
    row["library_ms"] = times[row["library_backend"]]


def _vs_float64(torch, out, ref, qkv, g) -> dict:
    """How far the bf16 gradients of the kernel and of the plain version
    each sit from the float64 gradient of the same bf16 inputs: the
    elements that are not the float64 value rounded to bf16, and the
    worst distances. Two f32 computations disagree by an ulp where the
    exact value sits next to a rounding boundary; this says whether the
    kernel does so more often than the plain version."""
    from hgr_tpu_torch.ops.attention import attention_qkv_bwd_reference

    exact = attention_qkv_bwd_reference(qkv.double(), g.double(), HEADS,
                                        HEAD_DIM, SCALE)
    rounded = exact.to(torch.bfloat16)
    return {"elements": out.numel(),
            **{f"{name}_not_rounded_exact": int((t != rounded).sum())
               for name, t in (("kernel", out), ("plain", ref))},
            **{f"{name}_max_abs_err": (t.double() - exact).abs().max().item()
               for name, t in (("kernel", out), ("plain", ref))},
            "kernel_vs_plain_elements": int((out != ref).sum())}


def bwd_kernel_phase(torch):
    """Backward kernel vs plain version at the training shape (B=256) and
    smaller ones; times at B=256 and B=64 against the backward of
    scaled_dot_product_attention on split heads."""
    from hgr_tpu_torch.ops.attention import (
        attention_qkv_bwd_reference,
        fused_attention_qkv_bwd,
        split_heads,
    )

    checks, main = [], None
    # (128 and 32, bf16): the rank batches of paths 18 and 19 (32: also
    # path 20's recipe batch); (8, f32): the mesh parity steps; (512,
    # bf16): path 22's microbatch
    for b, n, dtype in [(TRAIN_BATCH, 145, "bfloat16"), (64, 145, "bfloat16"),
                        (64, 145, "float32"), (1, 37, "bfloat16"),
                        (1, 37, "float32"), (TRAIN_BATCH, 145, "float32"),
                        (MESH_BATCH, 145, "bfloat16"),
                        (MESH_BATCH // 4, 145, "bfloat16"),
                        (PARITY_BATCH, 145, "float32"),
                        (HAGRID_MICRO, 145, "bfloat16")]:
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
        if dtype == "bfloat16":
            row["vs_float64"] = _vs_float64(torch, out, ref, qkv, g)
        if b >= 64:
            g_h = g.reshape(b, n, HEADS, HEAD_DIM).permute(0, 2, 1, 3)
            row.update(_alternate(torch, {
                "plain": lambda: attention_qkv_bwd_reference(
                    qkv, g, HEADS, HEAD_DIM, SCALE),
                "kernel": lambda: fused_attention_qkv_bwd(
                    qkv, g, HEADS, HEAD_DIM, SCALE),
                **_sdpa(torch, *split_heads(qkv, HEADS, HEAD_DIM), g_h),
            }))
            row["ms"] = row.pop("kernel_ms")
            _pick_library(row)
            row.update(_bound((2 * qkv.numel() + g.numel())
                              * qkv.element_size(),
                              10 * n * n * HEAD_DIM * HEADS * b, dtype))
            if (b, dtype) == (TRAIN_BATCH, "bfloat16"):  # the training path
                main = row
        checks.append(row)
    emit({"kernel_checks": checks})
    return main


def split_kernel_phase(torch):
    """The split-operand kernels vs their plain versions and vs the packed
    kernels on the same data (one kernel body: 0.0 difference), fed the
    chunk views of one packed tensor and three contiguous tensors, at the
    full width (B=256, 8 heads) and a tensor-parallel rank's head group
    (B=128, 4 heads), bf16 and f32; times against SDPA on split heads."""
    from hgr_tpu_torch.ops import attention as A

    rows, main = [], {}
    for b, h, dtype in [(TRAIN_BATCH, HEADS, "bfloat16"),
                        (TRAIN_BATCH, HEADS, "float32"),
                        (128, HEADS // 2, "bfloat16"),
                        (128, HEADS // 2, "float32")]:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(b * 10 + h)
        hd = h * HEAD_DIM
        qkv = torch.randn(b, 145, 3 * hd, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, 145, hd, device="cuda", generator=gen).to(dt)
        packed = A.fused_attention_qkv(qkv, h, HEAD_DIM, SCALE)
        packed_d = A.fused_attention_qkv_bwd(qkv, g, h, HEAD_DIM,
                                             SCALE).chunk(3, dim=-1)
        for layout in ("views", "contiguous"):
            ops = qkv.chunk(3, dim=-1)
            if layout == "contiguous":
                ops = tuple(t.contiguous() for t in ops)
            out = A.fused_attention_split(*ops, h, HEAD_DIM, SCALE)
            ref = A.attention_split_reference(*ops, h, HEAD_DIM, SCALE)
            d = A.fused_attention_split_bwd(*ops, g, h, HEAD_DIM, SCALE)
            d_ref = A.attention_split_bwd_reference(*ops, g, h, HEAD_DIM,
                                                    SCALE)
            torch.cuda.synchronize()
            fwd_err = (out.float() - ref.float()).abs().max().item()
            atol, rtol = GRAD_TOL[dtype]
            bwd_err = max((x.float() - y.float()).abs().max().item()
                          for x, y in zip(d, d_ref))
            bwd_excess = max((
                (x.float() - y.float()).abs() - atol - rtol
                * y.float().abs()).max().item() for x, y in zip(d, d_ref))
            vs_packed = (out.float() - packed.float()).abs().max().item()
            bwd_vs_packed = max((x.float() - y.float()).abs().max().item()
                                for x, y in zip(d, packed_d))
            base = {"shape": [b, 145, hd], "heads": h, "dtype": dtype,
                    "layout": layout}
            check(fwd_err <= KERNEL_TOL[dtype],
                  f"split fwd vs plain {base}: {fwd_err}")
            check(bwd_excess <= 0, f"split bwd vs plain {base}: {bwd_err}")
            check(vs_packed == 0.0 and bwd_vs_packed == 0.0,
                  f"split vs packed kernel {base}: {vs_packed}, "
                  f"{bwd_vs_packed}")
            fwd = {**base, "kernel": "attention_split_fwd",
                   "max_abs_err": fwd_err, "tol": KERNEL_TOL[dtype],
                   "max_abs_diff_vs_packed_kernel": vs_packed}
            bwd = {**base, "kernel": "attention_split_bwd",
                   "max_abs_err": bwd_err, "atol": atol, "rtol": rtol,
                   "max_abs_diff_vs_packed_kernel": bwd_vs_packed}
            if layout == "views":
                qh, kh, vh = (t.reshape(b, 145, h, HEAD_DIM).transpose(1, 2)
                              for t in ops)
                g_h = g.reshape(b, 145, h, HEAD_DIM).transpose(1, 2)
                fwd.update(_alternate(torch, {
                    "plain": lambda: A.attention_split_reference(
                        *ops, h, HEAD_DIM, SCALE),
                    "kernel": lambda: A.fused_attention_split(
                        *ops, h, HEAD_DIM, SCALE),
                    **_sdpa(torch, qh, kh, vh)}))
                bwd.update(_alternate(torch, {
                    "plain": lambda: A.attention_split_bwd_reference(
                        *ops, g, h, HEAD_DIM, SCALE),
                    "kernel": lambda: A.fused_attention_split_bwd(
                        *ops, g, h, HEAD_DIM, SCALE),
                    **_sdpa(torch, qh, kh, vh, g_h)}, iters=20))
                es = qkv.element_size()
                fwd.update(_bound(4 * b * 145 * hd * es,
                                  4 * b * h * 145 * 145 * HEAD_DIM, dtype))
                bwd.update(_bound(7 * b * 145 * hd * es,
                                  10 * b * h * 145 * 145 * HEAD_DIM, dtype))
                for row in (fwd, bwd):
                    row["ms"] = row.pop("kernel_ms")
                    _pick_library(row)
                if (b, dtype) == (TRAIN_BATCH, "bfloat16"):
                    main = {"attention_split_fwd": fwd,
                            "attention_split_bwd": bwd}
            rows += [fwd, bwd]
    emit({"kernel_checks": rows})
    return main


# C2: the attention kernels at the sizes the 448 px and 320 px paths give
# them, past each body's whole-sequence route, and at the other padded head
# widths (kernel level only; the model's width is 32):
# (batch, n, heads, head_dim, dtype)
C2_SHAPES = [
    (64, 785, 8, 32, "bfloat16"),   # 448 px: serving forward, train step
    (16, 401, 8, 32, "float32"),    # 320 px, the f32 train step
    (64, 1025, 8, 32, "bfloat16"),  # past the bf16 forward's whole route
    (64, 145, 16, 16, "bfloat16"), (64, 145, 4, 48, "bfloat16"),
    (64, 145, 4, 64, "bfloat16"), (64, 145, 2, 128, "bfloat16"),
    (16, 785, 16, 16, "bfloat16"), (16, 785, 4, 48, "bfloat16"),
    (16, 785, 4, 64, "bfloat16"), (16, 785, 2, 128, "bfloat16"),
    # the 448 px shape at widths 16 and 64 (the ring pair's other widths)
    (64, 785, 16, 16, "bfloat16"), (64, 785, 4, 64, "bfloat16"),
    (16, 401, 16, 16, "float32"), (16, 401, 4, 48, "float32"),
    (16, 401, 4, 64, "float32"), (16, 401, 2, 128, "float32"),
    # the widths that pad to 256 (every length key-chunked there)
    (64, 145, 2, 192, "bfloat16"), (64, 145, 2, 256, "bfloat16"),
    (16, 785, 2, 192, "bfloat16"), (16, 785, 2, 256, "bfloat16"),
]
# C2 to head width 256: each kernel against its plain version, packed and
# split, at (2, n, 2 heads x head_dim) for every (n, head_dim, dtype) here
C2_WIDE_CHECKS = [(n, d, dtype) for n in (145, 785) for d in (160, 192, 256)
                  for dtype in ("bfloat16", "float32")]
# C2 above head width 256 (csrc/attention_wide.cuh, route 2): each kernel,
# packed and split, forward and backward, against its plain version and
# timed beside SDPA, at (B, n, 2 heads x head_dim): the earlier (4, n)
# shapes, the full-card shapes (64, 145) and (16, 785) at 512, and widths
# 257 (not a multiple of 64) and 384 at (4, 145)
C2_WIDER_SHAPES = [(4, n, 2, d, dtype) for n in (145, 785) for d in (320, 512)
                   for dtype in ("bfloat16", "float32")] + [
    (b, n, 2, 512, dtype) for b, n in ((64, 145), (16, 785))
    for dtype in ("bfloat16", "float32")] + [
    (4, 145, 2, d, dtype) for d in (257, 384)
    for dtype in ("bfloat16", "float32")]
# the long paths' model with 256-wide heads (2 x 256 at dim 256), a bf16
# step at 192 px, fused BN off and on; and with 384-wide heads (2 x 384:
# the bodies of head widths above 256), fused BN off
WIDE_HEADS = {"heads": 2, "head_dim": 256}
WIDER_HEADS = {"heads": 2, "head_dim": 384}
# the long paths: 448 px bf16 (N = 785) and 320 px f32 (N = 401) training,
# their staged canvases 64 px wider than the crop
LONG_BF16, LONG_F32 = 448, 320
LONG_BF16_BATCH, LONG_F32_BATCH = 64, 16


def c2_kernel_phase(torch) -> list:
    """The packed kernels against their plain versions at C2_SHAPES, the
    split kernels on the chunk views equal to them bit for bit, each
    kernel's route, and times of kernel, plain version and SDPA under each
    backend in the row's dtype, with the bound."""
    from hgr_tpu_torch.ops import attention as A

    rows = []
    for b, n, h, d, dtype in C2_SHAPES:
        dt = getattr(torch, dtype)
        scale, hd = d**-0.5, h * d
        gen = torch.Generator(device="cuda").manual_seed(n * 131 + d)
        qkv = torch.randn(b, n, 3 * hd, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, n, hd, device="cuda", generator=gen).to(dt)
        out = A.fused_attention_qkv(qkv, h, d, scale)
        ref = A.attention_qkv_reference(qkv, h, d, scale)
        dx = A.fused_attention_qkv_bwd(qkv, g, h, d, scale)
        dref = A.attention_qkv_bwd_reference(qkv, g, h, d, scale)
        ops = qkv.chunk(3, dim=-1)
        s_out = A.fused_attention_split(*ops, h, d, scale)
        s_d = A.fused_attention_split_bwd(*ops, g, h, d, scale)
        torch.cuda.synchronize()
        fwd_err = (out.float() - ref.float()).abs().max().item()
        atol, rtol = GRAD_TOL[dtype]
        diff = (dx.float() - dref.float()).abs()
        bwd_excess = (diff - atol - rtol * dref.float().abs()).max().item()
        split_same = bool(torch.equal(s_out, out) and all(
            torch.equal(x, y) for x, y in zip(s_d, dx.chunk(3, dim=-1))))
        base = {"shape": [b, n, 3 * hd], "heads": h, "head_dim": d,
                "dtype": dtype, "split_equals_packed": split_same}
        check(fwd_err <= KERNEL_TOL[dtype],
              f"C2 fwd kernel vs plain {base}: {fwd_err}")
        check(bwd_excess <= 0, f"C2 bwd kernel vs plain {base}: "
                               f"{diff.max().item()}")
        check(split_same, f"C2 split kernels vs packed {base}")
        qh, kh, vh = A.split_heads(qkv, h, d)
        g_h = g.reshape(b, n, h, d).transpose(1, 2)
        es = qkv.element_size()
        fwd = {**base, "kernel": "attention_qkv_fwd",
               "route": A.kernel_route("fwd", n, d, dt),
               "body": A.forward_body(n, d, dt),
               "max_abs_err": fwd_err, "tol": KERNEL_TOL[dtype],
               **_alternate(torch, {
                   "plain": lambda: A.attention_qkv_reference(qkv, h, d,
                                                              scale),
                   "kernel": lambda: A.fused_attention_qkv(qkv, h, d, scale),
                   **_sdpa(torch, qh, kh, vh, scale=scale)}, iters=20),
               **_bound((qkv.numel() + out.numel()) * es,
                        4 * b * h * n * n * d, dtype)}
        bwd = {**base, "kernel": "attention_qkv_bwd",
               "route": A.kernel_route("bwd", n, d, dt),
               "body": A.backward_body(n, d, dt),
               "max_abs_err": diff.max().item(), "atol": atol, "rtol": rtol,
               **_alternate(torch, {
                   "plain": lambda: A.attention_qkv_bwd_reference(
                       qkv, g, h, d, scale),
                   "kernel": lambda: A.fused_attention_qkv_bwd(qkv, g, h, d,
                                                               scale),
                   **_sdpa(torch, qh, kh, vh, g_h, scale=scale)}, iters=10),
               **_bound((2 * qkv.numel() + g.numel()) * es,
                        10 * b * h * n * n * d, dtype)}
        if dtype == "bfloat16" and fwd["route"] != 2:
            fwd["sfu_floor_ms"] = _sfu_floor_ms(torch, b, h, n,
                                                fwd["route"])
        for row in (fwd, bwd):
            row["ms"] = row.pop("kernel_ms")
            _pick_library(row)
        rows += [fwd, bwd]
        del qkv, g, out, ref, dx, dref, diff, s_out, s_d
        torch.cuda.empty_cache()
    emit({"kernel_checks_c2": rows})
    wide = []
    for n, d, dtype in C2_WIDE_CHECKS:
        dt = getattr(torch, dtype)
        scale, hd = d**-0.5, 2 * d
        gen = torch.Generator(device="cuda").manual_seed(n * 17 + d)
        qkv = torch.randn(2, n, 3 * hd, device="cuda", generator=gen).to(dt)
        g = torch.randn(2, n, hd, device="cuda", generator=gen).to(dt)
        out = A.fused_attention_qkv(qkv, 2, d, scale)
        dx = A.fused_attention_qkv_bwd(qkv, g, 2, d, scale)
        ops = qkv.chunk(3, dim=-1)
        s_out = A.fused_attention_split(*ops, 2, d, scale)
        s_d = A.fused_attention_split_bwd(*ops, g, 2, d, scale)
        ref = A.attention_qkv_reference(qkv, 2, d, scale)
        dref = A.attention_qkv_bwd_reference(qkv, g, 2, d, scale)
        torch.cuda.synchronize()
        atol, rtol = GRAD_TOL[dtype]
        diff = (dx.float() - dref.float()).abs()
        row = {"n": n, "head_dim": d, "dtype": dtype,
               "fwd_err": (out.float() - ref.float()).abs().max().item(),
               "bwd_err": diff.max().item(),
               "bwd_excess": (diff - atol - rtol * dref.float().abs())
               .max().item(),
               "split_equals_packed": bool(torch.equal(s_out, out) and all(
                   torch.equal(x, y) for x, y in zip(s_d,
                                                     dx.chunk(3, dim=-1))))}
        check(row["fwd_err"] <= KERNEL_TOL[dtype] and row["bwd_excess"] <= 0
              and row["split_equals_packed"],
              f"C2 wide-head kernels vs plain: {row}")
        wide.append(row)
    emit({"kernel_checks_c2_wide": wide})
    return rows


def c2_wider_phase(torch) -> list:
    """Head widths above 256: the packed and split kernels, forward and
    backward, against their plain versions at C2_WIDER_SHAPES (f32 ~1e-5
    forward and 1e-4 gradients, bf16 2e-2), the split ones equal to the
    packed ones bit for bit, each timed beside SDPA with its bound."""
    from hgr_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    rows = []
    for b, n, h, d, dtype in C2_WIDER_SHAPES:
        dt = getattr(torch, dtype)
        scale, hd = d**-0.5, h * d
        gen = torch.Generator(device="cuda").manual_seed(n * 7 + d)
        qkv = torch.randn(b, n, 3 * hd, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, n, hd, device="cuda", generator=gen).to(dt)
        ops = qkv.chunk(3, dim=-1)
        out = A.fused_attention_qkv(qkv, h, d, scale)
        dx = A.fused_attention_qkv_bwd(qkv, g, h, d, scale)
        s_out = A.fused_attention_split(*ops, h, d, scale)
        s_d = A.fused_attention_split_bwd(*ops, g, h, d, scale)
        ref = A.attention_qkv_reference(qkv, h, d, scale)
        dref = A.attention_qkv_bwd_reference(qkv, g, h, d, scale)
        torch.cuda.synchronize()
        fwd_err = (out.float() - ref.float()).abs().max().item()
        atol, rtol = GRAD_TOL[dtype]
        diff = (dx.float() - dref.float()).abs()
        bwd_excess = (diff - atol - rtol * dref.float().abs()).max().item()
        split_same = bool(torch.equal(s_out, out) and all(
            torch.equal(x, y) for x, y in zip(s_d, dx.chunk(3, dim=-1))))
        base = {"shape": [b, n, 3 * hd], "heads": h, "head_dim": d,
                "dtype": dtype, "split_equals_packed": split_same,
                "route_fwd": A.kernel_route("fwd", n, d, dt),
                "route_bwd": A.kernel_route("bwd", n, d, dt)}
        check(fwd_err <= KERNEL_TOL[dtype],
              f"C2 wider fwd kernel vs plain {base}: {fwd_err}")
        check(bwd_excess <= 0, f"C2 wider bwd kernel vs plain {base}: "
                               f"{diff.max().item()}")
        check(split_same and base["route_fwd"] == base["route_bwd"] == 2,
              f"C2 wider split kernels vs packed, routes {base}")
        qh, kh, vh = A.split_heads(qkv, h, d)
        g_h = g.reshape(b, n, h, d).transpose(1, 2)
        es = qkv.element_size()
        fwd_bound = _bound((qkv.numel() + out.numel()) * es,
                           4 * b * h * n * n * d, dtype)
        bwd_bound = _bound((2 * qkv.numel() + g.numel()) * es,
                           10 * b * h * n * n * d, dtype)
        library_fwd = _sdpa(torch, qh, kh, vh, scale=scale)
        library_bwd = _sdpa(torch, qh, kh, vh, g_h, scale=scale)
        for kernel, fn, plain, library, bound, err in (
                ("attention_qkv_fwd",
                 lambda: A.fused_attention_qkv(qkv, h, d, scale),
                 lambda: A.attention_qkv_reference(qkv, h, d, scale),
                 library_fwd, fwd_bound, fwd_err),
                ("attention_split_fwd",
                 lambda: A.fused_attention_split(*ops, h, d, scale),
                 lambda: A.attention_split_reference(*ops, h, d, scale),
                 library_fwd, fwd_bound, fwd_err),
                ("attention_qkv_bwd",
                 lambda: A.fused_attention_qkv_bwd(qkv, g, h, d, scale),
                 lambda: A.attention_qkv_bwd_reference(qkv, g, h, d, scale),
                 library_bwd, bwd_bound, diff.max().item()),
                ("attention_split_bwd",
                 lambda: A.fused_attention_split_bwd(*ops, g, h, d, scale),
                 lambda: A.attention_split_bwd_reference(*ops, g, h, d,
                                                         scale),
                 library_bwd, bwd_bound, diff.max().item())):
            row = {**base, "kernel": kernel, "max_abs_err": err,
                   **_alternate(torch, {"plain": plain, "kernel": fn,
                                        **library}, iters=5),
                   **bound}
            row["ms"] = row.pop("kernel_ms")
            _pick_library(row)
            rows.append(row)
        del qkv, g, out, ref, dx, dref, diff, s_out, s_d, ops
        torch.cuda.empty_cache()
    emit({"kernel_checks_c2_wider": rows, "wide_ptxas": _wide_ptxas(),
          "seconds": time.perf_counter() - t0})
    return rows


def _wide_ptxas() -> list:
    """ptxas's registers and spills of each body of head widths above 256
    (the attention sources' entries in namespace attn_wide)."""
    from hgr_tpu_torch.utils.cuda_build import load_kernels

    built = load_kernels(["attention_qkv_fwd", "attention_qkv_bwd"])
    return [line for b in built.values() for line in _ptxas_lines(b.ptxas_log)
            if "attn_wide" in line.split(":")[0]]


def route_phase(torch) -> list:
    """The route sweep: for each (kernel, batch, n, dtype, heads,
    head_dim) of ROUTE_SWEEP, the kernel on the whole-sequence route
    (where one block holds the head) and on the key-chunked route
    (``launch_on_route``), timed in turns, with the route the rule takes
    (``kernel_route``) and, for the forward, the body it runs there. The
    two routes must give the same bits, and the entry point those of its
    route."""
    from hgr_tpu_torch.ops import attention as A

    rows = []
    for kernel, b, n, dtype, h, d in ROUTE_SWEEP:
        dt = getattr(torch, dtype)
        scale = d**-0.5
        gen = torch.Generator(device="cuda").manual_seed(n * 3 + 1)
        qkv = torch.randn(b, n, 3 * h * d, device="cuda",
                          generator=gen).to(dt)
        g = torch.randn(b, n, h * d, device="cuda", generator=gen).to(dt)
        cot = g if kernel == "bwd" else None
        outs, fns = {}, {}
        for r in (0, 1):
            try:
                outs[r] = A.launch_on_route(kernel, r, qkv, h, d, scale, cot)
            except ValueError:  # no whole-sequence route at this n
                continue
            fns[f"route{r}"] = (lambda r=r: A.launch_on_route(
                kernel, r, qkv, h, d, scale, cot))
        rule = A.kernel_route(kernel, n, d, dt)
        entry = (A.fused_attention_qkv(qkv, h, d, scale)
                 if kernel == "fwd" else
                 A.fused_attention_qkv_bwd(qkv, g, h, d, scale))
        row = {"kernel": f"attention_qkv_{kernel}", "dtype": dtype,
               "shape": [b, n, 3 * h * d], "heads": h, "head_dim": d,
               "rule_route": rule,
               **({"body": A.forward_body(n, d, dt)} if kernel == "fwd"
                  else {}),
               "entry_is_its_route": bool(torch.equal(entry, outs[rule])),
               "same_bits": (bool(torch.equal(outs[0], outs[1]))
                             if 0 in outs else None)}
        timed = _alternate(torch, fns, iters=10)
        row.update({k: v for k, v in timed.items() if k != "runs_ms"})
        check(row["entry_is_its_route"] and row["same_bits"] is not False,
              f"routes at {row['shape']} {dtype}: {row}")
        rows.append(row)
        del qkv, g, outs, entry
    emit({"routes": rows})
    return rows


def long_path_phase(torch, n_bn: int) -> dict:
    """C2's paths through the entry points a user calls, MultiTaskNet
    small at full width with seeded random weights: one bf16 train step
    at 448 px (N = 785, B = 64, the CLI defaults: de-mixed pullbacks) with
    the fused BN route off and on, each then timed steadily (2 warm-up and
    6 timed steps, CUDA events), one f32 step at 320 px (N = 401, B =
    16) off and on, one bf16 step at 192 px (B = 64) of the model with 2
    heads x 256 (every attention kernel at padded width 256) off and on,
    one with 2 heads x 384 (the bodies of head widths above 256, route
    2) off, and the bf16 serving forward at 448 px (B = 64). Each
    checks its launches per step or forward against the counts the code
    gives, finite losses and outputs, and that the step moved every
    parameter. Returns the launches of the whole phase."""
    from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.ops import attention as A
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step, resolve_grad_demix

    c0 = _counts()
    steps = []
    for px, dtype, batch_size, arch, routes in (
            (LONG_BF16, "bfloat16", LONG_BF16_BATCH, {}, ("off", "on")),
            (LONG_F32, "float32", LONG_F32_BATCH, {}, ("off", "on")),
            (IMAGE, "bfloat16", LONG_BF16_BATCH, WIDE_HEADS, ("off", "on")),
            (IMAGE, "bfloat16", LONG_BF16_BATCH, WIDER_HEADS, ("off",))):
        dt = getattr(torch, dtype)
        if arch is WIDER_HEADS:
            n = (px // 16) ** 2 + 1
            check(A.kernel_route("fwd", n, arch["head_dim"], dt) == 2
                  and A.kernel_route("bwd", n, arch["head_dim"], dt) == 2,
                  f"{arch} at {px} px: not the route of head widths above "
                  "256")
        demix = resolve_grad_demix(TrainConfig(),
                                   ModelConfig(compute_dtype=dtype))
        pullbacks = 2 if demix else 1
        model = MultiTaskNet(image_size=(px, px), dtype=dt,
                             generator=torch.Generator().manual_seed(0),
                             **arch)
        state = create_train_state(model, device="cuda")
        step = make_train_step(AugmentConfig(), image_size=(px, px),
                               heatmap_size=(px // 4, px // 4),
                               grad_demix=demix)
        batch = {k: torch.from_numpy(v).cuda() for k, v in _staged_batch(
            batch_size, seed=7, canvas=px + 64).items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        turns = []
        try:
            for route in routes:
                layers._FUSED_BN = route == "on"
                torch.cuda.synchronize()
                k0 = _counts()
                t0 = time.perf_counter()
                state, m = step(state, batch, gen)
                loss = float(m["total_loss"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                got = _delta(_counts(), k0)
                want = {"attention_qkv_fwd": 4,
                        "attention_qkv_bwd": 4 * pullbacks,
                        "attention_split_fwd": 0, "attention_split_bwd": 0,
                        "warp_twopass": 1,
                        "bn_act_reduce": n_bn * pullbacks * (route == "on"),
                        "bn_act_elem": n_bn * pullbacks * (route == "on")}
                check(got == want, f"{px} px {dtype} step, fused BN {route}: "
                                   f"launches {got} != {want}")
                check(np.isfinite(loss), f"{px} px step loss {loss}")
                turn = {"fused_bn": route, "loss": loss,
                        "seconds_first_step": seconds, "launches": got}
                if px == LONG_BF16:
                    # the 448 px step's steady time (CUDA events): 2
                    # warm-up steps and 6 timed, as the train line's turns
                    held = [state]

                    def one_step(held=held):
                        held[0], _ = step(held[0], batch, gen)

                    turn["ms_per_step"] = cuda_time_ms(
                        torch, one_step, iters=TURN_STEPS,
                        warmup=TURN_WARMUP)
                    state = held[0]
                turns.append(turn)
        finally:
            layers._FUSED_BN = None
        after = model.state_dict()
        moved = sum(not torch.equal(before[k], after[k])
                    for k, _ in model.named_parameters())
        n_params = sum(1 for _ in model.named_parameters())
        check(moved == n_params, f"{px} px: params moved {moved}/{n_params}")
        steps.append({"image": px, "n": (px // 16) ** 2 + 1, "dtype": dtype,
                      "batch": batch_size, "canvas": px + 64,
                      "heads_x_head_dim": [arch.get("heads", HEADS),
                                           arch.get("head_dim", HEAD_DIM)],
                      "grad_demix": demix, "turns": turns})
        del model, state, step, batch, before, after
        torch.cuda.empty_cache()

    # the bf16 serving forward at 448 px
    model = MultiTaskNet(image_size=(LONG_BF16, LONG_BF16),
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to("cuda")
    x = torch.from_numpy(np.random.RandomState(8).randn(
        SERVE_BATCH, LONG_BF16, LONG_BF16, 3).astype(np.float32)).cuda()
    k0 = _counts()
    with torch.inference_mode():
        ms = cuda_time_ms(torch, lambda: model(x, need_attnmap=False),
                          iters=5, warmup=1)
        logits, hmap, _ = model(x, need_attnmap=False)
        torch.cuda.synchronize()
    forwards = _delta(_counts(), k0)["attention_qkv_fwd"] // 4
    check(forwards == 7, f"448 px serving: {forwards} forwards' launches")
    check(tuple(logits.shape) == (SERVE_BATCH, 19) and tuple(hmap.shape) == (
        SERVE_BATCH, LONG_BF16 // 4, LONG_BF16 // 4, 21)
        and bool(torch.isfinite(logits).all() and torch.isfinite(hmap)
                 .all()), "448 px serving outputs: shapes and finite")
    launches = _delta(_counts(), c0)
    emit({"long_paths": {
        "model": "MultiTaskNet small (dim 256, depth 4, 8x32 heads; the "
                 "wide-head steps 2x256 and 2x384), seeded random weights",
        "train_steps": steps,
        "serving_448_bf16": {"batch": SERVE_BATCH, "n": 785,
                             "ms_per_forward": ms,
                             "crops_per_s": SERVE_BATCH / ms * 1e3},
        "launches": launches}})
    return launches


def _warp_inputs(torch, b, rot, seed, scale=1.1):
    from hgr_tpu_torch.ops.affine import build_affine

    rng = np.random.RandomState(seed)
    canvas = torch.from_numpy(rng.randint(
        0, 256, (b, CANVAS, CANVAS, 3), np.uint8)).cuda()
    m = build_affine(torch.full((b, 2), CANVAS / 2.0, device="cuda"),
                     torch.full((b,), scale, device="cuda"),
                     torch.full((b,), rot, device="cuda"),
                     torch.full((b,), 0.35 * CANVAS, device="cuda"),
                     (IMAGE, IMAGE))
    gains = torch.from_numpy(rng.uniform(0.7, 1.3, (b, 3)).astype(
        np.float32)).cuda()
    do_j = torch.from_numpy((rng.rand(b) < 0.5).astype(np.float32)).cuda()
    return canvas, m, gains, do_j


def _shrinking_affines(torch, b, scale=WARP_SHRINK):
    """(B, 2, 3) src->dst affines of ``scale`` times a rotation (0, 30,
    75, 135 degrees in turn), the canvas center onto the crop's: each
    output pixel ~4 canvas pixels from its neighbours, so a 32 x 32
    output tile's footprint outgrows the warp kernel's shared memory and
    it takes smaller sub-tiles."""
    m = np.zeros((b, 2, 3), np.float32)
    for i in range(b):
        a = np.deg2rad([0.0, 30.0, 75.0, 135.0][i % 4])
        lin = scale * np.array([[np.cos(a), -np.sin(a)],
                                [np.sin(a), np.cos(a)]])
        m[i, :, :2] = lin
        m[i, :, 2] = np.full(2, IMAGE / 2.0) - lin @ np.full(2, CANVAS / 2.0)
    return torch.from_numpy(m).cuda()


def _warp_footprint_px(torch, m, s: int, out_h: int, out_w: int):
    """(B,) canvas pixels the warp must read per image: the distinct
    pixels the four taps of every unmasked output pixel reach, by the
    plain version's own formulas (ops/warp.py)."""
    from hgr_tpu_torch.ops.warp import border_mask, twopass_coefficients

    counts = []
    for m_c in m.split(32):
        minv, use_t, alpha, beta, gamma, s2, t2, u2 = (
            c.to(m.device) for c in twopass_coefficients(m_c))
        b = m_c.shape[0]
        yp, xp = torch.meshgrid(
            torch.arange(out_h, dtype=torch.float32, device=m.device),
            torch.arange(out_w, dtype=torch.float32, device=m.device),
            indexing="ij")
        inside = border_mask(minv, out_h, out_w, s, s)[..., 0] > 0

        def col(t):
            return t[:, None, None]

        def tap(pos):
            i0 = torch.clamp(torch.floor(pos), 0, s - 1).long()
            return i0, torch.clamp(i0 + 1, max=s - 1)

        seen = torch.zeros(b, s * s, dtype=torch.bool, device=m.device)
        for k in tap(col(s2) * xp + col(t2) * yp + col(u2)):
            for x in tap(col(alpha) * xp + col(beta) * k.float()
                         + col(gamma)):
                row = torch.where(col(use_t), x, k)
                column = torch.where(col(use_t), k, x)
                flat = torch.where(inside, row * s + column, -1).reshape(
                    b, -1)
                ok = flat >= 0
                seen.scatter_(1, torch.where(ok, flat, 0), ok)
        counts.append(seen.sum(dim=1))
    return torch.cat(counts).float()


def _einsum_inverse(torch, m):
    """PRs 2-6's ops/affine.py:invert_affine: A^-1 b as a batched einsum
    (ops/affine.py now writes it out elementwise, the warp kernel's order)."""
    a, b = m[..., :, :2], m[..., :, 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_a = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
    ], dim=-2) / det[..., None, None]
    inv_b = -torch.einsum("...ij,...j->...i", inv_a, b)
    return torch.cat([inv_a, inv_b[..., None]], dim=-1)


def _inverse_reading(torch, m) -> dict:
    """On the card: the images whose inverse affine differs in any bit
    between ops/affine.py:invert_affine and PRs 2-6's einsum."""
    from hgr_tpu_torch.ops.affine import invert_affine

    differ = (invert_affine(m) != _einsum_inverse(torch, m)).flatten(1)
    return {"images": m.shape[0], "differ": int(differ.any(dim=1).sum())}


def _step_warp_inputs(torch, b: int, px: int, seed: int, canvas=None):
    """The warp's inputs in a train step at crop side ``px``: a staged
    batch (canvas px + 64 unless given, ``_staged_batch``) and a draw of the step's
    augments on a card generator, through the pipeline's own
    ``crop_affines``. Returns canvas, affines, gains, do_jitter and the
    batch's orig_to_canvas."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data.pipeline import crop_affines, draw_augment_params

    batch = _staged_batch(b, seed, canvas=canvas or px + 64)
    t = {k: torch.from_numpy(batch[k]).cuda()
         for k in ("canvas", "orig_to_canvas", "sizes_hw")}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = draw_augment_params(gen, b, t["sizes_hw"], AugmentConfig())
    _, m = crop_affines(t["orig_to_canvas"], t["sizes_hw"], params, (px, px))
    return (t["canvas"], m, params.jitter_gains, params.do_jitter,
            t["orig_to_canvas"])


def warp_kernel_phase(torch):
    """Warp kernel vs plain version: at B=256, S=256 -> 192 uint8 canvases
    with jitter at 0° and 90° (the transpose route), f32 and bf16
    canvases, a shrinking affine (scale 0.25: smaller sub-tiles), and the
    train steps' own inputs (a staged batch and an augment draw) at every
    canvas a path of this script warps: 256 -> 192 (B=256; B=128 and 64,
    the mesh paths' rank batches; B=32, display_data's, path 19's
    microbatch and path 20's recipe batch), 512 -> 448 (B=64),
    384 -> 320 (B=16) and 192 -> 192 (B=512, path 22's microbatch). Per case
    ``same_bits`` against the plain version on the card and
    ``same_bits_cpu`` against the plain version on the CPU (which equals the JAX package's crop bit for bit,
    tests/test_torch_augment.py); wrapper and plain times with the spread
    of their turns; the bound from the footprint the affines give (the
    canvas pixels the taps reach, each read once) and the output in its
    dtype, beside the whole-canvas, f32-output figure of PRs 2-6. Also,
    per case and at the step tests' own affines, the images whose inverse
    affine on the card differs between ops/affine.py:invert_affine and
    PRs 2-6's einsum. No single PyTorch call computes this function
    (grid_sample has no jitter and no two-pass taps), so there is no
    library time."""
    from hgr_tpu_torch.ops import warp_fused as W
    from hgr_tpu_torch.data.pipeline import AugmentParams, crop_affines

    cases = []
    for rot, dtype in ((0.0, "uint8"), (90.0, "uint8"), (30.0, "float32"),
                       (30.0, "bfloat16")):
        canvas, m, gains, do_j = _warp_inputs(torch, TRAIN_BATCH, rot,
                                              seed=int(rot) + len(dtype))
        cases.append(({"rot": rot, "scale": 1.1}, canvas.to(
            getattr(torch, dtype)), m, gains, do_j, IMAGE))
    canvas, _, gains, do_j = _warp_inputs(torch, TRAIN_BATCH, 0.0, seed=12)
    cases.append(({"rot": "shrink", "scale": WARP_SHRINK}, canvas,
                  _shrinking_affines(torch, TRAIN_BATCH), gains, do_j, IMAGE))
    inverses = {}
    for px, b in ((IMAGE, TRAIN_BATCH), (IMAGE, DISPLAY_BATCH),
                  *((IMAGE, b) for b in MESH_RANK_BATCHES[:2]),
                  (LONG_BF16, LONG_BF16_BATCH), (LONG_F32, LONG_F32_BATCH)):
        canvas, m, gains, do_j, o2c = _step_warp_inputs(torch, b, px, seed=7)
        cases.append(({"rot": "step draw"}, canvas, m, gains, do_j, px))
        inverses[f"step_{px}_b{b}_orig_to_canvas"] = _inverse_reading(
            torch, o2c)
    # path 22's microbatch: 192 -> 192, the cache geometry of hagrid_fit
    canvas, m, gains, do_j, _ = _step_warp_inputs(
        torch, HAGRID_MICRO, IMAGE, seed=7, canvas=IMAGE)
    cases.append(({"rot": "step draw"}, canvas, m, gains, do_j, IMAGE))
    batch, params = _grid_third_case(torch, 8)
    _, m = crop_affines(
        torch.from_numpy(batch["orig_to_canvas"]).cuda(),
        torch.from_numpy(batch["sizes_hw"]).cuda(),
        AugmentParams(**{k: v.cuda() for k, v in params.items()}),
        (IMAGE, IMAGE))
    inverses["grid_third_step_canvas_affines"] = _inverse_reading(torch, m)

    checks, main = [], None
    for info, canvas, m, gains, do_j, out_side in cases:
        b, s = canvas.shape[0], canvas.shape[1]
        size = (out_side, out_side)
        kw = dict(jitter_gains=gains, do_jitter=do_j, round_output=True)
        out = W.warp_twopass(canvas, m, size, **kw)
        ref = W.warp_twopass_reference(canvas, m, size, **kw)
        ref_cpu = W.warp_twopass_reference(
            canvas.cpu(), m.cpu(), size, jitter_gains=gains.cpu(),
            do_jitter=do_j.cpu(), round_output=True)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        dtype = str(canvas.dtype).split(".")[-1]
        row = {"kernel": "warp_twopass", "canvas": [b, s, s, 3],
               "out": out_side, "dtype": dtype,
               "out_dtype": str(out.dtype).split(".")[-1], **info,
               "jitter": True,
               "same_bits": bool(torch.equal(out, ref)),
               "same_bits_cpu": bool(torch.equal(out.cpu(), ref_cpu)),
               "max_abs_err": diff.max().item(),
               "frac_above_tol": (diff > WARP_TOL).float().mean().item(),
               "tol": WARP_TOL,
               "inverse_vs_einsum": _inverse_reading(torch, m)}
        # the parent's kernel equalled its plain version bit for bit at
        # every card-test case; so must this one, at every canvas a path
        # warps, against the card's plain version and the CPU's
        check(row["same_bits"] and row["same_bits_cpu"]
              and out.dtype == ref.dtype,
              f"warp kernel vs plain {dtype} {info}: {row}")
        row.update(_alternate(torch, {
            "plain": lambda: W.warp_twopass_reference(canvas, m, size, **kw),
            "wrapper": lambda: W.warp_twopass(canvas, m, size, **kw),
        }, iters=WARP_ITERS))
        row["ms"] = row.pop("wrapper_ms")
        row["spread"] = {name: (max(t) - min(t)) / float(np.mean(t))
                         for name, t in row["runs_ms"].items()}
        footprint = _warp_footprint_px(torch, m, s, out_side, out_side)
        row["footprint_px_per_image"] = footprint.mean().item()
        row.update(_bound(
            footprint.sum().item() * 3 * canvas.element_size()
            + out.numel() * out.element_size(),
            b * out_side * out_side * WARP_FLOPS
            + JITTER_FLOPS * (footprint * do_j).sum().item(), "float32"))
        # PRs 2-6's figure: the whole canvas read, an f32 crop written
        row["bound_ms_whole_canvas_f32_out"] = (
            (canvas.numel() * canvas.element_size() + out.numel() * 4)
            / HBM_BYTES_PER_S * 1e3)
        row["library_ms"] = None
        if main is None:
            main = row
        checks.append(row)
    main["max_abs_err"] = max(r["max_abs_err"] for r in checks)
    emit({"kernel_checks": checks})
    emit({"warp_inverse_vs_einsum": inverses})
    return main


def _staged_batch(b: int, seed: int, canvas: int = CANVAS) -> dict:
    """A staged training batch in the loader's layout, made with numpy:
    random uint8 canvases of side ``canvas`` holding images of 200-400 px
    scaled into them, joints inside the central window, valid all ones."""
    rng = np.random.RandomState(seed)
    sizes = rng.uniform(200, 400, (b, 2)).astype(np.float32)
    scale = canvas / sizes.max(axis=1)
    a = np.zeros((b, 2, 3), np.float32)
    a[:, 0, 0] = a[:, 1, 1] = scale
    return {
        "canvas": rng.randint(0, 256, (b, canvas, canvas, 3), np.uint8),
        "orig_to_canvas": a,
        "sizes_hw": sizes,
        "joints": (rng.uniform(0.35, 0.65, (b, 21, 2))
                   * sizes[:, None, ::-1]).astype(np.float32),
        "joints_vis": np.ones((b, 21), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int64),
        "valid": np.ones((b,), np.float32),
    }


def _counts():
    from hgr_tpu_torch.utils import launches

    return launches.counts()


def _zero_counts():
    from hgr_tpu_torch.utils import launches

    launches.zero()


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _device_kernels_per_call(torch, fn):
    """The names of the device kernels one call of ``fn`` runs, from a
    torch.profiler trace of it (after a warm call); None when the trace
    sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    return [e.name for e in kernels] or None


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
    f32 shape, and (checks only, untimed) at the same layer shapes at each
    of MESH_RANK_BATCHES, the rows a rank's fused BN sees on the mesh
    paths; times of kernel, plain version and, without the SiLU (the
    only case one call computes), the library calls: for the reduce
    native_batch_norm_backward and batch_norm_backward_reduce (dgamma =
    T2, dbeta = T1), for the elementwise pass batch_norm_backward_elemt
    (SyncBatchNorm's, fed sum_dy = T1 and sum_dy_xmu = T2/r). Then the bn
    time of one train step: each layer's two kernels, times 2 pullbacks."""
    from hgr_tpu_torch.ops import bn_act as B

    shapes = sorted({(h, w, c) for h, w, c, _ in path_layers}, reverse=True)
    cases = [(TRAIN_BATCH, shape, "bfloat16", act) for shape in shapes
             for act in (True, False)]
    # f32: the early units' shapes (--early_dtype float32 with fused BN)
    cases += [(TRAIN_BATCH, shape, "float32", act) for shape in sorted(
        {(h, w, c) for h, w, c, _ in path_layers[:EARLY_BN_LAYERS]},
        reverse=True) for act in (True, False)]
    cases += [(b, shape, "bfloat16", act) for b in MESH_RANK_BATCHES
              for shape in shapes for act in (True, False)]
    rows, by_case, mesh_rows = [], {}, []
    for b, (h, w, c), dtype, act in cases:
        gen = torch.Generator(device="cuda").manual_seed(h * 1000 + c)
        dt = getattr(torch, dtype)
        m_rows = b * h * w
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
        base = {"shape": [b, h, w, c], "dtype": dtype, "act": act}
        check(sum_err <= BN_SUM_TOL,
              f"bn_act_reduce vs plain at {base}: {sum_err}")
        elem_err = float(diff.max())
        check(excess <= 0, f"bn_act_elem vs plain at {base}: {elem_err}")
        del diff, dy
        if b != TRAIN_BATCH:  # a mesh rank's rows: checked, not timed
            mesh_rows.append({**base, "reduce_max_err_over_sum_of_abs":
                              sum_err, "reduce_tol": BN_SUM_TOL,
                              "elem_max_abs_err": elem_err, "atol": atol,
                              "rtol": rtol})
            del y, g, ref
            torch.cuda.empty_cache()
            continue
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
        if "library_reduce_call_ms" in red:  # torch.batch_norm_backward_reduce
            red["ms_over_reduce_call_ms"] = (red["ms"]
                                             / red["library_reduce_call_ms"])
        red["device_kernels_per_call"] = _device_kernels_per_call(
            torch, reduce_fns["kernel"])
        check(red["device_kernels_per_call"] is None
              or len(red["device_kernels_per_call"]) == 1,
              f"bn_act_reduce at {base}: device kernels a call "
              f"{red['device_kernels_per_call']}")
        if lib is not None:  # the whole backward, for the pair's yardstick
            elem["library_whole_backward_ms"] = cuda_time_ms(
                torch, lib([True, True, True]), iters=20, warmup=3)
        rows += [red, elem]
        by_case[((h, w, c), dtype, act)] = (red, elem)
        del y, g
        torch.cuda.empty_cache()
    emit({"kernel_checks": rows})
    emit({"bn_mesh_rank_batch_checks": mesh_rows})

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
                    "attention_qkv_bwd": 4 * pullbacks,
                    "attention_split_fwd": 0, "attention_split_bwd": 0,
                    "warp_twopass": 1,
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


def train_vs_cpu_phase(torch, fused: bool, n_bn: int, demix=True,
                       line: str = "train_f32_b8_vs_cpu"):
    """One f32 de-mixed step at B=8 on the card (the kernels) against the
    same step on the CPU (warp_method 'kernel' runs the kernel's plain
    version there), with the fused BN route off or on; TF32 is off.
    ``demix='batched'`` takes both steps' pullbacks as one batched
    backward (and the card's step must have taken it)."""
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
                    heatmap_size=(IMAGE // 4, IMAGE // 4), grad_demix=demix,
                    debug_return_grads=True, warp_method="kernel")
                c0 = _counts()
                _, out[dev] = step(state, batch, torch.Generator(device=dev))
                torch.cuda.synchronize()
                launches = _delta(_counts(), c0)  # the card's step is last
    finally:
        layers._FUSED_BN = None
    bn = 2 * n_bn if fused else 0
    check(launches["bn_act_reduce"] == bn and launches["bn_act_elem"] == bn
          and launches["attention_qkv_bwd"] == 8,
          f"card step with fused BN {fused}: launches {launches}")
    check(step.batched_backwards == (demix == "batched"),
          f"card step {demix}: {step.batched_backwards} batched backwards")
    g_card, g_cpu = out["cuda"]["_grads"], out["cpu"]["_grads"]
    errs = {k: float((g_card[k].cpu() - w).norm()
                     / w.norm().clamp_min(1e-12)) for k, w in g_cpu.items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(out["cuda"]["total_loss"])
                   - float(out["cpu"]["total_loss"]))
    emit({line: {
        "fused_bn": fused, "grad_demix": demix, "card_launches": launches,
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


def write_dataset():
    """The synthetic splits of LOOP_SPLITS (seeds 0-2) under
    build/chip_smoke/data: (work directory, DataConfig, seconds)."""
    import shutil

    from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    for seed, (split, n) in enumerate(LOOP_SPLITS):
        write_synthetic_split(data, split, n, seed=seed)
    return (work, DataConfig(path=data, names=dict(DEFAULT_NAMES)),
            time.perf_counter() - t0)


def loop_phase(torch, n_bn: int, work: str, cfg, write_s: float):
    """Training from files through the CLI's ``run``: a synthetic dataset
    (LOOP_SPLITS, the writer's 224 px JPEGs, seeds 0-2), B=256, canvas
    256, bf16, HGR_TPU_FUSED_BN=on. Run 1: 2 epochs with the first 3 steps
    profiled, then the test split from the best checkpoint; run 2:
    ``--resume``, 1 epoch from the saved step; run 3: ``--resume
    --device_cache``, 2 epochs, the first 3 steps profiled. Checks the
    steps, the checkpoints, the logged metrics and every kernel's
    launches against the counts the code gives. Also times the streaming
    loader alone over the train split (no device work)."""
    from hgr_tpu_torch.cli import train as cli
    from hgr_tpu_torch.data import native
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.data.pipeline import staging_window_fraction

    data = cfg.path
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
    return counts, save


def _rank_counts(save: str, world: int) -> list:
    """The launch counts each rank of a CLI mesh run wrote beside it."""
    out = []
    for r in range(world):
        with open(os.path.join(save, "ranks", f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_phase(torch, n_bn: int, work: str, cfg):
    """Multi-rank training through the CLI's ``run`` on the loop phase's
    dataset, bf16, CLI defaults (de-mixed), fused BN on, global batch
    MESH_BATCH: 1 epoch and the test split on the 2x2 mesh (four ranks
    sharing the card over gloo; the coordinator traces its first 3
    steps), then 2 epochs on {data: 2} from the sharded device cache. Checks every rank's launches against the counts
    the code gives. Returns (summed launches, the TP run's save path)."""
    from hgr_tpu_torch.cli import train as cli

    n_train, n_val, n_test = (n for _, n in LOOP_SPLITS)
    base = ["--data_config", "(a DataConfig built by chip_smoke.py)",
            "--batch_size", str(MESH_BATCH), "--canvas_size", str(CANVAS),
            "--image_size", str(IMAGE), str(IMAGE), "--dtype", "bfloat16",
            "--seed", "0", "--num_workers", "2", "--device", "cuda",
            "--save_dir", os.path.join(work, "mesh_out"),
            "--log_dir", os.path.join(work, "mesh_logs")]
    per_epoch = -(-n_train // MESH_BATCH)
    evals = -(-n_val // MESH_BATCH)
    runs = [("2x2 mesh (data x model), 1 epoch, test", TP_MESH,
             ["--suffix", "tp", "--epochs", "1", "--mesh", "data=2,model=2",
              "--host_device_count", "4", "--profile", "3"], 1,
             evals + -(-n_test // MESH_BATCH), "split"),
            ("{data: 2} mesh, --device_cache, 2 epochs", DP_MESH,
             ["--suffix", "dp", "--epochs", "2", "--mesh", "data=2",
              "--host_device_count", "2", "--device_cache"], 2,
             2 * evals + -(-n_test // MESH_BATCH), "qkv")]
    total = {name: 0 for name in KERNELS}
    rows, tp_save = [], ""
    os.environ["HGR_TPU_FUSED_BN"] = "on"
    try:
        for name, shape, argv, epochs, eval_steps, route in runs:
            world = shape.get("data", 1) * shape.get("model", 1)
            t0 = time.perf_counter()
            state, save = cli.run(cli.parse_args(base + argv), cfg)
            seconds = time.perf_counter() - t0
            check(state is None, f"{name}: the ranks ran in processes")
            ranks = _rank_counts(save, world)
            steps = epochs * per_epoch
            want = {f"attention_{route}_fwd": 4 * (steps + eval_steps),
                    f"attention_{route}_bwd": 8 * steps,
                    "bn_act_reduce": 2 * n_bn * steps,
                    "bn_act_elem": 2 * n_bn * steps}
            for r, rec in enumerate(ranks):
                got = rec["launches"]
                check(rec["step"] == steps and rec["backend"] == "gloo",
                      f"{name} rank {r}: step {rec['step']} backend "
                      f"{rec['backend']}")
                check(all(got[k] == v for k, v in want.items())
                      and got["warp_twopass"] >= steps,
                      f"{name} rank {r}: launches {got}, want {want}")
                for k in total:
                    total[k] += got[k]
            with open(os.path.join(work, "mesh_logs", os.path.basename(save),
                                   "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f]
            epoch_lines = [x for x in lines if "epoch" in x]
            check(len(epoch_lines) == epochs and all(
                np.isfinite(x["train/total_loss"]) for x in epoch_lines),
                f"{name}: epoch lines {epoch_lines}")
            rows.append({
                "run": name, "mesh": shape, "ranks": world,
                "backend": "gloo, one card shared", "seconds": seconds,
                "steps": steps, "eval_steps": eval_steps,
                "train_time_s": [x["train_time_s"] for x in epoch_lines],
                "steps_per_s": [per_epoch / x["train_time_s"]
                                for x in epoch_lines],
                "train_loss": [x["train/total_loss"] for x in epoch_lines],
                "val_loss": [x["val/total_loss"] for x in epoch_lines],
                "launches_per_rank": [rec["launches"] for rec in ranks]})
            if shape is TP_MESH:
                tp_save = save
                # the coordinator's trace: its own kernels only, while the
                # other three ranks share the card
                with open(os.path.join(save, "profile",
                                       "profile_summary.json")) as f:
                    prof = json.load(f)
                check(prof["device_events"] > 0,
                      f"{name}: rank 0's profile saw device kernels")
                rows[-1]["rank0_profile_3_steps"] = {
                    **{k: prof[k] for k in ("window_ms", "device_busy_ms",
                                            "device_idle_share",
                                            "device_events")},
                    "top_device_ops": prof["top_device_ops"][:6]}
    finally:
        os.environ.pop("HGR_TPU_FUSED_BN")
    emit({"mesh": {"batch": MESH_BATCH, "dtype": "bfloat16",
                   "fused_bn": True, "steps_per_epoch": per_epoch,
                   "runs": rows, "launches": total}})
    return total, tp_save


def _mesh_rank(rank: int, world: int, port: int, in_path: str,
               out_dir: str) -> None:
    """One rank of the 2x2 card checks: the f32 parity step on its rows
    (its share of the fixed augment draw), with two pullbacks and with the
    batched backward, then the TP run's best checkpoint restored into its
    shard, an eval forward of its rows and the eval step's attention map
    of its rows of the parity batch (every head: the model group's head
    groups gathered)."""
    import torch

    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data import pipeline
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from hgr_tpu_torch.parallel.steps import (
        make_parallel_eval_step,
        make_parallel_train_step,
        shard_state,
    )
    from hgr_tpu_torch.parallel.tp import gather_state
    from hgr_tpu_torch.train import steps
    from hgr_tpu_torch.train.checkpoint import CheckpointManager
    from hgr_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        inp = torch.load(in_path, weights_only=False)
        mesh = make_mesh(TP_MESH)
        params = inp["params"]
        steps.draw_augment_params = lambda gen, b, sizes, cfg: \
            pipeline.AugmentParams(**{k: torch.from_numpy(v[:b]).cuda()
                                      for k, v in params.items()})
        full = MultiTaskNet(image_size=(IMAGE, IMAGE),
                            generator=torch.Generator().manual_seed(1)
                            ).state_dict()
        parity = {}
        for demix in (True, "batched"):
            model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                                 fused_attention="split")
            model.load_state_dict(full)
            state = shard_state(create_train_state(model, device="cuda"),
                                mesh, tensor_parallel=True)
            step = make_parallel_train_step(
                mesh, AugmentConfig(), image_size=(IMAGE, IMAGE),
                heatmap_size=(IMAGE // 4, IMAGE // 4), grad_demix=demix,
                debug_return_grads=True, warp_method="kernel")
            _, m = step(state, shard_batch(inp["batch"], mesh),
                        torch.Generator(device="cuda"))
            parity[str(demix)] = {
                "grads": {k: v.cpu() for k, v in gather_state(
                    {"step": 0, "model": m.pop("_grads")}, mesh,
                    state.model)["model"].items()},
                "loss": float(m["total_loss"]),
                "batched_backwards": step.batched_backwards}
        # the TP run's best checkpoint, cut to this rank's shard (f32)
        best = MultiTaskNet(image_size=(IMAGE, IMAGE),
                            fused_attention="split")
        best = shard_state(create_train_state(best, device="cuda"), mesh,
                           tensor_parallel=True)
        best = CheckpointManager(inp["weight_dir"], mesh=mesh).restore(
            best, "best")
        x = torch.from_numpy(inp["images"]).cuda()
        rows = shard_batch({"x": x}, mesh)["x"]
        with torch.no_grad():
            logits, hmap, _ = best.model.eval()(rows, need_attnmap=False)
        _, outputs = make_parallel_eval_step(
            mesh, image_size=(IMAGE, IMAGE),
            heatmap_size=(IMAGE // 4, IMAGE // 4), return_outputs=True,
            with_attnmap=True, warp_method="kernel")(
                best, shard_batch(inp["batch"], mesh))
        if rank == 0:
            torch.save({"parity": parity, "best_step": best.step},
                       os.path.join(out_dir, "parity.pt"))
        if mesh.model_index == 0:
            torch.save({"logits": logits.float().cpu(),
                        "hmap": hmap.float().cpu(),
                        "attnmap": outputs["attnmap"].cpu()},
                       os.path.join(out_dir, f"eval{mesh.data_index}.pt"))
    finally:
        distributed.shutdown()


def _single_parity_step(torch, batch, params):
    """The single-process f32 de-mixed step on the card that the mesh
    parity steps are held against: (gradients, loss) of the seed-1
    model on ``batch`` under the draw ``params``."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    with _fixed_draw(params):
        model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                             generator=torch.Generator().manual_seed(1))
        state = create_train_state(model, device="cuda")
        step = make_train_step(
            AugmentConfig(), image_size=(IMAGE, IMAGE),
            heatmap_size=(IMAGE // 4, IMAGE // 4), grad_demix=True,
            debug_return_grads=True, warp_method="kernel")
        _, single = step(state, batch, torch.Generator(device="cuda"))
    return single["_grads"], float(single["total_loss"])


def _parity_row(got: dict, g_one: dict, loss: float) -> dict:
    """A mesh parity step's gathered gradients and loss against the
    single-process step's."""
    errs = {k: float((got["grads"][k] - w.cpu()).norm()
                     / w.cpu().norm().clamp_min(1e-12))
            for k, w in g_one.items()}
    worst = max(errs, key=errs.get)
    return {"max_rel_grad_err": errs[worst], "worst_tensor": worst,
            "median_rel_grad_err": float(np.median(list(errs.values()))),
            "tol": STEP_GRAD_TOL, "loss": loss,
            "loss_abs_err": abs(got["loss"] - loss),
            "batched_backwards": got["batched_backwards"]}


def mesh_checks_phase(torch, tp_save: str, work: str) -> None:
    """On the 2x2 mesh (four ranks on the card, gloo), f32 with TF32 off:
    one de-mixed step at global B=PARITY_BATCH, with two pullbacks and
    with the batched backward (the split backward kernel and the
    all-reduces through their operators, once per cotangent row), each
    against the single-process two-pullback step on the card (per-tensor
    relative gradient error STEP_GRAD_TOL, the loss to 1e-5 relative); the
    TP run's best checkpoint, restored on one rank, against the four
    ranks' f32 eval forward (each its rows, from the same file cut to its
    shard), within MODEL_TOL of the largest output (f32 sums in another
    order: the row-parallel reduce); and the ranks' eval-step attention
    map (B, heads, N, N) of the parity batch against the one rank's,
    within TP_MAP_TOL."""
    import torch.multiprocessing as mp

    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.parallel.distributed import free_port
    from hgr_tpu_torch.train.checkpoint import CheckpointManager
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_eval_step

    batch, params = _grid_third_case(torch, PARITY_BATCH)
    out_dir = os.path.join(work, "mesh_checks")
    os.makedirs(out_dir, exist_ok=True)
    images = np.random.RandomState(6).randn(8, IMAGE, IMAGE, 3).astype(
        np.float32)
    in_path = os.path.join(out_dir, "inputs.pt")
    torch.save({"batch": batch, "images": images,
                "params": {k: v.numpy() for k, v in params.items()},
                "weight_dir": os.path.join(tp_save, "weight")}, in_path)
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(4, free_port(), in_path, out_dir),
                       nprocs=4, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = torch.load(os.path.join(out_dir, "parity.pt"), weights_only=False)
    g_one, loss = _single_parity_step(torch, batch, params)
    steps_rows = {demix: _parity_row(got, g_one, loss)
                  for demix, got in ranks["parity"].items()}
    # the TP run's best checkpoint on one rank
    one = MultiTaskNet(image_size=(IMAGE, IMAGE))
    one = CheckpointManager(os.path.join(tp_save, "weight")).restore(
        create_train_state(one, device="cuda"), "best")
    with torch.no_grad():
        lo, hm, _ = one.model.eval()(torch.from_numpy(images).cuda(),
                                     need_attnmap=False)
    _, one_out = make_eval_step(
        image_size=(IMAGE, IMAGE), heatmap_size=(IMAGE // 4, IMAGE // 4),
        return_outputs=True, with_attnmap=True, warp_method="kernel")(
            one, batch)
    parts = [torch.load(os.path.join(out_dir, f"eval{d}.pt"),
                        weights_only=False) for d in range(2)]
    tp_map = torch.cat([p["attnmap"] for p in parts])
    map_err = float((tp_map - one_out["attnmap"].cpu()).abs().max())
    eval_err = max(
        (torch.cat([p["logits"] for p in parts]) - lo.float().cpu()).abs()
        .max().item(),
        (torch.cat([p["hmap"] for p in parts]) - hm.float().cpu()).abs()
        .max().item()) / max(lo.float().abs().max().item(),
                             hm.float().abs().max().item(), 1.0)
    emit({"mesh_checks": {
        "mesh": TP_MESH, "ranks": 4, "seconds": seconds,
        "f32_step_b8": steps_rows["True"],
        "f32_batched_step_b8": steps_rows["batched"],
        "best_checkpoint_step": ranks["best_step"],
        "one_rank_vs_ranks_eval_err_of_max_abs": eval_err,
        "eval_tol_of_max_abs": MODEL_TOL,
        "attnmap_shape": list(tp_map.shape),
        "attnmap_max_abs_err": map_err, "attnmap_tol": TP_MAP_TOL}})
    for demix, row in steps_rows.items():
        check(row["max_rel_grad_err"] <= STEP_GRAD_TOL,
              f"2x2 mesh ({demix}) vs single-process f32 step grads: {row}")
        check(row["loss_abs_err"] <= 1e-5 * abs(loss),
              f"2x2 mesh ({demix}) step loss: {row}")
        check(row["batched_backwards"] == (demix == "batched"),
              f"2x2 mesh ({demix}) batched backwards: {row}")
    check(ranks["best_step"] == one.step, "best checkpoint step")
    check(eval_err <= MODEL_TOL,
          f"best checkpoint on one rank vs the ranks' eval: {eval_err}")
    n = (IMAGE // 16) ** 2 + 1
    check(tuple(tp_map.shape) == (PARITY_BATCH, HEADS, n, n)
          and map_err <= TP_MAP_TOL,
          f"2x2 attention map {tuple(tp_map.shape)} vs one rank: {map_err}")


def _uneven_rank(rank: int, world: int, port: int, in_path: str,
                 out_dir: str) -> None:
    """One rank of path 18 on UNEVEN_MESH ({data: 1, model: 3}: the model
    axis does not divide the 8 heads; to_qkv alone is sharded, in
    contiguous thirds, and every rank attends over every head of the
    gathered qkv). f32 with TF32 off: the parity step at PARITY_BATCH
    with two pullbacks and batched, and the eval step's attention map;
    then the CLI defaults in bf16 (de-mixed, fused BN on) at global B =
    MESH_BATCH, UNEVEN_STEPS = (warm-up, timed) steps, the launch counts
    from 0 over them."""
    import torch

    from hgr_tpu_torch.config import AugmentConfig, TrainConfig
    from hgr_tpu_torch.data import pipeline
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import (
        attention_route,
        make_mesh,
        shard_batch,
    )
    from hgr_tpu_torch.parallel.steps import (
        make_parallel_eval_step,
        make_parallel_train_step,
        shard_state,
    )
    from hgr_tpu_torch.parallel.tp import gather_state, layouts
    from hgr_tpu_torch.train import steps
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.utils import launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        inp = torch.load(in_path, weights_only=False)
        mesh = make_mesh(UNEVEN_MESH)
        fused = attention_route(UNEVEN_MESH, HEADS)
        sizes = dict(image_size=(IMAGE, IMAGE),
                     heatmap_size=(IMAGE // 4, IMAGE // 4))
        full = MultiTaskNet(image_size=(IMAGE, IMAGE),
                            generator=torch.Generator().manual_seed(1)
                            ).state_dict()

        def fresh():
            model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                                 fused_attention=fused)
            model.load_state_dict(full)
            return shard_state(create_train_state(model, device="cuda"),
                               mesh, tensor_parallel=True)

        draw = steps.draw_augment_params
        params = inp["params"]
        steps.draw_augment_params = lambda gen, b, sizes_hw, cfg: \
            pipeline.AugmentParams(**{k: torch.from_numpy(v[:b]).cuda()
                                      for k, v in params.items()})
        parity = {}
        try:
            for demix in (True, "batched"):
                state = fresh()
                step = make_parallel_train_step(
                    mesh, AugmentConfig(), grad_demix=demix,
                    debug_return_grads=True, warp_method="kernel", **sizes)
                _, m = step(state, shard_batch(inp["batch"], mesh),
                            torch.Generator(device="cuda"))
                parity[str(demix)] = {
                    "grads": {k: v.cpu() for k, v in gather_state(
                        {"step": 0, "model": m.pop("_grads")}, mesh,
                        state.model)["model"].items()},
                    "loss": float(m["total_loss"]),
                    "batched_backwards": step.batched_backwards}
            state = fresh()
            attn = state.model.decoder.transformer.layers_0_attn
            route = {"fused": attn.fused, "heads": attn.heads,
                     "cuts": layouts(state.model)}
            _, outputs = make_parallel_eval_step(
                mesh, return_outputs=True, with_attnmap=True,
                warp_method="kernel", **sizes)(
                    state, shard_batch(inp["batch"], mesh))
        finally:
            steps.draw_augment_params = draw
        # the CLI defaults in bf16 at the global batch (every rank holds
        # every row: the data axis has one rank)
        tcfg = TrainConfig()
        layers._FUSED_BN = True
        model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=torch.bfloat16,
                             fused_attention=fused,
                             generator=torch.Generator().manual_seed(0))
        state = shard_state(create_train_state(model, lr=tcfg.lr,
                                               device="cuda"),
                            mesh, tensor_parallel=True)
        step = make_parallel_train_step(
            mesh, AugmentConfig(), sigma=tcfg.sigma,
            class_loss_weight=tcfg.class_loss_weight, grad_demix=True,
            **sizes)
        batch = shard_batch({k: torch.from_numpy(v).cuda()
                             for k, v in inp["bf16_batch"].items()}, mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        warm, timed = UNEVEN_STEPS
        launches.zero()
        for _ in range(warm):
            state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / timed
        out = {"launches": launches.counts(), "ms_per_step": ms,
               "loss": float(m["total_loss"]), "step": state.step}
        if rank == 0:
            out.update(parity=parity, route=route,
                       attnmap=outputs["attnmap"].cpu())
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def uneven_tp_phase(torch, n_bn: int, work: str) -> dict:
    """Path 18: a model axis that does not divide the heads. Three ranks
    share the card over gloo on UNEVEN_MESH. The f32 parity step (two
    pullbacks and batched: the qkv gather's backward a slice, the
    packed attention backward kernel once per cotangent row) against the
    single-process step on the card (STEP_GRAD_TOL, the loss to 1e-5
    relative); the eval step's attention map, every head on each rank,
    against one process's (TP_MAP_TOL); then UNEVEN_STEPS bf16 steps of
    the CLI defaults at global B = MESH_BATCH on every rank, its launches
    held to the code's count (the packed kernels on all 8 heads, no split
    kernel), its ms/step beside one process's at the same batch. Returns
    the ranks' summed launches."""
    import torch.multiprocessing as mp

    from hgr_tpu_torch.config import AugmentConfig, TrainConfig
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.parallel.distributed import free_port
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_eval_step, make_train_step

    batch, params = _grid_third_case(torch, PARITY_BATCH)
    bf16_batch = _staged_batch(MESH_BATCH, seed=7)
    out_dir = os.path.join(work, "uneven_tp")
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "inputs.pt")
    torch.save({"batch": batch, "bf16_batch": bf16_batch,
                "params": {k: v.numpy() for k, v in params.items()}},
               in_path)
    world = UNEVEN_MESH["data"] * UNEVEN_MESH["model"]
    t0 = time.perf_counter()
    mp.start_processes(_uneven_rank, args=(world, free_port(), in_path,
                                           out_dir),
                       nprocs=world, join=True, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    g_one, loss = _single_parity_step(torch, batch, params)
    parity = {demix: _parity_row(got, g_one, loss)
              for demix, got in ranks[0]["parity"].items()}
    with _fixed_draw(params):
        one = create_train_state(MultiTaskNet(
            image_size=(IMAGE, IMAGE),
            generator=torch.Generator().manual_seed(1)), device="cuda")
        _, one_out = make_eval_step(
            image_size=(IMAGE, IMAGE), heatmap_size=(IMAGE // 4, IMAGE // 4),
            return_outputs=True, with_attnmap=True, warp_method="kernel")(
                one, batch)
    tp_map = ranks[0]["attnmap"]
    map_err = float((tp_map - one_out["attnmap"].cpu()).abs().max())
    # one process at the same batch and settings, for the ms/step beside
    # the ranks'
    tcfg = TrainConfig()
    layers._FUSED_BN = True
    try:
        model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, lr=tcfg.lr, device="cuda")
        step = make_train_step(
            AugmentConfig(), image_size=(IMAGE, IMAGE),
            heatmap_size=(IMAGE // 4, IMAGE // 4), sigma=tcfg.sigma,
            class_loss_weight=tcfg.class_loss_weight, grad_demix=True)
        b16 = {k: torch.from_numpy(v).cuda() for k, v in bf16_batch.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        warm, timed = UNEVEN_STEPS
        for _ in range(warm):
            state, m = step(state, b16, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(timed):
            state, m = step(state, b16, gen)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3 / timed
        one_loss = float(m["total_loss"])
    finally:
        layers._FUSED_BN = None
    steps_ = sum(UNEVEN_STEPS)
    want = {"attention_qkv_fwd": 4 * steps_, "attention_qkv_bwd": 8 * steps_,
            "attention_split_fwd": 0, "attention_split_bwd": 0,
            "warp_twopass": steps_, "bn_act_reduce": 2 * n_bn * steps_,
            "bn_act_elem": 2 * n_bn * steps_}
    total = {name: sum(r["launches"][name] for r in ranks)
             for name in KERNELS}
    n = (IMAGE // 16) ** 2 + 1
    route = ranks[0]["route"]
    emit({"uneven_tp": {
        "mesh": UNEVEN_MESH, "ranks": world,
        "backend": "gloo, one card shared", "seconds": seconds,
        "route": {"fused": route["fused"], "heads": route["heads"],
                  "sharded": sorted(route["cuts"])},
        "f32_step_b8": parity["True"], "f32_batched_step_b8":
        parity["batched"], "attnmap_shape": list(tp_map.shape),
        "attnmap_max_abs_err": map_err, "attnmap_tol": TP_MAP_TOL,
        "bf16_batch": MESH_BATCH, "steps": UNEVEN_STEPS,
        "ms_per_step_per_rank": [r["ms_per_step"] for r in ranks],
        "one_process_ms_per_step": one_ms,
        "loss_per_rank": [r["loss"] for r in ranks],
        "one_process_loss": one_loss,
        "launches_per_rank": [r["launches"] for r in ranks]}})
    for demix, row in parity.items():
        check(row["max_rel_grad_err"] <= STEP_GRAD_TOL,
              f"model=3 mesh ({demix}) vs single-process f32 step grads: "
              f"{row}")
        check(row["loss_abs_err"] <= 1e-5 * abs(loss),
              f"model=3 mesh ({demix}) step loss: {row}")
        check(row["batched_backwards"] == (demix == "batched"),
              f"model=3 mesh ({demix}) batched backwards: {row}")
    check(route["fused"] is True and route["heads"] == HEADS
          and set(route["cuts"].values()) == {"rows"}
          and sorted(route["cuts"]) == [
              f"decoder.transformer.layers_{i}_attn.to_qkv.weight"
              for i in range(4)],
          f"model=3 route and shards: {route}")
    check(tuple(tp_map.shape) == (PARITY_BATCH, HEADS, n, n)
          and map_err <= TP_MAP_TOL,
          f"model=3 attention map {tuple(tp_map.shape)} vs one process: "
          f"{map_err}")
    for r, rec in enumerate(ranks):
        check(rec["launches"] == want and rec["step"] == steps_
              and np.isfinite(rec["loss"]),
              f"model=3 rank {r}: launches {rec['launches']}, want {want}; "
              f"step {rec['step']}, loss {rec['loss']}")
    return total


def _cache_rank(rank: int, world: int, port: int, in_path: str,
                out_dir: str) -> None:
    """One rank of path 19's row check on DP_MESH: the sharded device
    cache of CACHE_CHECK_N train samples, once yielding its block of each
    global batch and once (microbatches=2) its rows of each microbatch by
    the all_to_all exchange; the first batch of each, and both loaders'
    seconds an epoch (two epochs each, alternately)."""
    import torch

    from hgr_tpu_torch.data.dataset import AnnotationIndex, read_annotations
    from hgr_tpu_torch.data.device_cache import ShardedDeviceCacheLoader
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        inp = torch.load(in_path, weights_only=False)
        mesh = make_mesh(DP_MESH)
        idx = read_annotations(inp["train_dir"], inp["names"])
        sub = AnnotationIndex(idx.samples[:CACHE_CHECK_N], idx.names)
        loaders = {a: ShardedDeviceCacheLoader(
            sub, shard_index=mesh.data_index, shard_count=mesh.data_size,
            device="cuda", group=mesh.data_group, microbatches=a,
            **inp["kw"]) for a in (1, 2)}
        first, seconds = {}, {1: [], 2: []}
        for epoch in range(3):  # epoch 0 builds the caches
            for a, loader in loaders.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i, b in enumerate(loader):
                    if epoch == 0 and i == 0:
                        first[a] = {k: (v.cpu().numpy()
                                        if isinstance(v, torch.Tensor)
                                        else np.asarray(v))
                                    for k, v in b.items()}
                torch.cuda.synchronize()
                if epoch:
                    seconds[a].append(time.perf_counter() - t0)
        torch.save({"first": first, "seconds": seconds,
                    "batches": len(loaders[1])},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def cache_accum_phase(torch, n_bn: int, work: str, cfg) -> dict:
    """Path 19: ``--device_cache --grad_accum 2`` under the {data: 2} mesh
    through the CLI's ``run``, bf16, CLI defaults, fused BN on, global
    batch MESH_BATCH, two epochs of the loop dataset (the first builds
    the cache; ms/step from the second): every rank's launches held to
    the code's count (4·a forwards, 8·a backwards and a warps a step, a =
    2, and 4 forwards and a warp an eval batch).
    Then the exchange itself on the card: each rank's first exchanged
    batch of a CACHE_CHECK_N-sample cache against its shard_rows of the
    ranks' blocks concatenated in rank order, bit for bit, valid
    included, and the loaders' epoch times with and without the
    exchange. Returns the ranks' summed launches."""
    import torch.multiprocessing as mp

    from hgr_tpu_torch.cli import train as cli
    from hgr_tpu_torch.data.pipeline import staging_window_fraction
    from hgr_tpu_torch.parallel.distributed import free_port
    from hgr_tpu_torch.parallel.mesh import shard_rows

    accum = 2
    n_train, n_val, n_test = (n for _, n in LOOP_SPLITS)
    argv = ["--data_config", "(a DataConfig built by chip_smoke.py)",
            "--batch_size", str(MESH_BATCH), "--canvas_size", str(CANVAS),
            "--image_size", str(IMAGE), str(IMAGE), "--dtype", "bfloat16",
            "--seed", "0", "--num_workers", "2", "--device", "cuda",
            "--save_dir", os.path.join(work, "accum_out"),
            "--log_dir", os.path.join(work, "accum_logs"),
            "--suffix", "dp_accum", "--epochs", "2", "--mesh", "data=2",
            "--host_device_count", "2", "--device_cache",
            "--grad_accum", str(accum)]
    per_epoch = -(-n_train // MESH_BATCH)
    steps = 2 * per_epoch
    shard_b = MESH_BATCH // DP_MESH["data"]
    eval_steps = 2 * -(-(n_val // 2) // shard_b) + -(-n_test // MESH_BATCH)
    os.environ["HGR_TPU_FUSED_BN"] = "on"
    try:
        t0 = time.perf_counter()
        state, save = cli.run(cli.parse_args(argv), cfg)
        seconds = time.perf_counter() - t0
    finally:
        os.environ.pop("HGR_TPU_FUSED_BN")
    check(state is None, "accum mesh: the ranks ran in processes")
    ranks = _rank_counts(save, 2)
    # one warp and 4 attention forwards a microbatch and an eval batch
    want = {"attention_qkv_fwd": 4 * (accum * steps + eval_steps),
            "attention_qkv_bwd": 8 * accum * steps,
            "attention_split_fwd": 0, "attention_split_bwd": 0,
            "warp_twopass": accum * steps + eval_steps,
            "bn_act_reduce": 2 * n_bn * accum * steps,
            "bn_act_elem": 2 * n_bn * accum * steps}
    total = {name: 0 for name in KERNELS}
    for r, rec in enumerate(ranks):
        got = rec["launches"]
        check(rec["step"] == steps and rec["backend"] == "gloo",
              f"accum mesh rank {r}: step {rec['step']} backend "
              f"{rec['backend']}")
        check(all(got[k] == v for k, v in want.items()),
              f"accum mesh rank {r}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
    with open(os.path.join(work, "accum_logs", os.path.basename(save),
                           "metrics.jsonl")) as f:
        epochs = [x for x in map(json.loads, f) if "epoch" in x]
    check(len(epochs) == 2 and all(
        np.isfinite(x[k]) for x in epochs
        for k in ("train/total_loss", "val/total_loss")),
        f"accum mesh: epoch lines {epochs}")
    # the exchange on the card, against the blocks
    out_dir = os.path.join(work, "cache_accum")
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "inputs.pt")
    kw = dict(batch_size=MESH_BATCH, canvas_size=CANVAS, num_joints=21,
              shuffle=True, seed=0, drop_last=False, num_workers=2,
              window_frac=staging_window_fraction(cfg.augments))
    torch.save({"train_dir": os.path.join(cfg.path, cfg.train),
                "names": cfg.names, "kw": kw}, in_path)
    t1 = time.perf_counter()
    mp.start_processes(_cache_rank, args=(2, free_port(), in_path, out_dir),
                       nprocs=2, join=True, start_method="spawn")
    check_s = time.perf_counter() - t1
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                      weights_only=False) for r in range(2)]
    blocks = {k: np.concatenate([g["first"][1][k] for g in got])
              for k in got[0]["first"][1]}
    same = []
    for r, g in enumerate(got):
        rows = shard_rows(MESH_BATCH, 2, r, accum)
        mine = g["first"][2]
        same.append(mine.keys() == blocks.keys() and all(
            mine[k].dtype == v.dtype and np.array_equal(mine[k], v[rows])
            for k, v in blocks.items()))
    per_batch = {a: float(np.median([s for g in got for s in g["seconds"][a]])
                          / got[0]["batches"] * 1e3) for a in (1, 2)}
    step_ms = epochs[1]["train_time_s"] * 1e3 / per_epoch
    emit({"cache_accum": {
        "mesh": DP_MESH, "ranks": 2, "grad_accum": accum,
        "batch": MESH_BATCH, "seconds": seconds, "steps": steps,
        "eval_steps": eval_steps,
        "train_time_s": [x["train_time_s"] for x in epochs],
        "epoch2_ms_per_step": step_ms,
        "train_loss": [x["train/total_loss"] for x in epochs],
        "val_loss": [x["val/total_loss"] for x in epochs],
        "launches_per_rank": [rec["launches"] for rec in ranks],
        "row_check_samples": CACHE_CHECK_N, "row_check_seconds": check_s,
        "first_batch_same_bits": same,
        "loader_ms_per_batch_blocks": per_batch[1],
        "loader_ms_per_batch_exchanged": per_batch[2],
        "exchange_share_of_step": (per_batch[2] - per_batch[1]) / step_ms}})
    check(all(same), f"accum mesh: exchanged rows vs shard_rows of the "
          f"blocks: {same}")
    return total


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


def serve_phase(torch, state, model=None, line="serve", weights=None):
    """2048 crops through ClassifierService from 4 client threads, then
    POST /classify through the port's HTTP handler: the bf16 model of
    ``state``, or ``model`` (emitted as ``line``), or the checkpoint
    ``weights`` served by the serving CLI's ``build_service`` with no
    ``--image_size``, whose crop size must be the one in the checkpoint's
    run_meta.json."""
    from hgr_tpu_torch.cli import serve as cli_serve
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.weights import read_run_meta
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.serve import ClassifierService

    meta_size = None
    if weights is not None:
        args = cli_serve.build_parser().parse_args(
            ["--weights", weights, "--max_batch", str(SERVE_BATCH)])
        svc = cli_serve.build_service(args)
        meta_size = tuple(read_run_meta(weights)["image_size"])
        check(svc.image_size == meta_size
              and tuple(args.image_size) == meta_size,
              f"served crop {svc.image_size} (args {args.image_size}) != "
              f"run_meta.json's {meta_size}")
    else:
        if model is None:
            model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                                 dtype=torch.bfloat16)
            model.load_state_dict(state, strict=True)
            model = model.eval().to("cuda")
        svc = ClassifierService(model, class_names=DEFAULT_NAMES,
                                max_batch=SERVE_BATCH, max_wait_ms=5.0,
                                pipeline_depth=4)
    size = svc.image_size[0]
    httpd = None
    try:
        svc.warm()
        n_clients, per_client = 4, 512
        rng = np.random.RandomState(1)
        crops = rng.randint(0, 256, (n_clients, per_client, size, size, 3),
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
                  and bool((lm < size).all()), "landmarks inside the crop")
        snap = svc.metrics.snapshot()

        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    cli_serve.make_handler(svc))
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
                  and bool((lm < size).all()), "HTTP landmarks")
            check(body["label"] == answers[i]["label"],
                  "HTTP answer equals the direct answer")
            http_ok += 1
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        check(stats["errors"] == 0, "no serving errors")
        emit({line: {
            "dtype": "bfloat16", "max_batch": SERVE_BATCH,
            "image_size": list(svc.image_size),
            "run_meta_image_size": meta_size and list(meta_size),
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


def _scenes(n: int, seed: int):
    """``n`` synthetic BGR frames of FRAME_HW, each a textured background
    with one synthetic hand (data/synthetic.py:make_hand_image, the
    crops the detector's weights were trained on) pasted at a random
    place and size, and the hands' boxes (x0, y0, x1, y1)."""
    from hgr_tpu_torch.data.synthetic import make_hand_image

    rng = np.random.RandomState(seed)
    fh, fw = FRAME_HW
    yy, xx = np.mgrid[0:fh, 0:fw].astype(np.float32)
    frames = np.empty((n, fh, fw, 3), np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        base = rng.randint(30, 160, 3)
        for c in range(3):
            frames[i, ..., c] = np.clip(
                base[c] + 50 * yy / fh * rng.rand() + 50 * xx / fw * rng.rand()
                + rng.randn(fh, fw) * 8, 0, 255)
        side = rng.randint(120, 300)
        crop, _ = make_hand_image(rng, size=side)
        x0, y0 = rng.randint(0, fw - side + 1), rng.randint(0, fh - side + 1)
        frames[i, y0:y0 + side, x0:x0 + side] = crop
        boxes[i] = (x0, y0, x0 + side, y0 + side)
    return frames, boxes


def _iou(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    wh = np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]), 0,
                 None)
    inter = wh[0] * wh[1]
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return float(inter / max(union, 1e-9))


def _pipeline_results(pipe, frames) -> list:
    """``pipe.infer_frames`` over ``frames`` in batches of DET_BATCH."""
    results = []
    for i in range(0, len(frames), DET_BATCH):
        results += pipe.infer_frames(frames[i:i + DET_BATCH])
    return results


def _hits(results, gts) -> int:
    return sum(r is not None and _iou(r["box"], g) > DET_HIT_IOU
               for r, g in zip(results, gts))


def _jpeg(frame) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame[..., ::-1])).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _device_profile(torch, fn, calls: int = 3) -> dict:
    """A torch.profiler trace of ``calls`` back-to-back calls of ``fn``
    (after a warm one): the device kernels per call, their summed time
    per call, the share of the traced wall time the device was busy, and
    the kernels that took the most time, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us / 1e3)
    busy = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels_per_call": sum(n for n, _ in by_name.values()) / calls,
            "device_ms_per_call": busy / calls,
            "traced_wall_ms_per_call": wall_ms / calls,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "top_ms_per_call": {name[:60]: t / calls
                                for name, (_, t) in top}}


def detect_phase(torch, state) -> int:
    """The two-stage pipeline at full width (YOLOv7-tiny 416 with the
    repository's detector weights, MultiTaskNet small 192, 360x640
    frames): f32 on the card against f32 on the CPU on 4 frames (the
    letterboxed input equal, raw heads and scores DET_HEAD_TOL, boxes and
    labels equal, landmarks within one heatmap cell), then the bf16 pipeline's rate at a batch of DET_BATCH by
    CUDA events and by the host clock, a profile of it, and its
    localization. Returns the classifier forwards it ran on the card."""
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_detector_weights

    here = os.path.dirname(os.path.abspath(__file__))
    det_state = load_detector_weights(os.path.join(here, DET_WEIGHTS))

    def pipeline(dtype, device, thresh=0.2):
        return HandGesturePipeline(state, det_state, DEFAULT_NAMES,
                                   dtype=dtype, device=device,
                                   score_thresh=thresh)

    frames, gts = _scenes(DET_BATCH, seed=3)
    card = pipeline(torch.float32, "cuda", -1.0)
    cpu = pipeline(torch.float32, "cpu", -1.0)
    four = frames[:4]
    with torch.inference_mode():
        x_card = card.letterbox(torch.from_numpy(four).cuda().float())
        x_cpu = cpu.letterbox(torch.from_numpy(four).float())
        heads = [(a.cpu(), b) for a, b in zip(card.detector(x_card),
                                              cpu.detector(x_cpu))]
    head_err = max((a - b).abs().max().item() for a, b in heads)
    head_excess = max(((a - b).abs() - DET_HEAD_TOL
                       - DET_HEAD_TOL * b.abs()).max().item()
                      for a, b in heads)
    r_card, r_cpu = card.infer_frames(four), cpu.infer_frames(four)
    same = {"letterbox_equal": bool(torch.equal(x_card.cpu(), x_cpu)),
            "boxes_equal": all(np.array_equal(a["box"], b["box"])
                               for a, b in zip(r_card, r_cpu)),
            "labels_equal": all(a["label"] == b["label"]
                                for a, b in zip(r_card, r_cpu)),
            "scores_max_abs_diff": max(abs(a["score"] - b["score"])
                                       for a, b in zip(r_card, r_cpu)),
            "landmarks_max_abs_diff": max(
                int(np.abs(a["landmarks"] - b["landmarks"]).max())
                for a, b in zip(r_card, r_cpu)),
            # one heatmap cell in frame pixels (the crop's side over the
            # heatmap's width, a quarter of the crop's), plus one for the
            # cast to int: an argmax that moves to a neighbouring cell
            # stays within it
            "landmarks_tol": [
                int(max(b["box"][2] - b["box"][0], b["box"][3] - b["box"][1])
                    // (cpu.cls_img_size[1] // 4) + 1) for b in r_cpu]}
    check(same["letterbox_equal"], "card letterbox == CPU letterbox")
    check(head_excess <= 0, f"card vs CPU detector heads: {head_err}")
    check(same["boxes_equal"] and same["labels_equal"],
          f"card vs CPU boxes and labels: {same}")
    check(same["scores_max_abs_diff"] <= DET_HEAD_TOL
          and all(np.abs(a["landmarks"] - b["landmarks"]).max() <= tol
                  for a, b, tol in zip(r_card, r_cpu,
                                       same["landmarks_tol"])),
          f"card vs CPU scores and landmarks: {same}")

    bf16 = pipeline(torch.bfloat16, "cuda")
    x16 = torch.from_numpy(frames).cuda()
    ms = cuda_time_ms(torch, lambda: bf16.run(x16), iters=20, warmup=3)
    results = bf16.infer_frames(frames)
    t0 = time.perf_counter()
    for _ in range(5):
        results = bf16.infer_frames(frames)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    profile = _device_profile(torch, lambda: bf16.run(x16))
    check(profile["kernels_per_call"] > 0, "the profile saw the device")
    hits = _hits(results, gts)
    check(hits >= DET_HIT_SHARE * DET_BATCH,
          f"bf16 pipeline localized {hits} of {DET_BATCH} hands")
    for r in results:
        check(r is None or (r["landmarks"].shape == (21, 2)
                            and 0 <= r["label"] < 19), "bf16 results")
    emit({"detect": {
        "frame_hw": list(FRAME_HW), "det_img_size": bf16.det_img_size,
        "cls_img_size": list(bf16.cls_img_size),
        "f32_card_vs_cpu": {"frames": len(four),
                            "heads_max_abs_err": head_err,
                            "tol": DET_HEAD_TOL, **same},
        "bf16_batch": DET_BATCH, "bf16_ms_per_batch_device": ms,
        "bf16_frames_per_s_device": DET_BATCH / ms * 1e3,
        "bf16_ms_per_batch_host": host_ms,
        "bf16_frames_per_s_host": DET_BATCH / host_ms * 1e3,
        "bf16_profile": profile,
        "bf16_hits": hits, "hit_iou": DET_HIT_IOU,
        "forwards": card.batches + bf16.batches,
    }})
    return card.batches + bf16.batches


def detect_http_phase(torch) -> int:
    """POST /detect through the serving CLI's own build functions and HTTP
    handler (bf16, --det_weight the repository's detector, --det_max_batch
    DET_BATCH): DET_HTTP_FRAMES synthetic frames, every other one a PIL
    JPEG and the rest .npy, from DET_CLIENTS client threads. Every answer
    is 200 and localizes its hand in at least DET_HIT_SHARE of the frames.
    Returns the classifier forwards the server ran on the card."""
    from hgr_tpu_torch.cli import serve as cli_serve

    here = os.path.dirname(os.path.abspath(__file__))
    args = cli_serve.build_parser().parse_args(
        ["--det_weight", os.path.join(here, DET_WEIGHTS),
         "--det_max_batch", str(DET_BATCH), "--frame_hw", *map(str, FRAME_HW)])
    service = cli_serve.build_service(args)
    detector = httpd = None
    try:
        detector = cli_serve.build_detector_service(args, service)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    cli_serve.make_handler(service, detector))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        frames, gts = _scenes(DET_HTTP_FRAMES, seed=5)
        bodies = [_jpeg(f) if i % 2 == 0 else _npy(f)
                  for i, f in enumerate(frames)]
        answers = [None] * len(bodies)
        latency = [0.0] * len(bodies)
        errors = []

        def client(c):
            try:
                for i in range(c, len(bodies), DET_CLIENTS):
                    t = time.perf_counter()
                    req = urllib.request.Request(
                        f"{base}/detect", data=bodies[i], method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        answers[i] = (r.status, json.loads(r.read()))
                    latency[i] = time.perf_counter() - t
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(DET_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        seconds = time.perf_counter() - t0
        check(not errors and all(not t.is_alive() for t in threads),
              f"detect clients: {errors[:1]}")
        check(all(a is not None and a[0] == 200 for a in answers),
              "every /detect answered 200")
        dets = [a[1]["detection"] for a in answers]
        for d in dets:
            check(d is None or (len(d["box"]) == 4
                                and np.asarray(d["landmarks"]).shape
                                == (21, 2)), "/detect answer shape")
        hits = [d is not None and _iou(d["box"], g) > DET_HIT_IOU
                for d, g in zip(dets, gts)]
        check(sum(hits) >= DET_HIT_SHARE * len(hits),
              f"/detect localized {sum(hits)} of {len(hits)} hands")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        check(stats["detect"]["requests"] == len(bodies)
              and stats["detect"]["errors"] == 0, f"/stats: {stats}")
        lat_ms = np.asarray(latency) * 1e3
        emit({"detect_http": {
            "frames": len(bodies), "clients": DET_CLIENTS,
            "jpeg_frames": len(bodies[::2]), "seconds": seconds,
            "frames_per_s": len(bodies) / seconds,
            "client_latency_ms": {"p50": float(np.percentile(lat_ms, 50)),
                                  "p99": float(np.percentile(lat_ms, 99))},
            "server_latency_ms": stats["detect"].get("latency_ms"),
            "batch_hist": stats["detect"]["batch_hist"],
            "hits": int(sum(hits)), "jpeg_hits": int(sum(hits[::2])),
            "npy_hits": int(sum(hits[1::2])),
        }})
        return service.forwards + detector.pipeline.batches
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if detector is not None:
            detector.stop()
        service.stop()


def video_phase(torch, work: str) -> int:
    """``hgr_tpu_torch.cli.detect`` on a directory of VIDEO_FRAMES JPEG
    frames (bf16, 8 frames a batch) into an mp4v video, read back with
    cv2. Returns the classifier forwards it ran on the card."""
    import cv2

    from hgr_tpu_torch.cli import detect as cli_detect

    here = os.path.dirname(os.path.abspath(__file__))
    frames_dir = os.path.join(work, "detect_frames")
    os.makedirs(frames_dir, exist_ok=True)
    frames, _ = _scenes(VIDEO_FRAMES, seed=7)
    for i, f in enumerate(frames):
        with open(os.path.join(frames_dir, f"{i:04d}.jpg"), "wb") as fh:
            fh.write(_jpeg(f))
    cfg = os.path.join(work, "detect_data.yaml")
    with open(cfg, "w") as fh:
        fh.write("num_joints: 21\nnum_classes: 19\n")
    out = os.path.join(work, "detect.mp4")
    batch_frames = 8
    args = cli_detect.build_parser().parse_args(
        ["--data_config", cfg, "--det_weight",
         os.path.join(here, DET_WEIGHTS), "--data_path", frames_dir,
         "--save_path", out, "--batch_frames", str(batch_frames)])
    pipeline = cli_detect.build_pipeline(args)
    t0 = time.perf_counter()
    n = cli_detect.run(args, pipeline)
    seconds = time.perf_counter() - t0
    cap = cv2.VideoCapture(out)
    read = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        check(frame.shape == (360, 640, 3), f"video frame {frame.shape}")
        read += 1
    cap.release()
    check(n == read == VIDEO_FRAMES, f"video frames {n} written, {read} read")
    emit({"detect_video": {"frames": n, "seconds": seconds,
                           "frames_per_s": n / seconds,
                           "bytes": os.path.getsize(out),
                           "forwards": pipeline.batches,
                           "cv2": cv2.__version__}})
    return pipeline.batches


def _calib_crops(n: int, seed: int):
    """``n`` seeded synthetic 192 px uint8 BGR hand crops."""
    from hgr_tpu_torch.data.synthetic import make_hand_image

    rng = np.random.RandomState(seed)
    return np.stack([make_hand_image(rng, IMAGE)[0] for _ in range(n)])


def _conv_inputs(torch, model, x):
    """One forward of ``model`` on ``x``: its logits, and (name, ConvBnAct,
    int8 input) of every quantized conv, the input quantized as the
    branch does."""
    from hgr_tpu_torch.models.layers import ConvBnAct

    seen = []

    def hook(name):
        def record(mod, inputs):
            q = mod.quant
            seen.append((name, mod, torch.clamp(torch.round(
                inputs[0].float() / q.act_scale), -127, 127).to(torch.int8)))
        return record

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules()
               if isinstance(m, ConvBnAct) and m.quant is not None]
    try:
        with torch.inference_mode():
            logits = model(x, need_attnmap=False)[0]
    finally:
        for h in handles:
            h.remove()
    return logits, seen


def _int8_bound(convs, batch: int) -> dict:
    """The least time of the int8 backbone's convs at ``batch`` as one
    fused implicit-GEMM kernel each would have it: the bf16 input read
    once, the output written once, the int8 weights once, against
    2·M·K·N int8 operations at the int8 peak."""
    nbytes = ops = 0
    for _name, mod, xq in convs:
        k, _, cin, cout = mod.quant.kernel_q.shape
        s, p = mod.conv.stride, mod.conv.padding
        _, h, w, _ = xq.shape
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        nbytes += batch * (h * w * cin + ho * wo * cout) * INT8_IO_BYTES \
            + k * k * cin * cout
        ops += 2 * batch * ho * wo * k * k * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_PEAK_OPS * 1e3
    return {"bytes": nbytes, "int8_ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def quant_phase(torch, state, work: str, cfg, loop_save: str) -> dict:
    """int8 PTQ on the card (``infer/quant.py``), MultiTaskNet small at 192
    px, calibrated on QUANT_CALIB seeded synthetic crops through the
    serving CLI's ``quantize_from_crops``: (a) every quantized conv's
    int32 accumulators, card vs CPU vs the plain version, on the same int8
    input; (b) the int8 f32 forward, card vs CPU, on QUANT_CHECK crops;
    (c) bf16 and int8 forwards at QUANT_BATCHES by CUDA events, peak
    memory and device kernels a call; (d) int8 serving under the serve
    phase's load; (e) ``tools.quant_bench`` on the loop phase's
    checkpoint and synthetic split. Returns the forwards on the card and
    the warp calls that the code below makes, which main holds the launch
    counts to."""
    from hgr_tpu_torch.infer.quant import (
        CALIB_BATCH,
        normalize_crops,
        quantize_from_crops,
    )
    from hgr_tpu_torch.infer.weights import build_classifier
    from hgr_tpu_torch.models.layers import ConvBnAct
    from hgr_tpu_torch.ops.int8_conv import conv_int8, conv_int8_reference
    from hgr_tpu_torch.tools import quant_bench
    from hgr_tpu_torch.train.checkpoint import best_or_last

    calib_forwards = -(-QUANT_CALIB // CALIB_BATCH)
    forwards = 0
    calib = os.path.join(work, "calib.npy")
    np.save(calib, _calib_crops(QUANT_CALIB, seed=11))
    check_x = normalize_crops(_calib_crops(QUANT_CHECK, seed=12))
    result = {"calibration_crops": QUANT_CALIB}

    def quantized(dtype):
        model = build_classifier(state, (IMAGE, IMAGE), dtype, device="cuda")
        t0 = time.perf_counter()
        quantize_from_crops(model, calib)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    served, result["bf16_quantize_seconds"] = quantized(torch.bfloat16)
    forwards += calib_forwards
    n_quant = sum(isinstance(m, ConvBnAct) and m.quant is not None
                  for m in served.modules())
    check(n_quant == 22, f"{n_quant} quantized convs, expected 22")

    # (a) the int32 accumulators of every conv, on the same int8 input
    _, convs = _conv_inputs(torch, served, torch.from_numpy(check_x).cuda())
    forwards += 1
    check(len(convs) == 22, f"{len(convs)} conv inputs recorded")
    acc_rows = []
    for name, mod, xq in convs:
        args = (mod.quant.kernel_q, mod.conv.stride, mod.conv.padding)
        card = conv_int8(xq, *args)
        cpu = conv_int8(xq.cpu(), *(a.cpu() if torch.is_tensor(a) else a
                                    for a in args))
        plain = conv_int8_reference(xq, *args)
        torch.cuda.synchronize()
        same = (torch.equal(card.cpu(), cpu)
                and torch.equal(card, plain))
        check(same, f"int8 conv {name}: card, CPU and plain accumulators "
                    "differ")
        acc_rows.append({"conv": name, "input": list(xq.shape),
                         "kernel": list(mod.quant.kernel_q.shape),
                         "same_bits": same})
    result["accumulators_card_cpu_plain"] = {
        "convs": len(acc_rows), "all_same_bits": all(
            r["same_bits"] for r in acc_rows), "batch": QUANT_CHECK}

    # (b) the whole int8 forward in f32, card vs CPU
    f32_card, _ = quantized(torch.float32)
    f32_cpu = build_classifier(f32_card.state_dict(), (IMAGE, IMAGE),
                               torch.float32, device="cpu")
    x_cpu = torch.from_numpy(check_x)
    lc, codes_card = _conv_inputs(torch, f32_card, x_cpu.cuda())
    lp, codes_cpu = _conv_inputs(torch, f32_cpu, x_cpu)
    forwards += calib_forwards + 1  # the CPU's forward launches nothing
    lc = lc.cpu()
    moved = sum(int((a[2].cpu() != b[2]).sum())
                for a, b in zip(codes_card, codes_cpu))
    err = (lc - lp).abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    disagree = (lc.argmax(-1) != lp.argmax(-1))
    unexplained = int((disagree & (top2[:, 0] - top2[:, 1] > err)).sum())
    check(err <= INT8_MODEL_TOL and unexplained == 0,
          f"int8 f32 forward card vs CPU: {err}, {unexplained} argmax "
          "changes beyond the logits' difference")
    result["f32_card_vs_cpu"] = {
        "crops": QUANT_CHECK, "max_abs_err_logits": err,
        "tol": INT8_MODEL_TOL, "argmax_agree": int((~disagree).sum()),
        "int8_codes_moved": moved,
        "int8_codes": sum(int(c[2].numel()) for c in codes_cpu)}
    del f32_card, f32_cpu

    # (c) bf16 against int8 forwards
    float_model = build_classifier(state, (IMAGE, IMAGE), torch.bfloat16,
                                   device="cuda")
    timing = {}
    for b in QUANT_BATCHES:
        x = torch.from_numpy(np.random.RandomState(b).uniform(
            -2.1, 2.6, (b, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
        fns = {name: (lambda m=m: m(x, need_attnmap=False))
               for name, m in (("bf16", float_model), ("int8", served))}
        row = {"ms": {}}
        iters, warmup, profiled = (20 if b <= 64 else 5), 2, 2
        with torch.inference_mode():
            for name in ("bf16", "int8", "int8", "bf16"):
                torch.cuda.reset_peak_memory_stats()
                row["ms"].setdefault(name, []).append(cuda_time_ms(
                    torch, fns[name], iters=iters, warmup=warmup))
                row.setdefault("peak_gib", {})[name] = (
                    torch.cuda.max_memory_allocated() / 2**30)
            for name, fn in fns.items():
                row.setdefault("profile", {})[name] = _device_profile(
                    torch, fn, calls=profiled)
        # four timed turns; a profile makes a warm call before its calls
        forwards += 4 * (iters + warmup) + len(fns) * (profiled + 1)
        row["crops_per_s"] = {n: b / float(np.mean(v)) * 1e3
                              for n, v in row["ms"].items()}
        row["int8_convs_fused_bound"] = _int8_bound(convs, b)
        timing[f"b{b}"] = row
        del x
    result["forward"] = timing
    emit({"quant": result})

    # (d) int8 serving under the serve phase's load
    forwards += serve_phase(torch, state, model=served, line="quant_serve")

    # (e) the accuracy cost on the loop phase's checkpoint: one calibration
    # batch, the float and the int8 eval (a warm call each, then every
    # batch; the warp crops each batch), the two timed forwards
    ckpt = best_or_last(loop_save)
    calib_batches, eval_batch = 1, 256
    bench = quant_bench.run(quant_bench.build_parser().parse_args(
        ["--workdir", os.path.join(work, "quantbench"), "--weights", ckpt,
         "--calib_batches", str(calib_batches), "--eval_batch",
         str(eval_batch), "--bench_batch", "256", "--device", "cuda"]), cfg)
    check(0.0 <= bench["test_f1_int8"] <= 1.0
          and 0.0 <= bench["test_f1_float"] <= 1.0
          and bench["test_images"] == LOOP_SPLITS[2][1],
          f"quant_bench {bench}")
    emit({"quant_bench": bench})
    eval_batches = -(-bench["test_images"] // eval_batch)
    forwards += (calib_batches + 2 * (eval_batches + 1)
                 + 2 * (quant_bench.TIME_ITERS + quant_bench.TIME_WARMUP))
    return {"forwards": forwards, "warps": calib_batches + 2 * eval_batches}


def export_phase(torch, state, work: str, cfg, loop_save: str) -> dict:
    """``torch.export`` on the card (``infer/export.py``): the f32 and bf16
    2-output forwards at batch 1 and 64 and the int8 model at 64, each
    saved, loaded (the attention operator a node of the graph), held
    against the eager forward; eager vs loaded times at 64; then
    ``hgr_tpu_torch.cli.export`` on the loop phase's checkpoint and
    synthetic test split (pt2, its F1 against the eager eval's) and
    ``--format onnx`` from the same weights, parsed by the port's reader.
    Returns the forwards on the card and the warp calls that the code
    below makes (tracing runs no kernel), which main holds the launch
    counts to."""
    from hgr_tpu_torch.cli import export as cli_export
    from hgr_tpu_torch.infer.quant import (
        CALIB_BATCH,
        normalize_crops,
        quantize_from_crops,
    )
    from hgr_tpu_torch.infer.export import (
        eval_exported,
        export_program,
        load_program,
        make_inference_fn,
        program_ops,
        split_loader,
    )
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        load_classifier_weights,
    )
    from hgr_tpu_torch.train.checkpoint import best_or_last
    from hgr_tpu_torch.utils.onnx_reader import load_onnx_graph

    attn_op = "hgr_tpu_torch.attention_qkv_fwd.default"
    rows, forwards = [], 0
    for kind, dtype, batches in (("float32", torch.float32, (1, 64)),
                                 ("bfloat16", torch.bfloat16, (1, 64)),
                                 ("int8", torch.bfloat16, (64,))):
        model = build_classifier(state, (IMAGE, IMAGE), dtype, device="cuda")
        if kind == "int8":
            quantize_from_crops(model, os.path.join(work, "calib.npy"))
            forwards += -(-QUANT_CALIB // CALIB_BATCH)
        eager = make_inference_fn(model)
        for b in batches:
            path = os.path.join(work, f"export_{kind}_b{b}.pt2")
            t0 = time.perf_counter()
            export_program(model, path, batch=b)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_program(path)
            load_s = time.perf_counter() - t0
            ops = program_ops(loaded)
            check(ops.get(attn_op) == 4,
                  f"{kind} b{b}: the loaded graph holds {ops.get(attn_op)} "
                  "attention nodes, expected 4")
            x = torch.from_numpy(normalize_crops(_calib_crops(b, seed=20 + b))
                                 ).cuda()
            with torch.inference_mode():
                want, got = eager(x), loaded(x)
            forwards += 2
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            # the same operators on the same inputs: the same bits
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            check(same, f"{kind} b{b}: loaded vs eager differ by {err}")
            row = {"model": kind, "batch": b, "export_s": export_s,
                   "load_s": load_s, "bytes": os.path.getsize(path),
                   "attention_nodes": ops[attn_op],
                   "int_mm_nodes": ops.get("aten._int_mm.default", 0),
                   "same_bits": same, "max_abs_err": err}
            if b == 64:
                t = {"eager": [], "loaded": []}
                iters, warmup = 20, 3
                with torch.inference_mode():
                    for name in ("eager", "loaded", "loaded", "eager"):
                        fn = eager if name == "eager" else loaded
                        t[name].append(cuda_time_ms(
                            torch, lambda fn=fn: fn(x), iters=iters,
                            warmup=warmup))
                forwards += 4 * (iters + warmup)
                row["ms"] = t
            rows.append(row)
    emit({"export": rows})

    # the export CLI on the loop phase's checkpoint and test split
    ckpt = best_or_last(loop_save)
    yaml_path = os.path.join(work, "export_data.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"path: {cfg.path}\ntrain: {cfg.train}\nval: {cfg.val}\n"
                f"test: {cfg.test}\nnum_joints: {cfg.num_joints}\n"
                f"num_classes: {cfg.num_classes}\n")
    out = os.path.join(work, "cli_export.pt2")
    t0 = time.perf_counter()
    res = cli_export.main(["--data_config", yaml_path, "--weight_path", ckpt,
                           "--out", out, "--batch", str(CLI_EXPORT_BATCH),
                           "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    loop_state = load_classifier_weights(ckpt)
    eager = eval_exported(
        make_inference_fn(build_classifier(loop_state, (IMAGE, IMAGE),
                                           torch.float32, device="cuda")),
        split_loader(cfg, cfg.test, CLI_EXPORT_BATCH), cfg.num_classes,
        (IMAGE, IMAGE), "cuda")
    check(res["images"] == eager["images"] == LOOP_SPLITS[2][1]
          and res["test_f1"] == eager["test_f1"],
          f"cli.export eval {res} vs the eager eval {eager}")
    # each eval: a warm call, then every batch (the warp crops each)
    eval_batches = -(-res["images"] // CLI_EXPORT_BATCH)
    forwards += 2 * (eval_batches + 1)
    onnx = os.path.join(work, "cli_export.onnx")
    cli_export.main(["--data_config", yaml_path, "--weight_path", ckpt,
                     "--out", onnx, "--format", "onnx", "--skip_eval",
                     "--device", "cuda"])
    graph = load_onnx_graph(onnx)
    check(graph.inputs == {"input": (1, 3, IMAGE, IMAGE)}
          and graph.outputs == {"label_pred": (1, 19),
                                "heatmap_pred": (1, 21, IMAGE // 4,
                                                 IMAGE // 4)},
          f"onnx signature {graph.inputs} {graph.outputs}")
    inits = [t.to_numpy() for t in graph.initializers.values()]

    def present(a):
        return any(b.shape == a.shape and np.array_equal(b, a)
                   for b in inits)

    missing = [k for k, t in loop_state.items()
               if not k.endswith((".bn.weight", ".bn.var"))
               and not (present(t.numpy()) or (t.dim() == 2
                                               and present(t.numpy().T)))]
    check(not missing, f"onnx initializers miss {missing[:3]}")
    emit({"export_cli": {
        "checkpoint": os.path.relpath(ckpt, work), "pt2": {
            "test_f1": res["test_f1"], "eager_test_f1": eager["test_f1"],
            "images": res["images"],
            "mean_latency_s_per_image": res["mean_latency_s"],
            "eager_mean_latency_s_per_image": eager["mean_latency_s"],
            "seconds": cli_s},
        "onnx": {"bytes": os.path.getsize(onnx), "inputs": graph.inputs,
                 "outputs": graph.outputs,
                 "nodes": len(graph.nodes),
                 "initializers": len(graph.initializers),
                 "state_dict_entries_found": len(loop_state)
                 - len(missing)}}})
    return {"forwards": forwards, "warps": 2 * eval_batches}


def detector_train_phase(torch, state, work: str) -> int:
    """Main path 9, detector training: YOLOv7-tiny at 416 px, the
    published widths, bf16, B = DET_TRAIN_BATCH, Adam 1e-3, through the
    train step of ``tools/train_detector_smoke.py`` for DET_TRAIN_STEPS
    steps on a pool of DET_TRAIN_POOL seeded ``make_scene`` batches: ms
    per step and frames/s by CUDA events, peak memory, the loss falling,
    best-box IoU on DET_EVAL fresh scenes, the weights written as the JAX
    tool writes them and read back equal, and ``HandGesturePipeline``
    driven by them on this path's 360x640 scenes, beside the readings of
    the JAX tool's trained weights (DET_WEIGHTS) on the same scenes and
    frames. Then an f32 B = 2 step on the card against the CPU. Returns
    the classifier forwards both pipelines ran (the only kernel launches
    of the path)."""
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.models.yolo import YOLOv7Tiny
    from hgr_tpu_torch.tools import train_detector_smoke as tool

    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    pool = [tuple(torch.from_numpy(a).cuda() for a in tool.make_batch(
        rng, DET_TRAIN_BATCH, 416)) for _ in range(DET_TRAIN_POOL)]
    pool_s = time.perf_counter() - t0
    model = YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    n_vars = sum(v.numel() for v in model.state_dict().values())
    check(n_vars == DET_VARIABLES, f"YOLOv7-tiny variables {n_vars}")
    step = tool.make_detector_train_step(model, tool.adam(
        model.parameters(), 1e-3))
    losses = []
    warm = 5
    for i in range(warm):
        losses.append(step(*pool[i % DET_TRAIN_POOL])[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    for i in range(warm, DET_TRAIN_STEPS):
        losses.append(step(*pool[i % DET_TRAIN_POOL])[0])
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - h0
    timed = DET_TRAIN_STEPS - warm
    ms = start.elapsed_time(end) / timed
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), "finite detector losses")
    last = float(np.mean(losses[-20:]))
    check(last < 0.5 * losses[0],
          f"detector loss fell: {losses[0]} -> last 20 mean {last}")
    frames, gts = tool.make_batch(np.random.RandomState(999), DET_EVAL, 416)
    boxes, scores = tool.best_boxes(model, torch.from_numpy(frames).cuda())
    ious = tool.iou_xyxy(boxes, tool.cxcywh_to_xyxy(gts))
    profile = _device_profile(torch, lambda: step(*pool[0]))

    # the weights as the JAX tool writes them, read back
    path = os.path.join(work, "det_train", "yolo_smoke_weights.npz")
    tool.save_detector_npz(model, path)
    det_state = load_detector_weights(path)
    rounded = {k: v.detach().cpu().half().float()
               for k, v in model.state_dict().items()}
    check(all(torch.equal(det_state[k], rounded[k]) for k in rounded)
          and det_state.keys() == rounded.keys(),
          "the .npz holds the model's variables (float16)")
    loaded = YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16)
    loaded.load_state_dict(det_state)
    in_memory = YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16)
    in_memory.load_state_dict(rounded)
    x = torch.from_numpy(frames[:8]).cuda().float() / 255.0
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(
            loaded.cuda().eval()(x), in_memory.cuda().eval()(x)))
    check(same, "the loaded .npz gives the in-memory model's heads")
    del loaded, in_memory

    pipe = HandGesturePipeline(state, det_state, DEFAULT_NAMES,
                               dtype=torch.bfloat16, device="cuda")
    scenes, scene_gts = _scenes(DET_EVAL, seed=5)
    results = _pipeline_results(pipe, scenes)
    hits = _hits(results, scene_gts)
    check(len(results) == DET_EVAL, "the pipeline answered every frame")

    # the JAX tool's trained weights (the committed fixture) on the same
    # eval scenes and pipeline frames: the yardstick of the readings above
    fixture = load_detector_weights(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), DET_WEIGHTS))
    fx_model = YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16)
    fx_model.load_state_dict(fixture)
    fx_boxes, fx_scores = tool.best_boxes(fx_model.cuda(),
                                          torch.from_numpy(frames).cuda())
    fx_ious = tool.iou_xyxy(fx_boxes, tool.cxcywh_to_xyxy(gts))
    fx_pipe = HandGesturePipeline(state, fixture, DEFAULT_NAMES,
                                  dtype=torch.bfloat16, device="cuda")
    fx_results = _pipeline_results(fx_pipe, scenes)
    check(len(fx_results) == DET_EVAL,
          "the fixture's pipeline answered every frame")
    del fx_model

    # an f32 B = 2 step on the card against the CPU (TF32 off), and both
    # against the same step in float64 on the CPU: f32 itself moves this
    # model's gradients by percents at a fresh init (many train-mode BNs
    # in a row), so the card is held to be as near float64 as the CPU is
    f2, g2 = tool.make_batch(np.random.RandomState(7), 2, 416)
    out = {}
    for name, dev, dt in (("cpu", "cpu", torch.float32),
                          ("cuda", "cuda", torch.float32),
                          ("float64", "cpu", torch.float64)):
        m = YOLOv7Tiny(dtype=dt, generator=torch.Generator().manual_seed(1))
        m = m.to(dev, dt)
        out[name] = tool.detector_loss_and_grads(
            m, torch.from_numpy(f2).to(dev),
            torch.from_numpy(g2).to(dev)) + (m.state_dict(),)
    (lc, _, gc, sc), (lp, _, gp, sp) = out["cuda"], out["cpu"]
    g64 = out["float64"][2]
    loss_err = abs(float(lc) - float(lp)) / abs(float(lp))
    grad_errs = {k: _rel(gc[k].cpu(), gp[k]) for k in gp}
    worst = max(grad_errs, key=grad_errs.get)
    def flat(g):
        return torch.cat([g[k].cpu().double().ravel() for k in gp])

    to64 = {"card": _rel(flat(gc), flat(g64)),
            "cpu": _rel(flat(gp), flat(g64))}
    stats_err = max(float(((sc[k].cpu() - sp[k]).abs()
                           / (1.0 + sp[k].abs())).max())
                    for k in sp if k.endswith((".mean", ".var")))
    emit({"detector_train": {
        "model": "YOLOv7-tiny 416 px, published widths, seeded random init",
        "params": n_params, "variables": n_vars, "dtype": "bfloat16",
        "batch": DET_TRAIN_BATCH,
        "pool_batches": DET_TRAIN_POOL, "pool_seconds": pool_s,
        "steps": DET_TRAIN_STEPS, "timed_steps": timed, "lr": 1e-3,
        "ms_per_step": ms, "host_ms_per_step": host_s / timed * 1e3,
        "frames_per_s": DET_TRAIN_BATCH / ms * 1e3,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2**30,
        "step_profile": profile,
        "loss_first": losses[0], "loss_last20_mean": last,
        "eval_scenes": DET_EVAL, "mean_iou": float(ious.mean()),
        "iou_gt_0_5_share": float((ious > 0.5).mean()),
        "npz": os.path.relpath(path, work), "pipeline_hits": hits,
        "pipeline_frames": DET_EVAL, "hit_iou": DET_HIT_IOU,
        "fixture": {"weights": DET_WEIGHTS,
                    "mean_iou": float(fx_ious.mean()),
                    "iou_gt_0_5_share": float((fx_ious > 0.5).mean()),
                    "mean_score": float(fx_scores.mean()),
                    "pipeline_hits": _hits(fx_results, scene_gts)},
        "f32_b2_vs_cpu": {"loss_rel_err": loss_err,
                          "max_rel_grad_err": grad_errs[worst],
                          "worst_tensor": worst,
                          "median_rel_grad_err": float(np.median(
                              list(grad_errs.values()))),
                          "grads_rel_err_to_float64": to64,
                          "stats_max_err": stats_err},
    }})
    check(loss_err <= 1e-4, f"detector step card vs CPU loss: {loss_err}")
    check(to64["card"] <= DET_F64_FACTOR * to64["cpu"]
          and grad_errs[worst] <= DET_GRAD_TOL,
          f"detector step card vs CPU grads: {worst} {grad_errs[worst]}, "
          f"to float64 {to64}")
    check(stats_err <= 1e-4,
          f"detector step card vs CPU stats: {stats_err}")
    return pipe.batches + fx_pipe.batches


# main path 10's configurations (hgr_tpu/cli/train.py flags): model
# constructor fields, the fused BN route (on, as the train line's faster
# turn), the BN chain dtype
PRECISION_PATHS = (
    ("mixed", dict(decoder_dtype="float32"), True, None),
    ("early_dtype_f32", dict(early_dtype="float32"), True, None),
    ("bf16_bn", {}, True, "bfloat16"),
    ("remat", dict(remat=True), True, None),
    ("s2d", dict(stride2_impl="s2d"), True, None),
    ("dense_grad", dict(stride2_impl="dense_grad"), True, None),
)


def _knob_model(torch, kw, dtype="bfloat16", seed=0):
    from hgr_tpu_torch.models import MultiTaskNet

    kw = {k: (getattr(torch, v) if k.endswith("dtype") else v)
          for k, v in kw.items()}
    return MultiTaskNet(image_size=(IMAGE, IMAGE),
                        dtype=getattr(torch, dtype),
                        generator=torch.Generator().manual_seed(seed), **kw)


def _knob_step(torch, fused, bn, fn):
    """Run ``fn`` with the fused BN route and the BN chain dtype set."""
    from hgr_tpu_torch.models import layers

    layers._FUSED_BN = fused
    layers._BN_DTYPE = None if bn is None else getattr(torch, bn)
    try:
        return fn()
    finally:
        layers._FUSED_BN = None
        layers._BN_DTYPE = None


def _grads_of(torch, model, x):
    """Outputs, the de-mixed pair of backwards' summed gradients and the
    running statistics of one train-mode forward of ``model`` on x."""
    cls, hmap, _ = model.train()(x, need_attnmap=False)
    params = [p for _, p in model.named_parameters()]
    g1 = torch.autograd.grad(torch.logsumexp(cls.float(), -1).mean(),
                             params, retain_graph=True, allow_unused=True,
                             materialize_grads=True)
    g2 = torch.autograd.grad(hmap.float().square().mean(), params,
                             allow_unused=True, materialize_grads=True)
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return cls.detach(), hmap.detach(), [a + 1e-3 * b
                                         for a, b in zip(g2, g1)], stats


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-12))


def precision_paths_phase(torch, n_bn: int) -> dict:
    """Main path 10, the classifier's precision and lowering knobs through
    ``make_train_step`` at B = TRAIN_BATCH (MultiTaskNet small 192 px,
    full width, bf16 compute, grad_demix 'auto' -> on): each of
    PRECISION_PATHS for KNOB_WARMUP + KNOB_STEPS steps, ms/step, crops/s,
    peak memory and the launches per step against the code's count. Then
    the checks on the card: remat's running statistics against the plain
    step's, 's2d' and 'dense_grad' against 'plain' (f32, B = 8), and the
    f32 B = 8 'mixed' and 'early_dtype' steps against the CPU."""
    from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
    from hgr_tpu_torch.models.layers import ConvBnAct
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step, resolve_grad_demix

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _staged_batch(TRAIN_BATCH, seed=2).items()}
    rows, totals = [], None
    for name, kw, fused, bn in PRECISION_PATHS:
        mcfg = ModelConfig(compute_dtype="bfloat16",
                           decoder_dtype=kw.get("decoder_dtype"),
                           early_dtype=kw.get("early_dtype"))
        demix = resolve_grad_demix(TrainConfig(), mcfg)
        model = _knob_model(torch, kw)
        if "early_dtype" in kw:
            check(sum(m.dtype == torch.float32 for m in model.modules()
                      if isinstance(m, ConvBnAct)) == EARLY_BN_LAYERS,
                  f"{name}: the early units hold {EARLY_BN_LAYERS} layers")
        chains_f32 = sum(
            1 for m in model.modules() if isinstance(m, ConvBnAct)
            and (m.dtype != torch.bfloat16 or bn is None))
        check(demix is True and sum(isinstance(m, ConvBnAct)
                                    for m in model.modules()) == n_bn,
              f"{name}: grad_demix {demix}")
        state = create_train_state(model, device="cuda")
        step = make_train_step(AugmentConfig(), image_size=(IMAGE, IMAGE),
                               heatmap_size=(IMAGE // 4, IMAGE // 4),
                               grad_demix=demix)
        gen = torch.Generator(device="cuda").manual_seed(0)
        bn_launches = 2 * chains_f32 if fused else 0
        want = {"attention_qkv_fwd": 4, "attention_qkv_bwd": 8,
                "attention_split_fwd": 0, "attention_split_bwd": 0,
                "warp_twopass": 1, "bn_act_reduce": bn_launches,
                "bn_act_elem": bn_launches}

        def run():
            nonlocal state
            losses = []
            for _ in range(KNOB_WARMUP):
                state, m = step(state, batch, gen)
                losses.append(m["total_loss"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0 = _counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(KNOB_STEPS):
                state, m = step(state, batch, gen)
                losses.append(m["total_loss"])
            end.record()
            end.synchronize()
            return (losses, start.elapsed_time(end) / KNOB_STEPS,
                    _delta(_counts(), c0))

        losses, ms, launched = _knob_step(torch, fused, bn, run)
        per_step = {k: v / KNOB_STEPS for k, v in launched.items()}
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{name}: finite losses")
        check(per_step == want,
              f"{name}: launches per step {per_step} != {want}")
        rows.append({"path": name, "fields": kw, "fused_bn": fused,
                     "bn_dtype": bn or "float32", "grad_demix": demix,
                     "ms_per_step": ms,
                     "crops_per_s": TRAIN_BATCH / ms * 1e3,
                     "max_memory_allocated_gib":
                         torch.cuda.max_memory_allocated() / 2**30,
                     "launches_per_step": per_step,
                     "losses_first_last": [losses[0], losses[-1]]})
        del state, model, step
        torch.cuda.empty_cache()
    emit({"precision_paths": {"batch": TRAIN_BATCH, "image": IMAGE,
                              "steps": KNOB_WARMUP + KNOB_STEPS,
                              "rows": rows}})

    # remat: the running statistics are updated once per step, on the card
    x8 = torch.from_numpy(np.random.RandomState(2).randn(
        8, IMAGE, IMAGE, 3).astype(np.float32)).cuda()
    checks = {}
    for fused in (False, True):
        runs = [_knob_step(torch, fused, None, lambda r=r: _grads_of(
            torch, _knob_model(torch, dict(remat=r)).cuda(), x8))
            for r in (False, True)]
        (c0, h0, g0, s0), (c1, h1, g1, s1) = runs
        err = max(float((s1[k] - s0[k]).abs().max()) for k in s0)
        checks[f"remat_stats_fused_{fused}"] = {
            "max_abs_err": err, "outputs_equal": bool(
                torch.equal(c0, c1) and torch.equal(h0, h1)),
            "max_rel_grad_err": max(_rel(a, b) for a, b in zip(g1, g0))}
        check(err <= 1e-5, f"remat stats vs plain (fused {fused}): {err}")
        check(checks[f"remat_stats_fused_{fused}"]["max_rel_grad_err"]
              <= 1e-3, f"remat grads vs plain: {checks}")
    # the stride-2 lowerings against 'plain', f32 on the card
    base = _grads_of(torch, _knob_model(torch, {}, "float32").cuda(), x8)
    for impl in ("s2d", "dense_grad"):
        got = _grads_of(torch, _knob_model(
            torch, dict(stride2_impl=impl), "float32").cuda(), x8)
        errs = [_rel(a, b) for a, b in zip(got[2], base[2])]
        checks[impl] = {"max_rel_grad_err": max(errs),
                        "outputs_rel_err": max(_rel(got[0], base[0]),
                                               _rel(got[1], base[1]))}
        check(max(errs) <= 1e-3 and checks[impl]["outputs_rel_err"] <= 1e-3,
              f"{impl} vs plain on the card: {checks[impl]}")
    emit({"precision_checks": checks})
    for name, kw, fused in (("mixed", dict(decoder_dtype="float32"), False),
                            ("early_dtype", dict(early_dtype="float32"),
                             True)):
        knob_vs_cpu_phase(torch, name, kw, fused, n_bn)
    return {r["path"]: r for r in rows}


def knob_vs_cpu_phase(torch, name: str, kw: dict, fused: bool, n_bn: int):
    """One de-mixed step at B = 8 of a knob's model on the card against the
    CPU (TF32 off, the draw of ``train_vs_cpu_phase``), held as
    KNOB_CPU_TOL says; per-tensor errors are reported, the f32 segment's
    apart."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import layers
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    batch, params = _grid_third_case(torch, 8)
    out, launches = {}, {}
    layers._FUSED_BN = fused
    try:
        with _fixed_draw(params):
            for dev in ("cpu", "cuda"):
                state = create_train_state(_knob_model(torch, kw, seed=1),
                                           device=dev)
                step = make_train_step(
                    AugmentConfig(), image_size=(IMAGE, IMAGE),
                    heatmap_size=(IMAGE // 4, IMAGE // 4), grad_demix=True,
                    debug_return_grads=True, warp_method="kernel")
                c0 = _counts()
                _, out[dev] = step(state, batch, torch.Generator(device=dev))
                torch.cuda.synchronize()
                launches = _delta(_counts(), c0)
    finally:
        layers._FUSED_BN = None
    g_card, g_cpu = out["cuda"]["_grads"], out["cpu"]["_grads"]
    errs = {k: _rel(g_card[k].cpu(), w) for k, w in g_cpu.items()}
    overall = _rel(torch.cat([g_card[k].cpu().ravel() for k in g_cpu]),
                   torch.cat([w.ravel() for w in g_cpu.values()]))
    f32_prefix = ("proj.", "decoder.") if name == "mixed" else (
        "encoder.conv1.", "encoder.conv2.", "encoder.cspelan1.")
    f32 = {k: v for k, v in errs.items() if k.startswith(f32_prefix)}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(out["cuda"]["total_loss"])
                   - float(out["cpu"]["total_loss"]))
    row = {"path": name, "fields": kw, "fused_bn": fused,
           "card_launches": launches, "rel_grad_err": overall,
           "max_rel_grad_err": errs[worst],
           "worst_tensor": worst,
           "median_rel_grad_err": float(np.median(list(errs.values()))),
           "f32_segment_max_rel_grad_err": max(f32.values()),
           "f32_segment_median_rel_grad_err": float(np.median(
               list(f32.values()))),
           "tol": KNOB_CPU_TOL, "f32_tol": KNOB_F32_TOL,
           "loss_abs_err": loss_err,
           "loss": float(out["cpu"]["total_loss"])}
    emit({"knob_b8_vs_cpu": row})
    want_bn = 2 * n_bn if fused else 0
    check(launches["attention_qkv_bwd"] == 8
          and launches["bn_act_reduce"] == want_bn,
          f"{name} card step launches {launches}")
    check(overall <= KNOB_CPU_TOL, f"{name} card vs CPU step grads: {row}")
    check(name != "mixed" or max(f32.values()) <= KNOB_F32_TOL,
          f"{name} card vs CPU f32 decoder grads: {row}")
    check(loss_err <= KNOB_LOSS_TOL * abs(row["loss"]),
          f"{name} card vs CPU step loss: {loss_err}")


def _tool_quiet():
    """The tools print their own progress; keep chip_smoke's stdout to its
    JSON lines (the progress goes to stderr)."""
    import contextlib

    return contextlib.redirect_stdout(sys.stderr)


def serve_bench_phase(torch, work: str) -> dict:
    """``tools/serve_bench`` at SB_REQUESTS requests from SB_CLIENTS
    clients, max_batch SB_MAX_BATCH, pipeline depth SB_DEPTH, bf16, seeded
    random weights: per-request crops, ``--device_pool`` and
    ``--quantize``, each from launch counts at 0. Each run's attention
    launches equal 4 x the forwards it made (warm-up, ceiling, load and
    calibration). Returns the launch counts of the three runs summed."""
    from hgr_tpu_torch.tools import serve_bench

    total, rows = {}, {}
    for name, extra in (("per_request", []),
                        ("device_pool", ["--device_pool"]),
                        ("quantized", ["--quantize"])):
        args = serve_bench.build_parser().parse_args(
            ["--requests", str(SB_REQUESTS), "--clients", str(SB_CLIENTS),
             "--max_batch", str(SB_MAX_BATCH), "--pipeline_depth",
             str(SB_DEPTH), "--out",
             os.path.join(work, f"serve_bench_{name}.json")] + extra)
        _zero_counts()
        with _tool_quiet():
            result, forwards = serve_bench.run(args)
        counts = _counts()
        check(counts["attention_qkv_fwd"] == 4 * forwards and forwards > 0,
              f"serve_bench {name}: attention launches {counts} != 4 x "
              f"{forwards} forwards")
        check(result["requests"] == SB_REQUESTS and result["errors"] == 0
              and result["achieved_rps"] > 0 and "latency_ms" in result,
              f"serve_bench {name}: {result}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rows[name] = {
            "crops_per_s": result["achieved_rps"],
            "latency_ms": result["latency_ms"],
            "bare_fwd_crops_s": result["bare_fwd_crops_s"],
            "batcher_overhead_pct": result["batcher_overhead_pct"],
            "batch_hist": result["batch_hist"], "batches": result["batches"],
            "wall_s": result["wall_s"], "forwards": forwards}
    emit({"serve_bench": {"requests": SB_REQUESTS, "clients": SB_CLIENTS,
                          "max_batch": SB_MAX_BATCH,
                          "pipeline_depth": SB_DEPTH, "dtype": "bfloat16",
                          "runs": rows}})
    return total


def video_bench_phase(torch, work: str) -> dict:
    """``tools/video_bench``: VB_FRAMES JPEG frames of VB_HW through
    ``detect_to_video`` at batch VB_BATCH, serial (depth 1) and overlapped
    (depth 3), and the decode floor; bf16, seeded random weights. The
    attention launches equal 4 x the pipeline's batches."""
    from hgr_tpu_torch.tools import video_bench

    args = video_bench.build_parser().parse_args(
        ["--frames", str(VB_FRAMES), "--h", str(VB_HW[0]), "--w",
         str(VB_HW[1]), "--batch", str(VB_BATCH), "--workdir",
         os.path.join(work, "video_bench")])
    _zero_counts()
    with _tool_quiet():
        result, batches = video_bench.run(args)
    counts = _counts()
    check(counts["attention_qkv_fwd"] == 4 * batches and batches > 0,
          f"video_bench: attention launches {counts} != 4 x {batches} "
          "batches")
    check(result["frames"] == VB_FRAMES and result["serial_fps"] > 0
          and result["overlapped_fps"] > 0, f"video_bench: {result}")
    emit({"video_bench": {**result, "frame_hw": list(VB_HW),
                          "batches": batches, "dtype": "bfloat16"}})
    return counts


def attribution_phase(torch, n_bn: int) -> dict:
    """``tools/fwd_attribution`` at B = FWD_ATTR_BATCH and
    ``tools/bwd_attribution`` at the train step's B = BWD_ATTR_BATCH with
    HGR_TPU_FUSED_BN off and on, ATTR_ITERS timed calls each; every
    derived figure with the graphs it came from. Launches held to the
    graphs' calls: 4 attention forwards a model forward, 4 backwards a
    model backward, 2 x n_bn bn launches a backbone backward with fused
    BN (none in eval mode or without a backbone backward)."""
    from hgr_tpu_torch.tools import bwd_attribution, fwd_attribution

    fwd_args = fwd_attribution.build_parser().parse_args(
        ["--batch", str(FWD_ATTR_BATCH), "--iters", str(ATTR_ITERS)])
    _zero_counts()
    with _tool_quiet():
        res = fwd_attribution.run(fwd_args)
    fwd_counts = _counts()
    calls = fwd_attribution.calls(fwd_args)
    check(fwd_counts["attention_qkv_fwd"] == 4 * calls
          and sum(fwd_counts.values()) == 4 * calls,
          f"fwd_attribution launches {fwd_counts}, {calls} full forwards")
    graphs = {k: res[k] for k in ("full", "bb", "bb_proj", "pose", "cls")}
    check(all(np.isfinite(v) and v > 0 for v in graphs.values()),
          f"fwd_attribution times {graphs}")
    emit({"fwd_attribution": {
        "batch": FWD_ATTR_BATCH, "iters": ATTR_ITERS, "graphs_ms": graphs,
        "derived_ms": {
            "proj": {"ms": res["derived_proj"], "from": "bb_proj - bb"},
            "transformer": {"ms": res["derived_transformer_glue"],
                            "from": "full - bb_proj - pose - cls"}},
        "crops_per_s_full": res["crops_per_s_full"],
        "launches": fwd_counts}})

    total = dict(fwd_counts)
    bwd_args = bwd_attribution.build_parser().parse_args(
        ["--batch", str(BWD_ATTR_BATCH), "--iters", str(ATTR_ITERS)])
    calls = bwd_attribution.calls(bwd_args)
    for route in ("off", "on"):
        os.environ["HGR_TPU_FUSED_BN"] = route
        try:
            _zero_counts()
            with _tool_quiet():
                res = bwd_attribution.run(bwd_args)
            counts = _counts()
        finally:
            os.environ.pop("HGR_TPU_FUSED_BN")
        bn = 2 * n_bn * calls if route == "on" else 0
        # model forwards: fwd_loss, grad_full, grad_head, grad_evalbn;
        # model backwards: the three grad_ graphs; backbone backwards with
        # batch statistics: grad_full, grad_bb
        check(counts["attention_qkv_fwd"] == 4 * 4 * calls
              and counts["attention_qkv_bwd"] == 4 * 3 * calls
              and counts["bn_act_reduce"] == counts["bn_act_elem"] == bn
              and counts["warp_twopass"] == 0,
              f"bwd_attribution (fused BN {route}) launches {counts}, "
              f"{calls} calls a graph, {n_bn} ConvBnAct layers")
        graphs = {k: res[k] for k in ("fwd_loss", "grad_full", "fwd_bb",
                                      "grad_bb", "grad_head", "grad_evalbn")}
        check(all(np.isfinite(v) and v > 0 for v in graphs.values()),
              f"bwd_attribution times {graphs}")
        emit({"bwd_attribution": {
            "batch": BWD_ATTR_BATCH, "iters": ATTR_ITERS, "fused_bn": route,
            "graphs_ms": graphs,
            "derived_ms": {name.replace("derived: ", ""):
                           {"ms": res[name], "from": f"{a} - {b}"}
                           for name, a, b in bwd_attribution.DERIVED},
            "launches": counts}})
        for k, v in counts.items():
            total[k] += v
    return total


def bn_ab_phase(torch, n_bn: int, work: str) -> dict:
    """``tools/bn_convergence_ab`` at a tiny recipe (BN_AB_RECIPE) with
    HGR_TPU_FUSED_BN=on inherited by both arms: each arm is the training
    CLI in a process of its own, which writes its launch counts; the f32
    arm takes the fused route (2 x n_bn bn launches a step), the bf16-BN
    arm none; in both, 8 attention backwards a step, and 4 attention
    forwards and one warp a step or evaluation batch (the loaders pad the
    tail batch, so every batch is at the train batch, the shapes the
    kernel phases check). Returns the two arms' counts summed."""
    from hgr_tpu_torch.tools import bn_convergence_ab

    out = os.path.join(work, "bn_ab", "out")
    os.environ["HGR_TPU_FUSED_BN"] = "on"
    try:
        with _tool_quiet():
            summary = bn_convergence_ab.main(
                BN_AB_RECIPE + ["--workdir", os.path.join(work, "bn_ab"),
                                "--out", out])
    finally:
        os.environ.pop("HGR_TPU_FUSED_BN")
    rec = {k: int(v) for k, v in zip(BN_AB_RECIPE[::2], BN_AB_RECIPE[1::2])}
    steps = rec["--epochs"] * -(-rec["--train_n"] // rec["--batch"])
    # validation every epoch, then one test pass
    evals = (rec["--epochs"] * -(-rec["--val_n"] // rec["--batch"])
             + -(-rec["--test_n"] // rec["--batch"]))
    total, arms = {}, {}
    for name in ("f32", "bf16"):
        with open(os.path.join(out, f"{name}.json")) as f:
            arm = json.load(f)
        counts = arm["launches"]
        bn = 2 * n_bn * steps if name == "f32" else 0
        check(arm["steps"] == steps and len(arm["epochs"]) ==
              rec["--epochs"] and 0.0 <= arm["test_f1"] <= 1.0,
              f"bn_convergence_ab {name}: {arm}")
        check(counts["attention_qkv_bwd"] == 8 * steps
              and counts["attention_qkv_fwd"] == 4 * (steps + evals)
              and counts["warp_twopass"] == steps + evals
              and counts["bn_act_reduce"] == counts["bn_act_elem"] == bn,
              f"bn_convergence_ab {name} launches {counts} for {steps} "
              f"steps and {evals} evaluation batches of {n_bn} ConvBnAct "
              "layers")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        arms[name] = {"test_f1": arm["test_f1"],
                      "final_val": arm["epochs"][-1], "launches": counts}
    emit({"bn_convergence_ab": {"recipe": summary["recipe"],
                                "fused_bn": "on", "steps": steps,
                                "eval_batches": evals, "arms": arms}})
    return total


def h2h_phase(torch, work: str) -> dict:
    """``tools/headtohead`` at a tiny recipe B (H2H_RECIPE) through the
    training CLI in a process of its own, which writes its launch counts,
    then ``tools/h2h_stats`` over that run and the committed finals of
    the reference and the JAX package. The run has a test row; its
    launches are 8 attention backwards a step, and 4 attention forwards
    and one warp a step or evaluation batch (the loaders pad the tail
    batch), no bn launch (fused BN off, the CLI default); each statistic
    of one seed has a finite mean and interval (sd and t need two).
    Returns the run's counts."""
    from hgr_tpu_torch.tools import h2h_stats, headtohead

    root = os.path.join(work, "h2h")
    workdir = os.path.join(root, "s42")
    args = headtohead.build_parser().parse_args(H2H_RECIPE)
    t0 = time.perf_counter()
    with _tool_quiet():
        summary = headtohead.main(H2H_RECIPE + ["--workdir", workdir])
        stats = h2h_stats.main(["--r5_glob", os.path.join(root, "s*"),
                                "--out", os.path.join(root, "stats.json")])
    seconds = time.perf_counter() - t0
    steps = args.epochs * -(-args.train_n // args.batch_size)
    evals = (args.epochs * -(-args.val_n // args.batch_size)
             + -(-args.test_n // args.batch_size))
    with open(os.path.join(workdir, "ours_out", headtohead.RUN_NAME,
                           "ranks", "rank0.json")) as f:
        ran = json.load(f)
    counts = ran["launches"]
    rows = headtohead.read_jsonl(os.path.join(
        workdir, "ours_logs", headtohead.RUN_NAME, "metrics.jsonl"))
    tests = [r for r in rows if "test/epoch_f1" in r]
    check(ran["step"] == steps and len(tests) == 1
          and 0.0 <= tests[0]["test/epoch_f1"] <= 1.0
          and 0.0 <= tests[0]["test/pose_acc"] <= 1.0,
          f"headtohead ran {ran['step']} steps (expected {steps}), test "
          f"rows {tests}")
    check(counts["attention_qkv_bwd"] == 8 * steps
          and counts["attention_qkv_fwd"] == 4 * (steps + evals)
          and counts["warp_twopass"] == steps + evals
          and sum(counts.values()) == 13 * steps + 5 * evals,
          f"headtohead launches {counts} for {steps} steps and {evals} "
          "evaluation batches")
    for side in ("port_minus_ref", "port_minus_jax"):
        for metric in ("f1", "pose"):
            st = stats[side][metric]
            check(st["n"] == 1 and np.isfinite(st["mean"])
                  and all(np.isfinite(v) for v in st["boot95_ci"]),
                  f"h2h_stats {side} {metric}: {st}")
    emit({"h2h": {"recipe": H2H_RECIPE, "steps": steps,
                  "eval_batches": evals, "seconds": seconds,
                  "ours": summary["ours"], "seeds": stats["seeds"],
                  "port_minus_ref": stats["port_minus_ref"],
                  "port_minus_jax": stats["port_minus_jax"],
                  "launches": counts}})
    return counts


def hagrid_fit_phase(torch) -> dict:
    """``tools/hagrid_fit`` at HAGRID_N rows, canvas 192: the virtual mode
    (HAGRID_VIRTUAL; the tool asserts its invariants: equal shard bytes,
    each at most 1.01 x nominal, blocks of B / 8 rows making up the global
    batch, every gathered row and every written boundary row as written),
    then the chip mode (HAGRID_CHIP): the whole split's ballast beside the
    B = 1024 remat step in two microbatches, whose first rung must fit
    with a finite loss. The virtual mode launches no kernel; each
    microbatch of the chip mode's 1 + iters steps launches 4 attention
    forwards, 8 backwards and one warp, nothing else (fused BN off).
    Returns the counts."""
    from hgr_tpu_torch.tools import hagrid_fit

    t0 = time.perf_counter()
    with _tool_quiet():
        virtual = hagrid_fit.main(HAGRID_VIRTUAL)
        chip = hagrid_fit.main(HAGRID_CHIP)
    seconds = time.perf_counter() - t0
    counts = _counts()
    check(virtual["row_bytes"] == 110880 and virtual["batches_iterated"] == 3
          and virtual["batch_canvas_shape"] == [256, IMAGE, IMAGE, 3]
          and virtual["boundary_rows_checked"] > 0,
          f"hagrid_fit virtual: {virtual}")
    rung = chip["ladder"][0]
    check(len(chip["ladder"]) == 1 and rung["fits"]
          and np.isfinite(rung["loss"]), f"hagrid_fit chip: {chip}")
    micro = rung["steps"] * rung["grad_accum"]
    check(counts["attention_qkv_fwd"] == 4 * micro
          and counts["attention_qkv_bwd"] == 8 * micro
          and counts["warp_twopass"] == micro
          and sum(counts.values()) == 13 * micro,
          f"hagrid_fit launches {counts} for {micro} microbatches")
    emit({"hagrid_fit": {"seconds": seconds, "virtual": virtual,
                         "chip": chip, "launches": counts}})
    return counts


def _fallback_ops(torch, fn) -> list:
    """The operators the legacy vmap runs as a loop over the rows while
    ``fn`` runs (torch's fallback warnings, switched on around it)."""
    import warnings

    torch._C._debug_only_display_vmap_fallback_warnings(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch._C._debug_only_display_vmap_fallback_warnings(False)
    found = (re.search(r"batching rule for ([\w:.]+)", str(w.message))
             for w in caught)
    return sorted({m.group(1).rstrip(".") for m in found if m})


def _demix_grads(torch, dtype: str, demix, fused: bool, b: int):
    """The pre-update gradients and loss of one step of a seeded model on
    the card (B = ``b`` of the train phase's batch, one seeded draw)."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    layers._FUSED_BN = fused
    try:
        model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                             dtype=getattr(torch, dtype),
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, device="cuda")
        step = make_train_step(AugmentConfig(), image_size=(IMAGE, IMAGE),
                               heatmap_size=(IMAGE // 4, IMAGE // 4),
                               grad_demix=demix, debug_return_grads=True)
        batch = {k: torch.from_numpy(v[:b]).cuda()
                 for k, v in _staged_batch(TRAIN_BATCH, seed=2).items()}
        _, m = step(state, batch, torch.Generator(device="cuda")
                    .manual_seed(0))
        torch.cuda.synchronize()
    finally:
        layers._FUSED_BN = None
    return m["_grads"], float(m["total_loss"]), step.batched_backwards


def batched_phase(torch, n_bn: int) -> dict:
    """Main path 15, the batched de-mixed step (``grad_demix='batched'``):
    the CLI default model (bf16 MultiTaskNet small 192 px, B = TRAIN_BATCH
    staged canvases), fused BN off and on, in BATCHED_TURNS of the batched
    and the two-pullback step (TURN_WARMUP + TURN_STEPS steps each):
    ms/step, crops/s and peak memory per arm, the launches per step held
    to the code's count, and ``batched_backwards`` to the batched steps
    taken. One untimed batched step lists the operators the legacy vmap
    loops over. Then the gradients: batched against two pullbacks on the
    card (DEMIX_TOL of each tensor's norm, the JAX package's tolerances;
    the loss to 1e-6), bf16 at B = TRAIN_BATCH and f32 at B = DEMIX_F32_B,
    fused BN off and on, and the f32 B = 8 batched step card vs CPU.
    Returns the launches of the timed turns."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _staged_batch(TRAIN_BATCH, seed=2).items()}
    rows, fallback = [], None
    for fused in (False, True):
        layers._FUSED_BN = fused
        try:
            model = MultiTaskNet(image_size=(IMAGE, IMAGE),
                                 dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
            state = create_train_state(model, device="cuda")
            steps = {arm: make_train_step(
                AugmentConfig(), image_size=(IMAGE, IMAGE),
                heatmap_size=(IMAGE // 4, IMAGE // 4),
                grad_demix="batched" if arm == "batched" else True)
                for arm in ("batched", "pullbacks")}
            gen = torch.Generator(device="cuda").manual_seed(0)
            bn = 2 * n_bn if fused else 0
            want = {"attention_qkv_fwd": 4, "attention_qkv_bwd": 8,
                    "attention_split_fwd": 0, "attention_split_bwd": 0,
                    "warp_twopass": 1, "bn_act_reduce": bn,
                    "bn_act_elem": bn}
            if fallback is None:
                def one():
                    nonlocal state
                    state, _ = steps["batched"](state, batch, gen)
                fallback = _fallback_ops(torch, one)
            turns, losses = [], []
            before = steps["batched"].batched_backwards
            for arm in BATCHED_TURNS:
                step = steps[arm]
                for _ in range(TURN_WARMUP):
                    state, m = step(state, batch, gen)
                    losses.append(m["total_loss"])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
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
                check(per_step == want,
                      f"batched path, fused BN {fused}, {arm}: launches "
                      f"per step {per_step} != {want}")
                ms = start.elapsed_time(end) / TURN_STEPS
                turns.append({"arm": arm, "ms_per_step": ms,
                              "host_ms_per_step": wall / TURN_STEPS * 1e3,
                              "crops_per_s": TRAIN_BATCH / ms * 1e3,
                              "max_memory_allocated_gib":
                                  torch.cuda.max_memory_allocated() / 2**30})
            taken = steps["batched"].batched_backwards - before
            want_taken = (BATCHED_TURNS.count("batched")
                          * (TURN_WARMUP + TURN_STEPS))
            check(taken == want_taken
                  and steps["pullbacks"].batched_backwards == 0,
                  f"batched backwards {taken} != {want_taken} batched "
                  "steps")
            losses = [float(x) for x in losses]
            check(all(np.isfinite(losses)), f"finite losses: {losses}")
        finally:
            layers._FUSED_BN = None
        arms = {}
        for arm in ("batched", "pullbacks"):
            mine = [t for t in turns if t["arm"] == arm]
            arms[arm] = {
                "ms_per_step": float(np.mean([t["ms_per_step"]
                                              for t in mine])),
                "crops_per_s": float(np.mean([t["crops_per_s"]
                                              for t in mine])),
                "max_memory_allocated_gib": max(
                    t["max_memory_allocated_gib"] for t in mine)}
        rows.append({"fused_bn": fused, "turns": turns, "arms": arms,
                     "batched_over_pullbacks_step_time":
                         arms["batched"]["ms_per_step"]
                         / arms["pullbacks"]["ms_per_step"],
                     "batched_backwards": taken,
                     "launches_per_step": want,
                     "losses_first_last": [losses[0], losses[-1]]})
        del state, model, steps
        torch.cuda.empty_cache()
    counts = _counts()
    emit({"batched_demix": {
        "model": "MultiTaskNet small 192x192, bf16, seeded random weights",
        "batch": TRAIN_BATCH, "canvas": CANVAS, "turns": BATCHED_TURNS,
        "steps_per_turn": TURN_WARMUP + TURN_STEPS, "rows": rows,
        "legacy_vmap_loops_over": fallback, "launches": counts}})

    grads = []
    for dtype, b in (("bfloat16", TRAIN_BATCH), ("float32", DEMIX_F32_B)):
        for fused in (False, True):
            g0, l0, _ = _demix_grads(torch, dtype, True, fused, b)
            g1, l1, taken = _demix_grads(torch, dtype, "batched", fused, b)
            errs = {k: float((g1[k] - a).norm() / a.norm().clamp_min(1e-6))
                    for k, a in g0.items()}
            worst = max(errs, key=errs.get)
            grads.append({"dtype": dtype, "batch": b, "fused_bn": fused,
                          "max_rel_grad_err": errs[worst],
                          "worst_tensor": worst,
                          "median_rel_grad_err": float(np.median(
                              list(errs.values()))),
                          "tol": DEMIX_TOL[dtype], "loss": l0,
                          "loss_rel_err": abs(l1 - l0) / abs(l0)})
            check(taken == 1, f"{dtype} batched step took {taken}")
            check(errs[worst] <= DEMIX_TOL[dtype]
                  and grads[-1]["loss_rel_err"] <= 1e-6,
                  f"batched vs two pullbacks on the card: {grads[-1]}")
    emit({"batched_demix_grads": grads})
    for fused in (False, True):
        train_vs_cpu_phase(torch, fused=fused, n_bn=n_bn, demix="batched",
                           line="batched_f32_b8_vs_cpu")
    return counts


def debug_images_phase(torch, work: str, cfg) -> dict:
    """Main path 16, ``--debug_images`` through the CLI's ``run`` on the
    loop phase's dataset (bf16, B = TRAIN_BATCH, fused BN off, 1 epoch):
    the dump files must be the JAX loop's (4 of the train batch after
    every debug_every-th step, 5 of the first val batch after the epoch),
    and the launches the run's own (every step, evaluation and test
    batch) plus the dumps': each dump is one eval-step batch (1 warp),
    whose forward is 4 fused attention layers for a train dump and 3 plus
    the unfused last layer for a val dump. Each dump's wall seconds (its
    eval step and its files, from a synchronized card) are timed by
    wrapping the loop's two dump hooks, and set against the epoch."""
    from hgr_tpu_torch.cli import train as cli
    from hgr_tpu_torch.config import TrainConfig
    from hgr_tpu_torch.train import loop

    n_train, n_val, n_test = (n for _, n in LOOP_SPLITS)
    steps = -(-n_train // TRAIN_BATCH)
    evals = -(-n_val // TRAIN_BATCH) + -(-n_test // TRAIN_BATCH)
    every = TrainConfig().debug_every
    dumps = [i + 1 for i in range(steps) if i % every == 0]
    kinds = ("gt", "pred", "hm_gt", "hm_pred")
    want_files = ({f"train_{s}_{k}.jpg" for s in dumps for k in kinds}
                  | {f"val_0_{k}.jpg" for k in kinds + ("attn",)})
    argv = ["--data_config", "(a DataConfig built by chip_smoke.py)",
            "--batch_size", str(TRAIN_BATCH), "--canvas_size", str(CANVAS),
            "--image_size", str(IMAGE), str(IMAGE), "--dtype", "bfloat16",
            "--seed", "0", "--num_workers", "8", "--device", "cuda",
            "--epochs", "1", "--debug_images", "--suffix", "debug",
            "--save_dir", os.path.join(work, "debug_out"),
            "--log_dir", os.path.join(work, "debug_logs")]
    dump_s, make_dumps = [], loop._debug_dumps

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            dump_s.append(time.perf_counter() - t)
        return run

    loop._debug_dumps = lambda *a: tuple(map(timed, make_dumps(*a)))
    try:
        t0 = time.perf_counter()
        state, save = cli.run(cli.parse_args(argv), cfg)
        seconds = time.perf_counter() - t0
    finally:
        loop._debug_dumps = make_dumps
    counts = _counts()
    files = sorted(os.listdir(os.path.join(save, "debug")))
    want = {"attention_qkv_fwd": 4 * (steps + evals) + 4 * len(dumps) + 3,
            "attention_qkv_bwd": 8 * steps, "attention_split_fwd": 0,
            "attention_split_bwd": 0,
            "warp_twopass": steps + evals + len(dumps) + 1,
            "bn_act_reduce": 0, "bn_act_elem": 0}
    with open(os.path.join(work, "debug_logs", os.path.basename(save),
                           "metrics.jsonl")) as f:
        epoch = [json.loads(x) for x in f if '"epoch"' in x][0]
    emit({"debug_images": {
        "steps": steps, "debug_every": every, "train_dumps_at": dumps,
        "files": files, "seconds": seconds, "dump_seconds": dump_s,
        "dumps_s": sum(dump_s),
        "train_time_s": epoch["train_time_s"],
        "epoch_time_s": epoch["epoch_time_s"],
        "bytes": sum(os.path.getsize(os.path.join(save, "debug", f))
                     for f in files), "launches": counts}})
    check(state.step == steps, f"debug run ended at step {state.step}")
    check(len(dump_s) == len(dumps) + 1, f"timed dumps {dump_s}")
    check(set(files) == want_files,
          f"debug files {files} != the JAX loop's {sorted(want_files)}")
    check(counts == want, f"debug run launches {counts} != {want}")
    return counts


def display_data_phase(torch, cfg) -> dict:
    """Main path 17, ``tools/display_data`` on the card: the loop phase's
    train split, the tool's default batch (DISPLAY_BATCH, whose warp
    warp_kernel_phase holds against its plain version), one batch: 32
    sheets and one warp launch."""
    from hgr_tpu_torch.tools.display_data import build_parser, display_data

    args = build_parser().parse_args([])
    out_dir = os.path.join(os.path.dirname(cfg.path), "display_out")
    t0 = time.perf_counter()
    n = display_data(cfg, out_dir, batch_size=args.batch_size,
                     num_batches=args.num_batches, device=args.device)
    seconds = time.perf_counter() - t0
    counts = _counts()
    files = os.listdir(out_dir)
    emit({"display_data": {"batch": args.batch_size, "written": n,
                           "files": len(files), "seconds": seconds,
                           "launches": counts}})
    check(n == len(files) == args.batch_size == DISPLAY_BATCH,
          f"display_data wrote {n} sheets, {len(files)} files")
    check(counts["warp_twopass"] == 1 and sum(counts.values()) == 1,
          f"display_data launches {counts}")
    return counts


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "hgr_tpu_torch")):
        # the script alone, without the checkout it drives
        print("chip_smoke: no hgr_tpu_torch package beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
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
    rows.update(split_kernel_phase(torch))
    c2_kernel_phase(torch)
    c2_wider_phase(torch)
    route_phase(torch)
    single_path = [k for k in KERNELS if "split" not in k]

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
    for name in single_path:
        check(trained[name] > 0, f"the train step launched {name}")
    train_vs_cpu_phase(torch, fused=False, n_bn=n_bn)
    train_vs_cpu_phase(torch, fused=True, n_bn=n_bn)

    # main path 3, training from files through the CLI
    work, cfg, write_s = write_dataset()
    _zero_counts()
    looped, loop_save = loop_phase(torch, n_bn, work, cfg, write_s)
    for name in single_path:
        check(looped[name] > 0, f"the training loop launched {name}")

    # main path 4, multi-rank training through the CLI: the counts live in
    # the ranks' processes, which start at 0 and write them beside the run
    _zero_counts()
    meshed, tp_save = mesh_phase(torch, n_bn, work, cfg)
    for name in KERNELS:
        check(meshed[name] > 0, f"the multi-rank runs launched {name}")
    mesh_checks_phase(torch, tp_save, work)

    # main path 5, C2's lengths and widths: 448 px bf16 and 320 px f32
    # train steps, bf16 steps with 256- and 384-wide heads, the 448 px
    # serving forward
    _zero_counts()
    longer = long_path_phase(torch, n_bn)
    for name in single_path:
        check(longer[name] > 0, f"the 448 / 320 px paths launched {name}")

    # main path 6, two-stage detection: the pipeline, POST /detect and
    # the video CLI (the classifier's attention forward, 4 a forward)
    _zero_counts()
    forwards = detect_phase(torch, state)
    forwards += detect_http_phase(torch)
    forwards += video_phase(torch, work)
    detected = _counts()
    check(detected["attention_qkv_fwd"] == 4 * forwards,
          f"detect attention launches {detected} != 4 x {forwards} "
          "forwards")
    check(detected["attention_qkv_fwd"] > 0,
          "the detect path launched the attention kernel")

    # main path 7, int8 serving: the serving CLI's calibration, the int8
    # forward, ClassifierService, quant_bench's eval (attention forward;
    # the warp kernel crops the eval split)
    _zero_counts()
    made = quant_phase(torch, state, work, cfg, loop_save)
    quanted = _counts()
    check(quanted["attention_qkv_fwd"] == 4 * made["forwards"]
          and quanted["warp_twopass"] == made["warps"],
          f"int8 path launches {quanted} != 4 x {made['forwards']} "
          f"forwards, {made['warps']} warps")
    for name in ("attention_qkv_fwd", "warp_twopass"):
        check(quanted[name] > 0, f"the int8 path launched {name}")

    # main path 8, export: torch.export programs, loaded and run, and the
    # export CLI's eval through the loaded program (attention forward in
    # f32 and bf16, the warp in the eval's crops)
    _zero_counts()
    made = export_phase(torch, state, work, cfg, loop_save)
    exported = _counts()
    check(exported["attention_qkv_fwd"] == 4 * made["forwards"]
          and exported["warp_twopass"] == made["warps"],
          f"export path launches {exported} != 4 x {made['forwards']} "
          f"forwards, {made['warps']} warps")
    for name in ("attention_qkv_fwd", "warp_twopass"):
        check(exported[name] > 0, f"the export path launched {name}")

    # main path 9, detector training (plain torch ops: no TPU kernel on
    # the detector) and its weights driving the pipeline, whose
    # classifier launches the attention forward, 4 a forward
    _zero_counts()
    forwards = detector_train_phase(torch, state, work)
    det_trained = _counts()
    check(det_trained["attention_qkv_fwd"] == 4 * forwards
          and sum(det_trained.values()) == 4 * forwards and forwards > 0,
          f"detector training path launches {det_trained}, {forwards} "
          "pipeline forwards")

    # main path 10, the classifier's precision and lowering knobs through
    # make_train_step (f32 attention under --dtype mixed, f32 bn kernels
    # in the early units)
    _zero_counts()
    precision_paths_phase(torch, n_bn)
    knobbed = _counts()
    for name in single_path:
        check(knobbed[name] > 0,
              f"the precision knobs' steps launched {name}")

    # main paths 11-14, the measurement tools: serve_bench (per-request,
    # device pool, int8), video_bench, the forward and backward
    # attribution (fused BN off and on), bn_convergence_ab's two arms
    _zero_counts()
    benched = serve_bench_phase(torch, work)
    check(benched["attention_qkv_fwd"] > 0,
          "serve_bench launched the attention kernel")
    _zero_counts()
    videoed = video_bench_phase(torch, work)
    _zero_counts()
    attributed = attribution_phase(torch, n_bn)
    for name in single_path:
        check(attributed[name] > 0 or name == "warp_twopass",
              f"the attribution tools launched {name}")
    _zero_counts()
    ab = bn_ab_phase(torch, n_bn, work)
    for name in single_path:
        check(ab[name] > 0, f"bn_convergence_ab's arms launched {name}")

    # main path 15, the batched de-mixed step, fused BN off and on, in
    # turns with the two-pullback step (the backward kernels once per
    # cotangent row, through their operators)
    _zero_counts()
    batched = batched_phase(torch, n_bn)
    for name in single_path:
        check(batched[name] > 0, f"the batched de-mixed path launched {name}")

    # main path 16, --debug_images through the training CLI
    _zero_counts()
    debugged = debug_images_phase(torch, work, cfg)

    # main path 17, tools/display_data on the card (the warp kernel)
    _zero_counts()
    displayed = display_data_phase(torch, cfg)

    # main path 18, a model axis that does not divide the heads (three
    # ranks on the card): the packed attention kernels over every head of
    # the gathered qkv; the counts live in the ranks' processes
    _zero_counts()
    uneven = uneven_tp_phase(torch, n_bn, work)
    for name in single_path:
        check(uneven[name] > 0, f"the model=3 mesh launched {name}")

    # main path 19, --device_cache with --grad_accum under {data: 2}
    # through the CLI (the rows exchanged between the ranks' caches)
    _zero_counts()
    accumed = cache_accum_phase(torch, n_bn, work, cfg)
    for name in single_path:
        check(accumed[name] > 0,
              f"the cached accumulating mesh launched {name}")

    # main path 20, the head-to-head tools: headtohead's tiny recipe B
    # through the training CLI (its counts live in its process), then
    # h2h_stats over it and the committed finals
    _zero_counts()
    h2h = h2h_phase(torch, work)
    for name in ("attention_qkv_fwd", "attention_qkv_bwd", "warp_twopass"):
        check(h2h[name] > 0, f"headtohead's run launched {name}")

    # main path 21, the serving CLI's build_service on the loop phase's
    # checkpoint with no --image_size: the crop size of its run_meta.json
    from hgr_tpu_torch.train.checkpoint import best_or_last

    _zero_counts()
    forwards = serve_phase(torch, None, line="serve_checkpoint",
                           weights=best_or_last(loop_save))
    checkpointed = _counts()
    check(checkpointed["attention_qkv_fwd"] == 4 * forwards > 0
          and sum(checkpointed.values()) == 4 * forwards,
          f"checkpoint serving launches {checkpointed} != 4 x {forwards} "
          "forwards")

    # main path 22, tools/hagrid_fit: the sharded device cache at canvas
    # 192 shard by shard, then its ballast beside the remat step
    _zero_counts()
    fitted = hagrid_fit_phase(torch)
    for name in ("attention_qkv_fwd", "attention_qkv_bwd", "warp_twopass"):
        check(fitted[name] > 0, f"hagrid_fit's chip mode launched {name}")

    by_path = {"serve": served, "train": trained, "loop": looped,
               "mesh": meshed, "long": longer, "detect": detected,
               "quant": quanted, "export": exported,
               "det_train": det_trained, "knobs": knobbed,
               "serve_bench": benched, "video_bench": videoed,
               "attribution": attributed, "bn_convergence_ab": ab,
               "batched_demix": batched, "debug_images": debugged,
               "display_data": displayed, "uneven_tp": uneven,
               "cache_accum": accumed, "h2h": h2h,
               "serve_checkpoint": checkpointed, "hagrid_fit": fitted}
    emit({"launches_by_path": {name: {p: c[name] for p, c in by_path.items()}
                               for name in KERNELS}})
    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"hgr_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": sum(c[name] for c in by_path.values()),
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
    } for name, (source, replaces) in KERNELS.items()]})
    emit({"chip_smoke_seconds": time.perf_counter() - started})
    # the run used one card, whatever the host holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
