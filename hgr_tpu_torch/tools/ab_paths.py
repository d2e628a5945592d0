"""Serving forward and train steps of two checkouts, in turns, on one card.

Each checkout runs its own ``chip_smoke.py`` phases in a process of its
own, with its own kernels built from its own sources: the bf16 forward
at the serving batch (B = 64), the train step at B = 256 with fused BN
off and on, the ``--dtype mixed`` step at B = 256 (bf16 compute, the
f32 decoder: the f32 attention kernels, fused BN on), and the 448 px
path (N = 785: the key-chunked attention route): the bf16 train step at
B = 64 and the serving forward at B = 64, and the long paths' wide-head
step (2 heads x 256 at 192 px, B = 64). The checkouts run
in the order given, then in reverse, so a parent and a change compare
within one call:

    python -m hgr_tpu_torch.tools.ab_paths build/parent . [--bits-only |
        --compile-only]

First each checkout's attention kernels, bn kernels and warp run on the
same seeded inputs and the outputs are compared bit for bit
(``same_bits``; values, so a uint8 crop equals an f32 crop of the same
levels), each with its time; the f32 attention cases and the cases of
head widths above 256 (``wide_*``: the bodies of route 2, bf16 and f32),
whose bits a change of arithmetic moves by design, also report the
largest difference between the two sides and each side's distance from
float64 (``f32``); then each attention entry function's ptxas line on
either side and whether its SASS is the same (``compile``, with
``narrow_same_sass``: whether every entry outside the route-2 bodies kept
its SASS). Needs the card. Prints each run's model, train and mixed
lines, then one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# one side: the checkout's own chip_smoke phases (argv[1] = checkout)
_SIDE = """
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from hgr_tpu_torch.utils.cuda_build import load_kernels
load_kernels(list(cs.SOURCES))
layers = cs._path_bn_layers(torch)
from hgr_tpu_torch.infer.weights import load_classifier_weights
state = load_classifier_weights("", (cs.IMAGE, cs.IMAGE), seed=0)
cs._zero_counts()
cs.model_phase(torch, state)
cs._zero_counts()
cs.train_phase(torch, len(layers))
# the --dtype mixed step (bf16 compute, f32 decoder) at B = 256, fused BN
# on, as chip_smoke's precision_paths row: 2 warm-up steps, 6 timed
import json
from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.models import layers as L
from hgr_tpu_torch.train.state import create_train_state
from hgr_tpu_torch.train.steps import make_train_step
state = create_train_state(cs._knob_model(torch, dict(
    decoder_dtype="float32")), device="cuda")
step = make_train_step(AugmentConfig(), image_size=(cs.IMAGE, cs.IMAGE),
                       heatmap_size=(cs.IMAGE // 4, cs.IMAGE // 4),
                       grad_demix=True)
batch = {k: torch.from_numpy(v).cuda()
         for k, v in cs._staged_batch(cs.TRAIN_BATCH, seed=2).items()}
gen = torch.Generator(device="cuda").manual_seed(0)
L._FUSED_BN = True
for _ in range(2):
    state, m = step(state, batch, gen)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(6):
    state, m = step(state, batch, gen)
end.record()
end.synchronize()
print(json.dumps({"mixed": {"batch": cs.TRAIN_BATCH,
                            "ms_per_step": start.elapsed_time(end) / 6,
                            "loss": float(m["total_loss"])}}))
# the 448 px path (N = 785, the key-chunked attention route), as
# chip_smoke's long paths build it: the bf16 train step at B = 64 (CLI
# defaults: de-mixed pullbacks, fused BN off), 2 warm-up steps and 6
# timed, and the bf16 serving forward at B = 64
from hgr_tpu_torch.config import ModelConfig, TrainConfig
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.train.steps import resolve_grad_demix
px = cs.LONG_BF16
del state, step, batch
torch.cuda.empty_cache()
L._FUSED_BN = None
model = MultiTaskNet(image_size=(px, px), dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
state = create_train_state(model, device="cuda")
step = make_train_step(AugmentConfig(), image_size=(px, px),
                       heatmap_size=(px // 4, px // 4),
                       grad_demix=resolve_grad_demix(
                           TrainConfig(), ModelConfig(
                               compute_dtype="bfloat16")))
batch = {k: torch.from_numpy(v).cuda() for k, v in cs._staged_batch(
    cs.LONG_BF16_BATCH, seed=7, canvas=px + 64).items()}
held = [state]
def one_step():
    held[0], _ = step(held[0], batch, gen)
step_ms = cs.cuda_time_ms(torch, one_step, iters=6, warmup=2)
del state, held, step, batch
model = MultiTaskNet(image_size=(px, px), dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0)
                     ).eval().to("cuda")
x = torch.randn(cs.SERVE_BATCH, px, px, 3, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(8))
with torch.inference_mode():
    fwd_ms = cs.cuda_time_ms(torch, lambda: model(x, need_attnmap=False),
                             iters=10, warmup=2)
print(json.dumps({"long448": {"batch": cs.LONG_BF16_BATCH,
                              "step_ms": step_ms,
                              "serve_batch": cs.SERVE_BATCH,
                              "forward_ms": fwd_ms}}))
# the long paths' wide-head step: the model with 2 heads x 256 (every
# attention kernel at padded width 256), a bf16 step at 192 px, B = 64,
# CLI defaults, fused BN off; 2 warm-up steps and 6 timed
del model, x
torch.cuda.empty_cache()
px = cs.IMAGE
model = MultiTaskNet(image_size=(px, px), dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0),
                     **cs.WIDE_HEADS)
state = create_train_state(model, device="cuda")
step = make_train_step(AugmentConfig(), image_size=(px, px),
                       heatmap_size=(px // 4, px // 4),
                       grad_demix=resolve_grad_demix(
                           TrainConfig(), ModelConfig(
                               compute_dtype="bfloat16")))
batch = {k: torch.from_numpy(v).cuda() for k, v in cs._staged_batch(
    cs.LONG_BF16_BATCH, seed=7, canvas=px + 64).items()}
held = [state]
wide_ms = cs.cuda_time_ms(torch, one_step, iters=6, warmup=2)
print(json.dumps({"wide256": {"batch": cs.LONG_BF16_BATCH, "image": px,
                              "heads_x_head_dim": [cs.WIDE_HEADS["heads"],
                                                   cs.WIDE_HEADS[
                                                       "head_dim"]],
                              "step_ms": wide_ms}}))
"""


# one side's attention kernel outputs at fixed seeded inputs (argv[2] =
# output file): the bf16 bodies at the main path's shapes and at 448 px's
# N = 785, which must keep their bits, and the f32 bodies at the serving
# and training shapes (with each output's distance from float64)
_BITS = """
import os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
from hgr_tpu_torch.ops import attention as A
out, calls = {}, {}
# (and at head widths 16 and 64, 768 features: the bodies at Dp = 16, 64,
# the key-chunked ones at (64, 785) and (16, 785) also on split operands)
for b, n, dh in ((64, 145, 32), (256, 145, 32), (64, 785, 32),
                 (64, 145, 16), (64, 785, 16), (64, 145, 64), (64, 785, 64),
                 (16, 785, 16), (16, 785, 64)):
    gen = torch.Generator(device="cuda").manual_seed(
        b * 1000 + n + (dh if dh != 32 else 0))
    qkv = torch.randn(b, n, 768, device="cuda", generator=gen).to(
        torch.bfloat16)
    g = torch.randn(b, n, 256, device="cuda", generator=gen).to(
        torch.bfloat16)
    key = f"{b}_{n}" if dh == 32 else f"{b}_{n}_d{dh}"
    calls[f"fwd_{key}"] = (lambda qkv=qkv, dh=dh: A.fused_attention_qkv(
        qkv, 256 // dh, dh, dh ** -0.5))
    calls[f"bwd_{key}"] = (lambda qkv=qkv, g=g, dh=dh:
                           A.fused_attention_qkv_bwd(qkv, g, 256 // dh, dh,
                                                     dh ** -0.5))
    if n == 785 and dh != 32:
        calls[f"split_fwd_{key}"] = (
            lambda qkv=qkv, dh=dh: A.fused_attention_split(
                *qkv.chunk(3, dim=-1), 256 // dh, dh, dh ** -0.5))
# 2 heads of 128, 192 and 256 (the ring bodies at padded widths 128 and
# 256) at (16, 785) and (64, 145), forward and backward, packed and split
for b, n in ((16, 785), (64, 145)):
    for dh in (128, 192, 256):
        gen = torch.Generator(device="cuda").manual_seed(b * 1000 + n + dh)
        qkv = torch.randn(b, n, 6 * dh, device="cuda", generator=gen).to(
            torch.bfloat16)
        g = torch.randn(b, n, 2 * dh, device="cuda", generator=gen).to(
            torch.bfloat16)
        key = f"{b}_{n}_2x{dh}"
        calls[f"fwd_{key}"] = (lambda qkv=qkv, dh=dh: A.fused_attention_qkv(
            qkv, 2, dh, dh ** -0.5))
        calls[f"bwd_{key}"] = (lambda qkv=qkv, g=g, dh=dh:
                               A.fused_attention_qkv_bwd(qkv, g, 2, dh,
                                                         dh ** -0.5))
        calls[f"split_fwd_{key}"] = (
            lambda qkv=qkv, dh=dh: A.fused_attention_split(
                *qkv.chunk(3, dim=-1), 2, dh, dh ** -0.5))
        calls[f"split_bwd_{key}"] = (
            lambda qkv=qkv, g=g, dh=dh: torch.cat(
                A.fused_attention_split_bwd(*qkv.chunk(3, dim=-1), g, 2, dh,
                                            dh ** -0.5), dim=-1))
# the f32 bodies at the serving and training shapes, and their distance
# from the float64 plain version of the same inputs
f64 = {}
for b, seed in ((64, 32), (256, 33)):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x32 = torch.randn(b, 145, 768, device="cuda", generator=gen)
    g32 = torch.randn(b, 145, 256, device="cuda", generator=gen)
    calls[f"fwd_{b}_145_f32"] = (lambda x32=x32: A.fused_attention_qkv(
        x32, 8, 32, 32 ** -0.5))
    calls[f"bwd_{b}_145_f32"] = (lambda x32=x32, g32=g32:
                                 A.fused_attention_qkv_bwd(x32, g32, 8, 32,
                                                           32 ** -0.5))
    f64[f"fwd_{b}_145_f32"] = A.attention_qkv_reference(
        x32.double(), 8, 32, 32 ** -0.5)
    f64[f"bwd_{b}_145_f32"] = A.attention_qkv_bwd_reference(
        x32.double(), g32.double(), 8, 32, 32 ** -0.5)
# the bodies of head widths above 256 (route 2), 2 heads: the earlier (4, n)
# shapes, the full-card shapes and the 2 x 384 step's, bf16 and f32, with
# each output's distance from the float64 plain version
for b, n, dh in ((4, 145, 320), (4, 785, 512), (64, 145, 512),
                 (16, 785, 512), (64, 145, 384)):
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(b + n + dh)
        x = torch.randn(b, n, 6 * dh, device="cuda", generator=gen).to(dt)
        gw = torch.randn(b, n, 2 * dh, device="cuda", generator=gen).to(dt)
        key = f"wide_{b}_{n}_{dh}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
        calls[f"fwd_{key}"] = (lambda x=x, dh=dh: A.fused_attention_qkv(
            x, 2, dh, dh ** -0.5))
        calls[f"bwd_{key}"] = (lambda x=x, gw=gw, dh=dh:
                               A.fused_attention_qkv_bwd(x, gw, 2, dh,
                                                         dh ** -0.5))
        f64[f"fwd_{key}"] = A.attention_qkv_reference(x.double(), 2, dh,
                                                      dh ** -0.5)
        f64[f"bwd_{key}"] = A.attention_qkv_bwd_reference(
            x.double(), gw.double(), 2, dh, dh ** -0.5)
# the fused jitter + warp at the training shape (B = 256 uint8 canvases,
# 256 -> 192, half the images jittered), through the wrapper, at 0 and 90
# degrees (the transpose route)
from hgr_tpu_torch.ops import warp_fused as W
from hgr_tpu_torch.ops.affine import build_affine
for rot in (0.0, 90.0):
    gen = torch.Generator(device="cuda").manual_seed(int(rot) + 1)
    canvas = torch.randint(0, 256, (256, 256, 256, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    m = build_affine(torch.full((256, 2), 128.0, device="cuda"),
                     torch.full((256,), 1.1, device="cuda"),
                     torch.full((256,), rot, device="cuda"),
                     torch.full((256,), 0.35 * 256, device="cuda"),
                     (192, 192))
    gains = torch.rand(256, 3, device="cuda", generator=gen) * 0.6 + 0.7
    do_j = (torch.rand(256, device="cuda", generator=gen) < 0.5).float()
    calls[f"warp_{int(rot)}"] = (
        lambda canvas=canvas, m=m, gains=gains, do_j=do_j: W.warp_twopass(
            canvas, m, (192, 192), jitter_gains=gains, do_jitter=do_j,
            round_output=True))
for name, fn in calls.items():
    out[name] = fn()
dist_f64 = {k: (out[k].double() - v).abs().max().item()
            for k, v in f64.items()}
del f64
# the bn pair at every ConvBnAct shape of the 192 px path, B = 256 bf16
from hgr_tpu_torch.ops import bn_act as B
bn = {}
for h, w, c, act in {(96, 96, 64, True), (48, 48, 128, True),
                     (48, 48, 64, True), (48, 48, 64, False),
                     (24, 24, 256, True), (24, 24, 128, True),
                     (24, 24, 128, False), (12, 12, 512, True),
                     (12, 12, 256, True), (12, 12, 256, False)}:
    gen = torch.Generator(device="cuda").manual_seed(h * 1000 + c)
    y = (torch.randn(256 * h * w, c, device="cuda", generator=gen) * 2
         ).to(torch.bfloat16)
    g = torch.randn(256 * h * w, c, device="cuda", generator=gen).to(
        torch.bfloat16)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    _, mean, var = B.fwd_chain(y, gamma, beta, 1e-5, act)
    r = torch.rsqrt(var + 1e-5)
    t1, t2 = B.bn_act_reduce(y, g, mean, r, gamma, beta, act)
    m = float(y.shape[0])
    key = f"{h}x{w}x{c}_{'silu' if act else 'id'}"
    calls[f"bn_reduce_{key}"] = (
        lambda y=y, g=g, mean=mean, r=r, gamma=gamma, beta=beta, act=act:
        B.bn_act_reduce(y, g, mean, r, gamma, beta, act))
    calls[f"bn_elem_{key}"] = (
        lambda y=y, g=g, mean=mean, r=r, gamma=gamma, beta=beta, act=act,
        t1=t1 / m, t2=t2 / m: B.bn_act_elem(y, g, mean, r, gamma, beta, t1,
                                             t2, act))
# each case's time: CUDA events over 50 back-to-back calls after 5
times = {}
for name, fn in calls.items():
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        fn()
    end.record()
    end.synchronize()
    times[name] = start.elapsed_time(end) / 50
torch.save({"out": {k: v.cpu() for k, v in out.items()}, "ms": times,
            "dist_f64": dist_f64}, sys.argv[2])
"""


# how many of MultiTaskNet small's 22 ConvBnAct layers at 192 px take
# each (H x W x C, SiLU or not)
_PATH_BN = {"96x96x64_silu": 1, "48x48x128_silu": 3, "48x48x64_silu": 2,
            "48x48x64_id": 2, "24x24x256_silu": 3, "24x24x128_silu": 2,
            "24x24x128_id": 2, "12x12x512_silu": 3, "12x12x256_silu": 2,
            "12x12x256_id": 2}


def bits(trees, out_dir: str) -> dict:
    """Whether the attention kernels of the two checkouts give the same
    bits on the same inputs (_BITS), case by case, and their times, each
    checkout run in the order given and then in reverse."""
    os.makedirs(out_dir, exist_ok=True)
    import torch

    order = list(trees) + list(trees)[::-1]
    runs = []
    for i, tree in enumerate(order):
        path = os.path.abspath(os.path.join(out_dir, f"run{i}.pt"))
        subprocess.run([sys.executable, "-c", _BITS, os.path.abspath(tree),
                        path], check=True)
        runs.append(torch.load(path))
    first, second = runs[0]["out"], runs[1]["out"]
    ms = {tree: {} for tree in trees}
    for tree, run in zip(order, runs):
        for k, t in run["ms"].items():
            ms[tree].setdefault(k, []).append(t)
    # the bn pair per fused step: 22 layers (their shapes, _PATH_BN) x 2
    # pullbacks, each kernel's mean over the turns
    per_step = {}
    for tree in trees:
        mean = {k: sum(v) / len(v) for k, v in ms[tree].items()}
        per_step[tree] = 2 * sum(
            count * (mean[f"bn_reduce_{key}"] + mean[f"bn_elem_{key}"])
            for key, count in _PATH_BN.items())
    # values compared (a uint8 crop against an earlier f32 one of the
    # same levels counts as the same bits); the f32 attention cases also
    # by their largest difference and each side's distance from float64
    f32 = {k: {"max_abs_diff": (first[k] - second[k]).abs().max().item(),
               "dist_f64": [runs[0]["dist_f64"][k],
                            runs[1]["dist_f64"][k]]}
           for k in runs[0]["dist_f64"]}
    # within each checkout: the split forward's bits against the packed's
    split = {tree: {k: bool(torch.equal(run["out"][k],
                                        run["out"][k[len("split_"):]]))
                    for k in run["out"] if k.startswith("split_")}
             for tree, run in zip(order, runs)}
    return {"same_bits": {k: bool(torch.equal(first[k].float(),
                                              second[k].float()))
                          for k in first}, "f32": f32, "kernel_ms": ms,
            "split_equals_packed": split, "bn_pair_ms_per_step": per_step}


# builds one checkout's attention sources (argv[1] = checkout)
_BUILD = """
import os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
from hgr_tpu_torch.utils.cuda_build import load_kernels
load_kernels(["attention_qkv_fwd", "attention_qkv_bwd"])
"""


def _entries(tree: str, name: str) -> dict:
    """Per entry function of the checkout's newest build of ``name``: its
    ptxas line (registers, spills) and its SASS (``cuobjdump -sass``).
    Names and SASS carry the anonymous namespace's tag, which nvcc
    derives from the source and which therefore differs between two
    checkouts: it is replaced by ``_ANON_``."""
    import glob
    import re

    from hgr_tpu_torch.utils.cuda_build import _nvcc

    def untag(text):
        return re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ANON_",
                      text)

    libs = glob.glob(os.path.join(tree, "build", "kernels",
                                  f"lib{name}-*.so"))
    lib = max(libs, key=os.path.getmtime)
    with open(lib[:-3] + ".log") as fh:
        ptxas = {untag(entry): f"{used}; {spills}"
                 for entry, spills, used in
                 re.findall(r"Compiling entry function '(\w+)'.*?"
                            r"(\d+ bytes spill stores, \d+ bytes spill "
                            r"loads).*?(Used \d+ registers[^\n]*)",
                            fh.read(), flags=re.S)}
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    # each function's instruction lines (offset, instruction, encoding
    # and control words)
    code, entry = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\w+)", line)
        if found:
            entry = untag(found.group(1))
            code[entry] = []
        elif entry is not None and "/*" in line:
            # cuobjdump pads the columns to the listing's widest line
            code[entry].append(untag(" ".join(line.split())))
    return {e: (line, code.get(e)) for e, line in ptxas.items()}


def _first_diff(a, b):
    """The first pair of SASS lines that differ (None if none do)."""
    for x, y in zip(a or (), b or ()):
        if x != y:
            return [x, y]
    return None if len(a or ()) == len(b or ()) else ["(length)", "(length)"]


def compile_report(trees) -> dict:
    """The attention sources' entry functions in both checkouts (each
    built in a process of its own, both at once, unless built already):
    each entry's ptxas line on either side and whether its SASS is the
    same, for the entries both sides have; the ptxas lines of the entries
    only one side has."""
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD, tree])
              for tree in trees]
    for proc in builds:
        if proc.wait() != 0:
            raise RuntimeError("building the attention sources failed")
    report = {}
    for name in ("attention_qkv_fwd", "attention_qkv_bwd"):
        first, second = (_entries(t, name) for t in trees)
        report[name] = {
            e: {"ptxas": [first[e][0], second[e][0]],
                "same_sass": first[e][1] == second[e][1],
                "sass_lines": [len(first[e][1] or ()),
                               len(second[e][1] or ())],
                "first_diff": _first_diff(first[e][1], second[e][1])}
            for e in first if e in second}
        report[name]["narrow_same_sass"] = all(
            row["same_sass"] for e, row in report[name].items()
            if "attn_wide" not in e)
        report[name]["only_in_first"] = {
            e: first[e][0] for e in sorted(set(first) - set(second))}
        report[name]["only_in_second"] = {
            e: second[e][0] for e in sorted(set(second) - set(first))}
    return report


def _side(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _SIDE, tree],
                          capture_output=True, text=True, check=True)
    out = {"tree": tree}
    for line in proc.stdout.splitlines():
        if line.startswith(('{"model"', '{"train"', '{"mixed"',
                            '{"long448"', '{"wide256"')):
            print(line, flush=True)
            out.update(json.loads(line))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, help="two checkouts (parent, change)")
    ap.add_argument("--bits-only", action="store_true",
                    help="only compare the attention kernels' output bits")
    ap.add_argument("--compile-only", action="store_true",
                    help="only compare the attention entry functions' "
                         "ptxas lines and SASS")
    args = ap.parse_args(argv)
    if args.compile_only:
        print(json.dumps({"compile": compile_report(args.trees)}))
        return 0
    print(json.dumps(bits(args.trees, os.path.join("build", "ab_bits"))),
          flush=True)
    print(json.dumps({"compile": compile_report(args.trees)}), flush=True)
    if args.bits_only:
        return 0
    order = args.trees + args.trees[::-1]
    runs = [_side(os.path.abspath(t)) for t in order]
    summary = {}
    for run in runs:
        side = summary.setdefault(run["tree"], {"forward_b64_ms": [],
                                                "step_ms": {},
                                                "mixed_step_ms": [],
                                                "step_448_ms": [],
                                                "forward_448_ms": [],
                                                "step_wide256_ms": []})
        side["forward_b64_ms"].append(run["model"]["bf16_ms_per_forward_b64"])
        side["mixed_step_ms"].append(run["mixed"]["ms_per_step"])
        side["step_448_ms"].append(run["long448"]["step_ms"])
        side["forward_448_ms"].append(run["long448"]["forward_ms"])
        side["step_wide256_ms"].append(run["wide256"]["step_ms"])
        for turn in run["train"]["turns"]:
            side["step_ms"].setdefault(f"fused_bn_{turn['fused_bn']}",
                                       []).append(turn["ms_per_step"])
    print(json.dumps({"ab": summary, "order": order}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
