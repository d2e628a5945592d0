"""Training cells: ``train_epoch`` of the step that ``fit`` builds from
the training CLI's defaults, fed by a device-resident cache of synthetic
rows of HaGRID's geometry made on the card from the seed.

Set-up builds the one train state (the benchmark's weights), the step
and the cache, takes ``warm_steps`` steps through ``train_epoch`` with
the window's own step and loader, which compile and warm every kernel,
and then puts that state back, in place, to the seeded weights and a
fresh AdamW state. The window runs ``train_epoch`` on the same state
until ``--seconds`` have passed on the host and its first
``check_steps`` steps are taken, and closes at a synchronize after its
last step: ``train_crops_per_s`` is every crop trained in it over its
length. The window's first steps are so the first steps of training,
and the reference follows them from the seeded weights, on the same
batches and augment draws.

What decides ``correct`` (each against the traffic file's limit), of
the window's checked steps: ``grad``, the worst leaf's norm of the
program's gradient at the window's first step (as the optimizer gets
it: its first moment after the step over 1 - b1) less the reference's;
``change``, the worst leaf's norm of the program's change of the
parameters over the checked steps less the reference's. Each is
measured against the larger of the reference's norm of that leaf and of
the median leaf; ``grad_median``, the median leaf's ``grad``;
``change`` leaves out leaves whose reference gradient is under a
thousandth of the median leaf's (they move under Adam by round-off
alone). Each checked step's relative loss gap is printed, not compared:
no control separates it from the program (``PERF.md``).
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from hgr_bench import counts, weights
from hgr_bench.harness import Ctx, Outcome, free, peak_bytes, sync
from hgr_bench.reference import Precision, exact_float32, mtn
from hgr_bench.reference import train as ref_train
from hgr_bench.trace import Slice

NUM_JOINTS = 21


def spec(cs: int) -> Dict[str, tuple]:
    """The cache's flat layout per key: (row length, sample shape,
    dtype)."""
    return {"canvas": (cs * cs * 3, (cs, cs, 3), torch.uint8),
            "orig_to_canvas": (6, (2, 3), torch.float32),
            "sizes_hw": (2, (2,), torch.float32),
            "joints": (NUM_JOINTS * 2, (NUM_JOINTS, 2), torch.float32),
            "joints_vis": (NUM_JOINTS, (NUM_JOINTS,), torch.float32),
            "label": (1, (), torch.int32)}


def make_rows(n: int, cs: int, window_frac: float, hw_range, gen,
              device) -> Dict[str, torch.Tensor]:
    """``n`` staged rows in the cache's flat layout, drawn on the card:
    original sizes h, w uniform in ``hw_range``, staged as the loader
    stages an image (the central window_frac · max(h, w) window, shrunk
    to the canvas only where it is larger); canvases of uniform noise;
    21 joints scattered about the centre, none on every 17th row (an
    empty landmark list, as HaGRID has); labels uniform over 19."""
    lo, hi = hw_range
    hw = torch.randint(lo, hi + 1, (n, 2), generator=gen,
                       device=device).float()
    h, w = hw[:, 0], hw[:, 1]
    win = torch.ceil(window_frac * torch.maximum(h, w))
    x0 = torch.clamp(torch.floor(w / 2.0 - win / 2.0), min=0.0)
    y0 = torch.clamp(torch.floor(h / 2.0 - win / 2.0), min=0.0)
    ww = torch.minimum(w, x0 + win) - x0
    wh = torch.minimum(h, y0 + win) - y0
    big = torch.maximum(ww, wh)
    s = torch.where(big > cs, cs / big, torch.ones_like(big))
    zero = torch.zeros_like(s)
    o2c = torch.stack([s, zero, -x0 * s, zero, s, -y0 * s], -1)
    centre = torch.stack([w, h], -1)[:, None, :] / 2.0
    spread = 0.08 * torch.maximum(h, w)[:, None, None]
    joints = centre + torch.randn((n, NUM_JOINTS, 2), generator=gen,
                                  device=device) * spread
    joints = torch.minimum(torch.clamp(joints, min=0.0),
                           torch.stack([w, h], -1)[:, None, :] - 1.0)
    vis = torch.ones((n, NUM_JOINTS), device=device)
    empty = torch.arange(n, device=device) % 17 == 16
    vis[empty] = 0.0
    joints[empty] = 0.0
    canvas = torch.empty((n, cs * cs * 3), dtype=torch.uint8, device=device)
    canvas.random_(0, 256, generator=gen)
    label = torch.randint(0, 19, (n, 1), generator=gen, device=device,
                          dtype=torch.int32)
    return {"canvas": canvas, "orig_to_canvas": o2c, "sizes_hw": hw,
            "joints": joints.reshape(n, -1), "joints_vis": vis,
            "label": label}


def make_loader(rows, n: int, batch: int, cs: int, window_frac: float,
                order: np.ndarray, device):
    """A ``DeviceCacheLoader`` whose cache is ``rows`` and whose batches
    follow ``order`` (the benchmark's permutation), carried on across
    iterations; an iteration ends when ``more()`` says so."""
    from hgr_tpu_torch.data.dataset import AnnotationIndex, Sample
    from hgr_tpu_torch.data.device_cache import DeviceCacheLoader

    layout = spec(cs)

    class BenchCache(DeviceCacheLoader):
        def _build_cache(self) -> None:
            self._cache = rows
            self._spec = {k: (v[0], v[1], v[2]) for k, v in layout.items()}

        def _batch_ids(self):
            while self.more():
                if self.pos + batch > n:
                    self.pos = 0
                yield order[self.pos:self.pos + batch], batch
                self.pos += batch

    sample = Sample(image_path="", landmark=[], label="c0")
    index = AnnotationIndex(samples=[sample] * n, names={"c0": 0})
    loader = BenchCache(index, batch_size=batch, canvas_size=cs,
                        num_joints=NUM_JOINTS, shuffle=False,
                        drop_last=False, num_workers=1,
                        window_frac=window_frac, device=device)
    loader.pos = 0
    loader._build_cache()
    return loader


def staging_window(aug: Dict, crop_factor: float = 0.35) -> float:
    """The share of max(h, w) that the loader stages: twice the farthest
    reach of an augmented crop from the centre (the shift's two sigmas
    and the half diagonal of the largest crop), at most 1."""
    reach = (2.0 * aug["translate_factor"] + crop_factor
             * (1.0 + aug["scale_factor"]) * 2.0 ** 0.5 / 2.0)
    return min(1.0, 2.0 * reach)


def leaf_gaps(prog: Dict, ref: Dict, keep=None) -> list:
    """Per leaf, the norm of the program's tensor less the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    norm = {n: float(ref[n].norm()) for n in names}
    med = float(np.median(list(norm.values())))
    return [float((prog[n] - ref[n]).norm()) / max(norm[n], med)
            for n in names]


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of the module docstring, then those printed only."""
    ref_grad = {n: float(g.norm()) for n, g in ref["grad"].items()}
    med = float(np.median(list(ref_grad.values())))
    moved = {n for n, g in ref_grad.items() if g >= 1e-3 * med}
    grad = leaf_gaps(prog["grad"], ref["grad"])
    return {"grad": max(grad),
            "change": max(leaf_gaps(prog["change"], ref["change"], moved)),
            "grad_median": float(np.median(grad)),
            "loss": [abs(a - b) / abs(b)
                     for a, b in zip(prog["loss"], ref["loss"])]}


def restart(state, state0) -> None:
    """Put ``state`` back to the weights ``state0`` and a fresh AdamW
    state, in place: the same tensors, the same optimizer."""
    with torch.no_grad():
        state.model.load_state_dict(state0, strict=True)
        for held in state.optimizer.state.values():
            for v in held.values():
                if torch.is_tensor(v):
                    v.zero_()
    state.step = 0


def checked(numbers: Dict, limits: Dict) -> Dict[str, tuple]:
    """(value, limit) of the compared numbers; the rest go to stderr."""
    for k, v in numbers.items():
        if k not in limits:
            print(f"not compared: {k} {v}", file=sys.stderr)
    return {k: (v, limits[k]) for k, v in numbers.items() if k in limits}


def reference(cfg, tr, state0, batches, seed, device, prec="float32",
              keep_rows=1.0):
    """The plain reference's readings over the checked batches."""
    image = (tr["image_size"], tr["image_size"])
    with exact_float32():
        model = mtn.from_config(cfg, image, Precision(prec)).to(device)
        model.load_state_dict(state0, strict=True)
        gen = weights.generator(seed, "augment", device)
        return ref_train.follow(model, batches, gen, cfg["train"], image,
                                keep_rows)


def run(ctx: Ctx) -> Outcome:
    from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.ops.attention import fused_attention_qkv, \
        fused_attention_qkv_bwd
    from hgr_tpu_torch.ops.warp_fused import warp_twopass
    from hgr_tpu_torch.train.loop import EpochMetrics, train_epoch
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step, \
        resolve_grad_demix

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    m, t = cfg["model"], cfg["train"]
    image = (tr["image_size"], tr["image_size"])
    bsz, cs, n = tr["batch_size"], tr["canvas_size"], tr["rows"]
    model_cfg = ModelConfig(
        num_joints=m["num_joints"], num_classes=m["num_classes"],
        image_size=image, backbone=m["backbone"], dim=m["dim"],
        depth=m["depth"], heads=m["heads"], head_dim=m["head_dim"],
        mlp_dim=m["mlp_dim"], compute_dtype=m["compute_dtype"])
    train_cfg = TrainConfig(batch_size=bsz, lr=t["lr"], sigma=t["sigma"],
                            class_loss_weight=t["class_loss_weight"],
                            canvas_size=cs)
    aug = AugmentConfig(**t["augments"])
    window_frac = staging_window(t["augments"])

    state0 = weights.mtn_state(cfg, image, seed, dev)
    state = create_train_state(MultiTaskNet.from_config(model_cfg),
                               lr=t["lr"], weight_decay=t["weight_decay"],
                               device=dev)
    state.model.load_state_dict(state0, strict=True)
    step = make_train_step(
        aug, num_classes=m["num_classes"], sigma=t["sigma"],
        image_size=image, heatmap_size=model_cfg.heatmap_size,
        class_loss_weight=t["class_loss_weight"],
        grad_demix=resolve_grad_demix(train_cfg, model_cfg))
    rows = make_rows(n, cs, window_frac, tr["orig_hw_range"],
                     weights.generator(seed, "rows", dev), dev)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        weights.subseed(seed, "order"))).numpy()
    loader = make_loader(rows, n, bsz, cs, window_frac, perm, dev)

    names = [k for k, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    warm, check = tr["warm_steps"], tr["check_steps"]
    seen = {"steps": 0, "host_s": [], "batches": []}
    prog: Dict = {"loss": []}
    sl = Slice() if ctx.trace else None
    traced = {"gen_states": [], "batches": []}

    def counters():
        return (fused_attention_qkv.launches, fused_attention_qkv_bwd.launches,
                warp_twopass.launches)

    def timed_step(st, batch, g):
        i = seen["steps"]
        if sl is not None and i == seen.get("trace_from"):
            traced["c0"] = counters()
            sl.start()
        tracing = sl is not None and sl.running
        if tracing:
            traced["gen_states"].append(g.get_state())
            traced["batches"].append({k: batch[k] for k in (
                "orig_to_canvas", "sizes_hw")})
        if warm <= i < warm + check:
            seen["batches"].append({k: v.clone() for k, v in batch.items()
                                    if torch.is_tensor(v)})
        t0 = time.perf_counter()
        st, met = step(st, batch, g)
        if not tracing:
            seen["host_s"].append(time.perf_counter() - t0)
        seen["steps"] = i + 1
        if warm <= i < warm + check:
            prog["loss"].append(met["total_loss"].detach())
        if i == warm:  # the first moment after one step is 0.1 x the gradient
            held = st.optimizer.state
            prog["grad"] = {k: held[params[k]]["exp_avg"] / 0.1
                            if params[k] in held
                            else torch.zeros_like(params[k]) for k in names}
        if i == warm + check - 1:
            prog["change"] = {k: params[k].detach() - state0[k]
                              for k in names}
        if tracing and i + 1 == seen["trace_from"] + tr["trace_steps"]:
            sl.stop()
            traced["c1"] = counters()
        return st, met

    loader.more = lambda: seen["steps"] < warm
    state = train_epoch(state, timed_step, loader,
                        weights.generator(seed, "warm", dev),
                        EpochMetrics(m["num_classes"]))
    restart(state, state0)
    gen = weights.generator(seed, "augment", dev)
    sync(dev)
    setup_peak = peak_bytes(dev, reset=True)
    seen["host_s"].clear()
    seen["trace_from"] = warm + tr["trace_after"]
    start = time.monotonic()
    deadline = start + ctx.seconds
    loader.more = lambda: (time.monotonic() < deadline
                           or seen["steps"] < warm + check)
    state = train_epoch(state, timed_step, loader, gen,
                        EpochMetrics(m["num_classes"]))
    sync(dev)
    end = time.monotonic()
    if sl is not None and sl.running:  # a window shorter than its slice
        sl.stop()
        traced["c1"] = counters()
    steps = seen["steps"] - warm
    peak_window = peak_bytes(dev)
    memory_peak = max(setup_peak, peak_window)

    record = {"window_s": end - start, "crops": steps * bsz,
              "host_issue_s": list(seen["host_s"]),
              "peak_window_bytes": peak_window,
              "forward_flops": counts.mtn_forward_flops(cfg, image),
              "flops_per_item": 3.0}
    if sl is not None and sl.summary() is not None:
        # the rate outside the traced slice, which the profiler slows
        record["outside_trace"] = (
            (steps - tr["trace_steps"]) * bsz,
            end - start - (sl.stopped - sl.started))
        record["trace"] = sl.summary()
        record["launches"] = [b - a for a, b in zip(traced["c0"],
                                                     traced["c1"])]
        record["attention_shape"] = (bsz, image[0] // 16 * image[1] // 16
                                     + 1, m["heads"], m["head_dim"])
        record["warp_bounds"] = warp_bounds(traced, cfg, tr, dev)

    del state, loader, rows, step, params
    free(dev)
    prog["loss"] = [float(x) for x in prog["loss"]]
    ref = reference(cfg, tr, state0, seen["batches"], seed, dev)
    numbers = compare(prog, ref)
    record["numbers"] = numbers
    return Outcome(attempted=steps, failed=0,
                   metrics={"train_crops_per_s": steps * bsz / (end - start),
                            "setup_s": start - ctx.started},
                   checks=checked(numbers, tr["limits"]),
                   record=record, memory_peak_bytes=memory_peak)


def warp_bounds(traced, cfg, tr, device):
    """(bytes, FLOPs) of each traced step's warp launch, from the draws
    the reference replays on the generator's state before that step."""
    from hgr_bench.reference import augment as A

    image = (tr["image_size"], tr["image_size"])
    out = []
    for st, b in zip(traced["gen_states"], traced["batches"]):
        g = torch.Generator(device=device)
        g.set_state(st)
        p = A.draw(g, b["sizes_hw"].shape[0], b["sizes_hw"],
                   cfg["train"]["augments"])
        _, m_canvas = A.crop_affines(b["orig_to_canvas"], b["sizes_hw"], p,
                                     image)
        fp = counts.warp_footprint_px(m_canvas, tr["canvas_size"], *image)
        out.append(counts.warp(fp, p["jitter"], *image))
    return out
