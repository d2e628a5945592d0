"""The training loop (port of hgr_tpu/train/loop.py; reference
train.py:24-240): epochs over staged batches with device-side metrics,
validation each epoch, best (min val total loss) and last checkpoints,
then the test split from the best checkpoint with a confusion matrix.

Single device. ``fit(mesh=...)`` waits for multi-GPU training (ROADMAP
A12) and ``debug_images`` for the debug-image dumps (ROADMAP A14).
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hgr_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from hgr_tpu_torch.models.layers import fused_bn
from hgr_tpu_torch.ops.metrics import macro_f1_from_confusion
from hgr_tpu_torch.train.checkpoint import CheckpointManager
from hgr_tpu_torch.train.logging import MetricLogger
from hgr_tpu_torch.train.state import TrainState
from hgr_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    resolve_grad_demix,
)


class EpochMetrics:
    """Accumulates per-step metric dicts. The sums stay tensors on the
    step's device until ``snapshot()``, so updating never waits for the
    device."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self.sums: Dict[str, Any] = {}
        self.weight: Any = 0.0  # valid samples seen
        self.pose_acc_weighted: Any = 0.0
        self.pose_cnt: Any = 0.0
        self.conf = torch.zeros((self.num_classes, self.num_classes))
        self.loader_wait_s = 0.0  # host time blocked on the loader

    def update(self, metrics: Dict) -> None:
        # per-batch masked means weighted by the batch's valid count, so a
        # padded tail batch counts its real samples only; the pose accuracy
        # as the reference's running sums (train.py:89-90)
        w = metrics.get("valid_cnt", 1.0)
        self.weight = self.weight + w
        for k in ("total_loss", "class_loss", "joints_loss", "cls_f1score"):
            self.sums[k] = self.sums.get(k, 0.0) + metrics[k] * w
        cnt = metrics["pose_cnt"]
        self.pose_acc_weighted = (self.pose_acc_weighted
                                  + metrics["pose_acc"] * cnt)
        self.pose_cnt = self.pose_cnt + cnt
        upd = metrics["conf_update"]
        self.conf = self.conf.to(upd.device) + upd

    def snapshot(self) -> Dict[str, float]:
        weight = float(self.weight)
        out = {k: float(v) / max(weight, 1.0) for k, v in self.sums.items()}
        pose_cnt = float(self.pose_cnt)
        out["pose_acc"] = (float(self.pose_acc_weighted) / pose_cnt
                           if pose_cnt else 0.0)
        out["epoch_f1"] = float(macro_f1_from_confusion(self.conf.float()))
        out["samples"] = weight
        out["loader_wait_s"] = self.loader_wait_s
        return out


class NonFiniteLossError(RuntimeError):
    """The training loss became NaN or Inf (the reference has no such
    check, SURVEY.md §5.3); the last/best checkpoints allow a resume from
    before it."""


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A staged batch (numpy arrays or tensors) on ``device``. Host arrays
    go through pinned memory with asynchronous copies: a copy from
    pageable memory would wait for the card to finish the previous step."""
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def _profile_summary(prof, top: int = 15) -> Dict[str, Any]:
    """Device time by kernel name and the device's idle share over a
    profiled window, from the trace's device events (kernels, copies and
    sets; not the ranges that ``record_function`` annotations draw on the
    device timeline): busy = the union of their intervals, window = first
    to last event of the trace (host and device events share one clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name: Dict[str, list] = {}
    spans, first, last = [], None, None
    for ev in prof.events():
        s, t = ev.time_range.start, ev.time_range.end
        first = s if first is None else min(first, s)
        last = t if last is None else max(last, t)
        if ev.device_type == cuda and not getattr(ev, "is_user_annotation",
                                                   False):
            spans.append((s, t))
            row = by_name.setdefault(ev.name[:160], [0.0, 0])
            row[0] += (t - s) / 1e3
            row[1] += 1
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    window = (last - first) if first is not None else 0.0
    rows = sorted(({"name": k, "device_ms": v[0], "count": v[1]}
                   for k, v in by_name.items()), key=lambda r: -r["device_ms"])
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / window) if spans and window
            else None,
            "device_events": len(spans), "top_device_ops": rows[:top]}


def train_epoch(
    state: TrainState,
    step_fn: Callable,
    loader,
    generator: torch.Generator,
    metrics: EpochMetrics,
    logger: Optional[MetricLogger] = None,
    log_every: int = 50,
    prefix: str = "train",
    nan_guard_every: int = 50,
    lr_fn: Optional[Callable] = None,
    profile_steps: int = 0,
    profile_dir: str = "",
) -> TrainState:
    """One epoch; ``generator`` (on the state's device) draws the augment.

    Time blocked on the loader accumulates in ``metrics.loader_wait_s``.
    The loss is checked for NaN/Inf every ``nan_guard_every`` steps (the
    only per-step host sync). ``profile_steps`` traces the first that
    many steps with ``torch.profiler`` into ``profile_dir``
    (``trace.json`` and ``profile_summary.json``).
    """
    prof = None
    it = iter(loader)
    i = 0
    while True:
        t_wait = time.perf_counter()
        batch = next(it, None)
        metrics.loader_wait_s += time.perf_counter() - t_wait
        if batch is None:
            break
        if profile_steps and i == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if state.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        state, m = step_fn(state, to_device(batch, state.device), generator)
        if prof is not None and i + 1 >= profile_steps:
            _stop_profile(prof, state, profile_dir)
            prof = None
        if i % nan_guard_every == 0:
            loss = float(m["total_loss"])
            if not np.isfinite(loss):
                raise NonFiniteLossError(
                    f"non-finite loss {loss} at step {state.step}; restore "
                    "the 'last' checkpoint to resume")
        metrics.update(m)
        if i % log_every == 0 and logger is not None:
            line = {f"{prefix}/{k}": v
                    for k, v in metrics.snapshot().items()}
            if lr_fn is not None:
                line["lr"] = float(lr_fn(state.step))
            logger.log(state.step, line)
        i += 1
    if prof is not None:  # epoch shorter than profile_steps
        _stop_profile(prof, state, profile_dir)
    return state


def _stop_profile(prof, state: TrainState, profile_dir: str) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "profile_summary.json"), "w") as f:
        json.dump(_profile_summary(prof), f, indent=2)


def eval_epoch(state: TrainState, eval_fn: Callable, loader,
               metrics: EpochMetrics) -> Dict[str, float]:
    metrics.reset()
    it = iter(loader)
    while True:
        t_wait = time.perf_counter()
        batch = next(it, None)
        metrics.loader_wait_s += time.perf_counter() - t_wait
        if batch is None:
            break
        metrics.update(eval_fn(state, to_device(batch, state.device)))
    return metrics.snapshot()


def fit(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    data_cfg: DataConfig,
    state: TrainState,
    train_loader,
    val_loader,
    test_loader=None,
    save_path: str = "output/run",
    log_dir: str = "logs",
    run_name: str = "run",
    debug_images: bool = False,
    mesh=None,
    tensor_parallel: bool = False,
    lr_fn: Optional[Callable] = None,
    profile_steps: int = 0,
) -> TrainState:
    """Train ``train_cfg.epochs`` epochs, validating after each, then test
    from the best checkpoint (reference train.py:190-240). Returns the
    state after the last epoch.

    The augment generator of epoch e is seeded with ``seed · 10007 + e``
    on the state's device. Each epoch logs its train and val metrics,
    ``epoch_time_s`` (train + val) and ``train_time_s``.
    """
    if mesh is not None or tensor_parallel:
        raise NotImplementedError(
            "fit(mesh=...) is not ported yet: multi-GPU training waits for "
            "ROADMAP A12")
    if debug_images:
        raise NotImplementedError(
            "fit(debug_images=True) is not ported yet (ROADMAP A14)")
    num_classes = data_cfg.num_classes
    step_kw = dict(num_classes=num_classes, sigma=train_cfg.sigma,
                   image_size=model_cfg.image_size,
                   heatmap_size=model_cfg.heatmap_size)
    grad_demix = resolve_grad_demix(train_cfg, model_cfg)
    train_step = make_train_step(
        data_cfg.augments, class_loss_weight=train_cfg.class_loss_weight,
        grad_accum=train_cfg.grad_accum, grad_demix=grad_demix, **step_kw)
    eval_step = make_eval_step(**step_kw)

    logger = MetricLogger(log_dir, run_name)
    ckpt = CheckpointManager(os.path.join(save_path, "weight"))
    # what the checkpoints are, beside them (infer/weights.py reads it)
    with open(os.path.join(save_path, "weight", "run_meta.json"), "w") as f:
        json.dump({
            "backbone": model_cfg.backbone,
            "image_size": list(model_cfg.image_size),
            "num_joints": model_cfg.num_joints,
            "num_classes": model_cfg.num_classes,
            "compute_dtype": model_cfg.compute_dtype,
            "decoder_dtype": model_cfg.decoder_dtype,
            "early_dtype": model_cfg.early_dtype,
            "early_units": model_cfg.early_units,
            "grad_demix": grad_demix,
            "fused_bn": fused_bn(),
        }, f, indent=2)
    train_metrics = EpochMetrics(num_classes)
    val_metrics = EpochMetrics(num_classes)

    for epoch in range(train_cfg.epochs):
        t0 = time.time()
        train_metrics.reset()
        gen = torch.Generator(device=state.device).manual_seed(
            train_cfg.seed * 10007 + epoch)
        state = train_epoch(state, train_step, train_loader, gen,
                            train_metrics, logger, lr_fn=lr_fn,
                            profile_steps=profile_steps if epoch == 0 else 0,
                            profile_dir=os.path.join(save_path, "profile"))
        tr = train_metrics.snapshot()  # waits for the epoch's last step
        train_time = time.time() - t0
        val = eval_epoch(state, eval_step, val_loader, val_metrics)
        logger.log(state.step, {
            **{f"train/{k}": v for k, v in tr.items()},
            **{f"val/{k}": v for k, v in val.items()},
            "epoch": epoch,
            **({"lr": float(lr_fn(state.step))} if lr_fn is not None
               else {}),
            "epoch_time_s": time.time() - t0,
            "train_time_s": train_time,
        })
        ckpt.save_last(state)
        ckpt.maybe_save_best(state, val["total_loss"])
        print(f"epoch {epoch}: train_loss={tr['total_loss']:.4f} "
              f"val_loss={val['total_loss']:.4f} "
              f"val_f1={val['epoch_f1']:.4f} "
              f"val_pose_acc={val['pose_acc']:.4f}", flush=True)

    if test_loader is not None:
        best_state = (ckpt.restore(copy.deepcopy(state), "best")
                      if ckpt.has("best") else state)
        test_metrics = EpochMetrics(num_classes)
        test = eval_epoch(best_state, eval_step, test_loader, test_metrics)
        print("Test F1 Score: {:.4f}".format(test["epoch_f1"]), flush=True)
        logger.log(state.step, {f"test/{k}": v for k, v in test.items()})
        save_confusion(test_metrics.conf.cpu().numpy(),
                       list(data_cfg.names.keys()),
                       os.path.join(save_path, "confusion_matrix.png"))
    ckpt.wait()  # commit the last save before returning
    logger.close()
    return state


def save_confusion(conf: np.ndarray, labels, path: str) -> str:
    """The confusion matrix as a PNG (reference train.py:180-187) when
    matplotlib imports, else as ``.npy`` beside it; the path written."""
    try:
        import matplotlib
    except ImportError:
        path = path[:-len(".png")] + ".npy" if path.endswith(".png") else path
        np.save(path, conf)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    im = ax.imshow(conf, cmap="Blues")
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90)
    ax.set_yticklabels(labels)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    for i in range(conf.shape[0]):
        for j in range(conf.shape[1]):
            if conf[i, j] > 0:
                ax.text(j, i, int(conf[i, j]), ha="center", va="center",
                        fontsize=7)
    fig.colorbar(im)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
    return path
