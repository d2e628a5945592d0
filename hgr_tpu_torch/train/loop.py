"""The training loop (port of hgr_tpu/train/loop.py; reference
train.py:24-240): epochs over staged batches with device-side metrics,
validation each epoch, best (min val total loss) and last checkpoints,
then the test split from the best checkpoint with a confusion matrix.

``fit(mesh=...)`` runs one rank of a mesh (parallel/): every rank runs
the same steps on its rows; the coordinator owns metrics.jsonl,
TensorBoard, stdout, the checkpoint files and run_meta.json (JAX
loop.py:198-281). ``debug_images`` dumps the reference's debug images
(utils/vis.py) without a mesh; under one it is disabled, as the JAX loop
disables it for multi-process runs.
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
from hgr_tpu_torch.parallel import distributed
from hgr_tpu_torch.parallel.steps import (
    make_parallel_eval_step,
    make_parallel_train_step,
)
from hgr_tpu_torch.train.checkpoint import CheckpointManager
from hgr_tpu_torch.train.logging import MetricLogger
from hgr_tpu_torch.train.state import TrainState
from hgr_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    resolve_grad_demix,
)
from hgr_tpu_torch.utils import profiling


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
    debug_hook: Optional[Callable] = None,
    debug_every: int = 100,
    profile_steps: int = 0,
    profile_dir: str = "",
) -> TrainState:
    """One epoch; ``generator`` (on the state's device) draws the augment.
    ``debug_hook(state, batch, step)`` fires after every ``debug_every``-th
    train batch, from the first (reference train.py:148-160).

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
            prof = profiling.start(state.device)
        batch = to_device(batch, state.device)
        state, m = step_fn(state, batch, generator)
        if prof is not None and i + 1 >= profile_steps:
            profiling.stop(prof, state.device, profile_dir)
            prof = None
        if i % nan_guard_every == 0:
            loss = float(m["total_loss"])
            if not np.isfinite(loss):
                raise NonFiniteLossError(
                    f"non-finite loss {loss} at step {state.step}; restore "
                    "the 'last' checkpoint to resume")
        metrics.update(m)
        if debug_hook is not None and i % debug_every == 0:
            debug_hook(state, batch, state.step)
        if i % log_every == 0 and logger is not None:
            line = {f"{prefix}/{k}": v
                    for k, v in metrics.snapshot().items()}
            if lr_fn is not None:
                line["lr"] = float(lr_fn(state.step))
            logger.log(state.step, line)
        i += 1
    if prof is not None:  # epoch shorter than profile_steps
        profiling.stop(prof, state.device, profile_dir)
    return state


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
    on the state's device (alike on every rank). Each epoch logs its train
    and val metrics, ``epoch_time_s`` (train + val) and ``train_time_s``.
    With ``mesh`` (this rank's ``parallel.mesh.Mesh``) the state must
    already be this rank's (``parallel.steps.shard_state``) and the
    loaders must yield its rows.

    ``debug_images`` dumps the reference's debug images into
    ``<save_path>/debug`` (train.py:148-174): ``train_<step>_*.jpg`` of
    the train batch after every ``train_cfg.debug_every``-th step, and
    ``val_<epoch>_*.jpg`` (with the attention overlay) of the first val
    batch after each epoch, each through an eval step with its outputs.
    Under a mesh it is disabled: every rank is a process, and the JAX
    loop disables the dumps for multi-process runs.
    """
    if tensor_parallel and (mesh is None or not mesh.tensor_parallel):
        raise ValueError("tensor_parallel needs a mesh with a model axis")
    num_classes = data_cfg.num_classes
    main = distributed.is_coordinator()
    if debug_images and mesh is not None:
        if main:
            print("debug_images disabled under multi-process execution",
                  flush=True)
        debug_images = False
    step_kw = dict(num_classes=num_classes, sigma=train_cfg.sigma,
                   image_size=model_cfg.image_size,
                   heatmap_size=model_cfg.heatmap_size)
    grad_demix = resolve_grad_demix(train_cfg, model_cfg)
    train_kw = dict(class_loss_weight=train_cfg.class_loss_weight,
                    grad_accum=train_cfg.grad_accum, grad_demix=grad_demix,
                    **step_kw)
    if mesh is not None:
        train_step = make_parallel_train_step(mesh, data_cfg.augments,
                                              **train_kw)
        eval_step = make_parallel_eval_step(mesh, **step_kw)
    else:
        train_step = make_train_step(data_cfg.augments, **train_kw)
        eval_step = make_eval_step(**step_kw)

    debug_hook, dump_val_debug = (_debug_dumps(save_path, val_loader,
                                               step_kw)
                                  if debug_images else (None, None))
    logger = MetricLogger(log_dir, run_name) if main else None
    ckpt = CheckpointManager(os.path.join(save_path, "weight"), mesh=mesh)
    if main:  # what the checkpoints are (infer/weights.py reads it)
        with open(os.path.join(save_path, "weight", "run_meta.json"),
                  "w") as f:
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
                "mesh": dict(mesh.shape) if mesh is not None else None,
                "backend": distributed.backend(),
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
                            debug_hook=debug_hook,
                            debug_every=train_cfg.debug_every,
                            profile_steps=(profile_steps if epoch == 0
                                           and main else 0),
                            profile_dir=os.path.join(save_path, "profile"))
        tr = train_metrics.snapshot()  # waits for the epoch's last step
        train_time = time.time() - t0
        val = eval_epoch(state, eval_step, val_loader, val_metrics)
        if logger is not None:
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
        if dump_val_debug is not None:
            dump_val_debug(state, epoch)
        if main:
            print(f"epoch {epoch}: train_loss={tr['total_loss']:.4f} "
                  f"val_loss={val['total_loss']:.4f} "
                  f"val_f1={val['epoch_f1']:.4f} "
                  f"val_pose_acc={val['pose_acc']:.4f}", flush=True)

    if test_loader is not None:
        best_state = (ckpt.restore(copy_state(state, mesh), "best")
                      if ckpt.has("best") else state)
        test_metrics = EpochMetrics(num_classes)
        test = eval_epoch(best_state, eval_step, test_loader, test_metrics)
        if main:
            print("Test F1 Score: {:.4f}".format(test["epoch_f1"]),
                  flush=True)
            logger.log(state.step, {f"test/{k}": v for k, v in test.items()})
            save_confusion(test_metrics.conf.cpu().numpy(),
                           list(data_cfg.names.keys()),
                           os.path.join(save_path, "confusion_matrix.png"))
    ckpt.wait()  # commit the last save before returning
    if logger is not None:
        logger.close()
    return state


def _debug_dumps(save_path: str, val_loader, step_kw: Dict):
    """(train hook, val dump) of ``fit(debug_images=True)``: two eval steps
    with their outputs, the train dumps' without the attention map (no
    unfused last layer), the val dumps' with it (JAX loop.py:266-324)."""
    from hgr_tpu_torch.utils.vis import save_debug_images

    dbg_dir = os.path.join(save_path, "debug")
    os.makedirs(dbg_dir, exist_ok=True)
    steps = {False: make_eval_step(return_outputs=True, with_attnmap=False,
                                   **step_kw),
             True: make_eval_step(return_outputs=True, with_attnmap=True,
                                  **step_kw)}

    def dump(state, batch, name, with_attention):
        _, outputs = steps[with_attention](state, batch)
        save_debug_images(outputs, os.path.join(dbg_dir, name),
                          with_attention=with_attention)

    def debug_hook(state, batch, step):
        # no attention overlay on train dumps (reference libs/vis.py:187)
        dump(state, batch, f"train_{step}", with_attention=False)

    val_batch = []

    def dump_val_debug(state, epoch):
        if not val_batch:
            val_batch.append(to_device(next(iter(val_loader)), state.device))
        dump(state, val_batch[0], f"val_{epoch}", with_attention=True)

    return debug_hook, dump_val_debug


def copy_state(state: TrainState, mesh=None) -> TrainState:
    """A deep copy of ``state`` whose model shares the mesh's process
    groups (which cannot be copied) with the original."""
    memo = {}
    if mesh is not None:
        memo = {id(g): g for g in (mesh.data_group, mesh.model_group)
                if g is not None}
    return copy.deepcopy(state, memo)


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
