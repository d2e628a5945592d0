"""Train and eval steps with device-side augmentation and metrics (port
of hgr_tpu/train/steps.py; reference train.py:58-107).

One train step on a staged batch: augment (the fused jitter + warp
kernel on the card) -> MultiTaskNet forward in train mode (the attention
forward kernel) -> 0.001·CE + joints MSE -> backward (the attention
backward kernel) -> AdamW update -> F1, PCK and confusion counts on the
device. The staged batch is the loader's layout (hgr_tpu/data/
loader.py:131-160): canvas (B, S, S, 3) uint8, orig_to_canvas (B, 2, 3),
sizes_hw (B, 2), joints (B, J, 2), joints_vis (B, J), label (B,) and an
optional valid mask (B,). Only scalar metrics need to leave the device.

``data_ranks`` (``parallel/steps.py``) makes a step one rank's part of a
data-parallel step on the global batch: the rank draws the global
batch's augment and takes its rows, divides its loss sums by the global
valid count, sums its metrics over the data group, and sums the
gradients over it before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.data.pipeline import (
    apply_augment_batch,
    draw_augment_params,
    identity_params,
)
from hgr_tpu_torch.models.multitasknet import heatmaps_to_nchw
from hgr_tpu_torch.ops.losses import (
    classification_loss,
    joints_mse_loss,
    multitask_loss,
)
from hgr_tpu_torch.ops.metrics import (
    confusion_update,
    macro_f1_from_confusion,
    pck_accuracy,
)
from hgr_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
_LOSSES = ("total_loss", "class_loss", "joints_loss")


def _on(batch, device: torch.device) -> Batch:
    """The staged batch (numpy arrays or tensors) on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def _draw(generator, batch: Batch, aug_cfg: AugmentConfig, data_ranks):
    """The augment draw of the batch, or with ``data_ranks`` this rank's
    rows of the global batch's draw (every rank draws it whole from the
    same generator; the draw is row-wise in the sizes, so the other rows'
    sizes do not matter)."""
    b = batch["canvas"].shape[0]
    if data_ranks is None:
        return draw_augment_params(generator, b, batch["sizes_hw"], aug_cfg)
    lo = data_ranks.index * b
    sizes = batch["sizes_hw"].new_zeros((b * data_ranks.size, 2))
    sizes[lo:lo + b] = batch["sizes_hw"]
    full = draw_augment_params(generator, b * data_ranks.size, sizes, aug_cfg)
    return dataclasses.replace(full, **{
        f.name: getattr(full, f.name)[lo:lo + b]
        for f in dataclasses.fields(full)})


def _preprocess(batch: Batch, generator: Optional[torch.Generator],
                aug_cfg: Optional[AugmentConfig], sigma: float, image_size,
                heatmap_size, warp_method: str, data_ranks=None) -> Batch:
    """Staged batch -> model-ready tensors, on the batch's device.
    A generator and an augment config draw training augments; without
    them the transform is the identity (eval)."""
    b = batch["canvas"].shape[0]
    train_mode = generator is not None and aug_cfg is not None
    if train_mode:
        params = _draw(generator, batch, aug_cfg, data_ranks)
    else:
        params = identity_params(b, batch["canvas"].device)
    out = apply_augment_batch(
        batch["canvas"], batch["orig_to_canvas"], batch["sizes_hw"],
        batch["joints"], batch["joints_vis"], params,
        image_size=image_size, heatmap_size=heatmap_size, sigma=sigma,
        warp_method=warp_method,
        enable_jitter=train_mode and aug_cfg.color_jittering)
    out["label"] = batch["label"]
    return out


def _count(mask: Optional[torch.Tensor], b: int, device, data_ranks):
    """The valid samples of the batch, over the data ranks when given."""
    local = (mask.float().sum() if mask is not None else
             torch.tensor(float(b), device=device))
    return local if data_ranks is None else data_ranks.sum(local)


@torch.no_grad()
def _step_metrics(data: Batch, parts: Dict[str, torch.Tensor],
                  cls_out: torch.Tensor, hmap: torch.Tensor,
                  num_classes: int, mask: Optional[torch.Tensor],
                  count: torch.Tensor, data_ranks=None):
    """The masked metric set; ``mask`` (B,) drops tail-batch padding. With
    ``data_ranks`` every entry is the global batch's: the loss parts (each
    rank's is its sum over the global count) and the counts are summed
    over the ranks, F1 comes from the summed confusion."""
    total = (lambda t: t) if data_ranks is None else data_ranks.sum
    pred_label = torch.argmax(cls_out, dim=-1)
    dev = cls_out.device
    conf0 = torch.zeros((num_classes, num_classes), device=dev)
    conf = total(confusion_update(conf0, data["label"], pred_label,
                                  sample_mask=mask))
    _, avg_acc, cnt, _ = pck_accuracy(
        hmap, data["target"], sample_mask=mask,
        reduce=None if data_ranks is None else lambda t: tuple(total(t)))
    return {
        **{k: total(v.detach()) for k, v in parts.items()},
        "cls_f1score": macro_f1_from_confusion(conf),
        "pose_acc": avg_acc,
        "pose_cnt": cnt,
        "valid_cnt": count,
        "conf_update": conf,
    }, pred_label


def resolve_grad_demix(train_cfg, model_cfg):
    """TrainConfig.grad_demix ('auto' | 'on' | 'off' | 'batched') ->
    False | True | 'batched'. 'auto' is on exactly when some segment of
    the model computes in bf16 (train/steps.py:99-116 of the JAX
    package: the merged bf16 backward drowns the CE x 0.001 gradient)."""
    mode = getattr(train_cfg, "grad_demix", "auto")
    if mode in ("on", "off", "batched"):
        return "batched" if mode == "batched" else mode == "on"
    return "bfloat16" in (model_cfg.compute_dtype, model_cfg.decoder_dtype,
                          getattr(model_cfg, "early_dtype", None))


def _grads(loss: torch.Tensor, params, retain: bool = False):
    return torch.autograd.grad(loss, params, retain_graph=retain,
                               allow_unused=True, materialize_grads=True)


def _batched_grads(losses: torch.Tensor, params):
    """The pullbacks of the cotangents (1, 0) and (0, 1) of the two
    ``losses`` as one batched backward: (rows of row 0, rows of row 1),
    each a tuple over ``params`` (zeros where a parameter is unused)."""
    basis = torch.eye(2, dtype=losses.dtype, device=losses.device)
    g2 = torch.autograd.grad(losses, params, grad_outputs=basis,
                             allow_unused=True, is_grads_batched=True)
    g2 = [g if g is not None else p.new_zeros((2,) + p.shape)
          for g, p in zip(g2, params)]
    return tuple(g[0] for g in g2), tuple(g[1] for g in g2)


def make_train_step(aug_cfg: AugmentConfig, num_classes: int = 19,
                    sigma: float = 2.0, image_size=(192, 192),
                    heatmap_size=(48, 48), class_loss_weight: float = 0.001,
                    grad_accum: int = 1, grad_demix=False,
                    debug_return_grads: bool = False,
                    warp_method: str = "auto", data_ranks=None) -> Callable:
    """Build the train step ``step(state, batch, generator) -> (state,
    metrics)``; the state is updated in place. ``generator`` is a
    ``torch.Generator`` on the state's device for the augment draw.

    ``grad_demix=True`` takes the two task gradients by separate
    pullbacks of ONE forward: ``torch.autograd.grad`` of the natural-scale
    CE (keeping the graph), then of the joints loss, combined in float32
    as g_joints + class_loss_weight · g_ce. The same gradient as the
    merged backward in exact arithmetic; under bf16 each backward carries
    one task's cotangents at full relative precision.

    ``grad_demix='batched'`` takes the same two pullbacks as ONE batched
    backward (the ``jax.vmap`` of hgr_tpu/train/steps.py:221-230): one
    ``torch.autograd.grad`` of the stacked (CE, joints) losses with the
    cotangent basis ``eye(2)`` and ``is_grads_batched=True``, rows
    combined in float32 as g[1] + class_loss_weight · g[0]. The rows never
    add inside the backward. torch runs that backward under its legacy
    vmap, which loops over the two rows at every operator that has no
    batching rule (the convolution, SiLU, GELU and LayerNorm backwards
    among others, and the port's kernel operators, each called with real
    tensors and counted once per row). ``step.batched_backwards`` counts the batched
    backwards taken (one a microbatch).

    ``grad_accum > 1`` runs the batch as that many sequential
    microbatches and applies one update from their gradients averaged by
    valid count; each microbatch's forward updates the BatchNorm
    statistics once. ``debug_return_grads`` adds the pre-update
    gradients (name -> f32 tensor) as metrics['_grads'].

    ``data_ranks``: this rank's part of a data-parallel step on the global
    batch (the module docstring); its gradients are summed over the data
    ranks in one flat f32 all-reduce after both pullbacks (and after the
    microbatches), before ``debug_return_grads`` and the update.
    """
    batched = grad_demix == "batched"
    grad_demix = bool(grad_demix)

    def one_micro(state: TrainState, mbatch: Batch, generator):
        model = state.model
        names, params = zip(*model.named_parameters())
        mask = mbatch.get("valid")
        data = _preprocess(mbatch, generator, aug_cfg, sigma, image_size,
                           heatmap_size, warp_method, data_ranks)
        cls_out, hmap, _ = model(data["image"], need_attnmap=False)
        hmap_nchw = heatmaps_to_nchw(hmap)
        count = _count(mask, cls_out.shape[0], cls_out.device, data_ranks)
        denom = None if data_ranks is None else count
        if grad_demix:
            # natural-scale CE: the weight is applied at the f32 combine
            ce = classification_loss(cls_out, data["label"], mask, denom)
            jl = joints_mse_loss(hmap_nchw, data["target"],
                                 data["target_weight"], mask, denom)
            if batched:
                g_ce, g_jl = _batched_grads(torch.stack([ce, jl]), params)
                train_step.batched_backwards += 1
            else:
                g_ce = _grads(ce, params, retain=True)
                g_jl = _grads(jl, params)
            grads = [b.float() + class_loss_weight * a.float()
                     for a, b in zip(g_ce, g_jl)]
            class_loss = ce * class_loss_weight
            parts = {"total_loss": class_loss + jl,
                     "class_loss": class_loss, "joints_loss": jl}
        else:
            total, parts = multitask_loss(
                cls_out, hmap_nchw, data["label"], data["target"],
                data["target_weight"], class_loss_weight=class_loss_weight,
                sample_mask=mask, count=denom)
            grads = [g.float() for g in _grads(total, params)]
        metrics, _ = _step_metrics(data, parts, cls_out, hmap_nchw,
                                   num_classes, mask, count, data_ranks)
        return dict(zip(names, grads)), metrics

    def train_step(state: TrainState, batch, generator):
        state.model.train()
        batch = _on(batch, state.device)
        if grad_accum == 1:
            grads, metrics = one_micro(state, batch, generator)
        else:
            grads, metrics = _accumulate(state, batch, generator)
        if data_ranks is not None:
            grads = data_ranks.sum_grads(grads)
        if debug_return_grads:
            metrics["_grads"] = grads
        return state.apply_gradients(grads), metrics

    def _accumulate(state, batch, generator):
        a = grad_accum
        b = batch["canvas"].shape[0]
        if b % a:
            raise ValueError(f"batch {b} not divisible by grad_accum {a}")
        gsum, vsum, psum = None, 0.0, {k: 0.0 for k in _LOSSES}
        conf, pnum, pcnt = 0.0, 0.0, 0.0
        for i in range(a):
            mbatch = {k: v[i * (b // a):(i + 1) * (b // a)]
                      for k, v in batch.items()}
            grads, m = one_micro(state, mbatch, generator)
            v = m["valid_cnt"]
            if gsum is None:
                gsum = {k: g * v for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    gsum[k] = gsum[k] + g * v
            vsum = vsum + v
            psum = {k: psum[k] + m[k] * v for k in _LOSSES}
            conf = conf + m["conf_update"]
            pnum = pnum + m["pose_acc"] * m["pose_cnt"]
            pcnt = pcnt + m["pose_cnt"]
        denom = torch.clamp(vsum, min=1.0)
        grads = {k: s / denom for k, s in gsum.items()}
        metrics = {**{k: psum[k] / denom for k in _LOSSES},
                   "cls_f1score": macro_f1_from_confusion(conf),
                   "pose_acc": pnum / torch.clamp(pcnt.float(), min=1.0),
                   "pose_cnt": pcnt, "valid_cnt": vsum, "conf_update": conf}
        return grads, metrics

    train_step.batched_backwards = 0
    return train_step


def make_eval_step(num_classes: int = 19, sigma: float = 2.0,
                   image_size=(192, 192), heatmap_size=(48, 48),
                   return_outputs: bool = False,
                   with_attnmap: Optional[bool] = None,
                   warp_method: str = "auto", data_ranks=None) -> Callable:
    """Build ``eval_step(state, batch) -> metrics`` (plus the raw outputs
    with ``return_outputs``): the same forward in eval mode, with no
    augment and no update. ``with_attnmap`` defaults to
    ``return_outputs``. ``data_ranks``: the global batch's metrics, as in
    ``make_train_step``."""
    if with_attnmap is None:
        with_attnmap = return_outputs

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        batch = _on(batch, state.device)
        mask = batch.get("valid")
        data = _preprocess(batch, None, None, sigma, image_size,
                           heatmap_size, warp_method)
        cls_out, hmap, attn = model(data["image"], need_attnmap=with_attnmap)
        hmap_nchw = heatmaps_to_nchw(hmap)
        count = _count(mask, cls_out.shape[0], cls_out.device, data_ranks)
        _, parts = multitask_loss(
            cls_out, hmap_nchw, data["label"], data["target"],
            data["target_weight"], sample_mask=mask,
            count=None if data_ranks is None else count)
        metrics, pred_label = _step_metrics(data, parts, cls_out, hmap_nchw,
                                            num_classes, mask, count,
                                            data_ranks)
        if return_outputs:
            return metrics, {
                "image": data["image"], "target": data["target"],
                "target_weight": data["target_weight"],
                "joints": data["joints"], "label": data["label"],
                "pred_label": pred_label, "heatmap": hmap_nchw,
                "attnmap": attn,
            }
        return metrics

    return eval_step
