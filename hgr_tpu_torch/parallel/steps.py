"""Train and eval steps of one rank of a mesh (port of
hgr_tpu/parallel/steps.py).

The JAX package jits its single-device step with shardings and lets GSPMD
insert the collectives. Here every rank runs the port's own step
(train/steps.py) on its rows of the global batch, with ``DataRanks`` as
the hooks that make it one part of the global step:

- the augment draw is the global batch's, from the same generator on
  every rank, each rank taking its rows;
- each rank's loss is (local sum) / (global valid count), so the ranks'
  losses add up to the global loss; the loss parts, the confusion, the
  valid count and the PCK counts are summed over the data group, and F1
  is computed from the global confusion;
- after the two de-mixed pullbacks (``torch.autograd.grad``, which DDP's
  hooks do not follow, so there is no DDP wrapper) and their f32
  combine, one flat f32 ``all_reduce`` sums the gradients over the data
  group: the one all-reduce XLA compiles. The model group is not reduced
  over: replicated parameters already carry the same gradient on every
  model rank, given the Megatron pair of ``parallel/tp.py``;
- BatchNorm takes its statistics over the data group (models/layers.py).

``shard_state`` turns a full train state into this rank's: the ViT's
sharded parameters (and their AdamW moments) cut by ``parallel/tp.py``,
the BatchNorm layers synced over the data group.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.models.layers import sync_batch_stats
from hgr_tpu_torch.parallel import tp
from hgr_tpu_torch.parallel.collectives import all_sum
from hgr_tpu_torch.parallel.mesh import Mesh
from hgr_tpu_torch.train import steps as base_steps
from hgr_tpu_torch.train.checkpoint import load_payload, state_payload
from hgr_tpu_torch.train.state import TrainState, adamw


class DataRanks:
    """This rank's place on the mesh's data axis and the sums over it."""

    def __init__(self, mesh: Mesh):
        self.index, self.size = mesh.data_index, mesh.data_size
        self.group = mesh.data_group

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_sum(t, self.group)

    def sum_grads(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The f32 gradients summed over the data group in one flat
        all-reduce."""
        if self.group is None:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        dist.all_reduce(flat, group=self.group)
        out, at = {}, 0
        for k, g in grads.items():
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return out


def shard_state(state: TrainState, mesh: Mesh,
                tensor_parallel: bool = False) -> TrainState:
    """This rank's train state from a full one built alike on every rank
    (same seed): BatchNorm synced over the data group and, with
    ``tensor_parallel``, the decoder cut to the rank's shard with a new
    optimizer over the new parameters holding the cut AdamW state."""
    sync_batch_stats(state.model, mesh.data_group)
    if not tensor_parallel:
        return state
    full = state_payload(state)
    tp.make_tensor_parallel(state.model, mesh)
    opt = state.optimizer.defaults
    state.optimizer = adamw(state.model.parameters(), opt["lr"],
                            opt["weight_decay"])
    return load_payload(state, tp.shard_state(full, mesh, state.model))


def make_parallel_train_step(mesh: Mesh, aug_cfg: AugmentConfig,
                             num_classes: int = 19, sigma: float = 2.0,
                             image_size=(192, 192), heatmap_size=(48, 48),
                             class_loss_weight: float = 0.001,
                             grad_accum: int = 1, grad_demix=False,
                             debug_return_grads: bool = False,
                             warp_method: str = "auto") -> Callable:
    """``step(state, batch, generator)`` of this rank: ``batch`` is its
    rows of the global batch (``mesh.shard_batch`` or the loader's rank
    slice, which with ``grad_accum`` holds its share of every
    microbatch), ``generator`` the same on every rank. Tensor parallelism
    lives in the state's model (``shard_state``)."""
    return base_steps.make_train_step(
        aug_cfg, num_classes=num_classes, sigma=sigma, image_size=image_size,
        heatmap_size=heatmap_size, class_loss_weight=class_loss_weight,
        grad_accum=grad_accum, grad_demix=grad_demix,
        debug_return_grads=debug_return_grads, warp_method=warp_method,
        data_ranks=DataRanks(mesh))


def make_parallel_eval_step(mesh: Mesh, num_classes: int = 19,
                            sigma: float = 2.0, image_size=(192, 192),
                            heatmap_size=(48, 48),
                            return_outputs: bool = False,
                            with_attnmap: Optional[bool] = None,
                            warp_method: str = "auto") -> Callable:
    """``eval_step(state, batch)`` of this rank, with the global batch's
    metrics; the outputs of ``return_outputs`` are the rank's rows. Under
    a model axis the attention map (``with_attnmap``) holds every head:
    each rank's head group gathered over the model group."""
    return base_steps.make_eval_step(
        num_classes=num_classes, sigma=sigma, image_size=image_size,
        heatmap_size=heatmap_size, return_outputs=return_outputs,
        with_attnmap=with_attnmap, warp_method=warp_method,
        data_ranks=DataRanks(mesh))
