"""Train state and optimizer schedule (port of hgr_tpu/train/state.py;
reference train.py:49-56).

AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay 0.01 on every
parameter, as ``optax.adamw`` applies it) with a MultiStep schedule in
optimizer steps. The JAX state is an immutable pytree; here the model,
its BatchNorm statistics and the optimizer state are updated in place,
and ``TrainState`` holds them with the update count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch
from torch import nn

Schedule = Callable[[int], float]


def multistep_lr(base_lr: float, milestones_steps: Sequence[int],
                 factor: float) -> Schedule:
    """lr(count) = base_lr · factor^(number of milestones <= count), where
    ``count`` is the number of updates before this one: update 0 takes
    the base lr and update ``m`` is the first scaled one, as
    ``optax.piecewise_constant_schedule`` (torch MultiStepLR in steps)."""
    milestones = sorted(int(m) for m in milestones_steps)

    def schedule(count: int) -> float:
        lr = base_lr
        for m in milestones:
            if count >= m:
                lr *= factor
        return lr

    return schedule


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} but torch sees no CUDA card; pass "
            "device='cpu' to train on the CPU")
    return dev


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics, on ``device``), its
    optimizer, the lr schedule and the number of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        """One AdamW update from ``grads`` (name -> f32 tensor), at the
        schedule's lr for the current count; in place."""
        for name, p in self.model.named_parameters():
            p.grad = grads[name].to(p.dtype)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def adamw(params, lr: float, weight_decay: float = 0.01
          ) -> torch.optim.Optimizer:
    """The recipe's AdamW over ``params``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, lr: float = 1e-3,
                       milestones_steps: Sequence[int] = (),
                       lr_factor: float = 0.1, weight_decay: float = 0.01,
                       device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) and give it AdamW with the MultiStep schedule."""
    model = model.to(resolve_device(device))
    schedule = multistep_lr(lr, milestones_steps, lr_factor)
    optimizer = adamw(model.parameters(), schedule(0), weight_decay)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
