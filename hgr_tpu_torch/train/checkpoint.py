"""Best and last checkpoints (port of hgr_tpu/train/checkpoint.py; policy
of the reference's ModelCheckpoint, train.py:214-221: monitor
'val/total_loss', mode min, top 1, plus last).

A checkpoint is one ``torch.save`` file, ``<directory>/<name>.pt``,
holding the update count, the model's state dict (parameters and
BatchNorm statistics) and the AdamW state, so a run resumes exactly.
Saves copy every tensor to the host on the calling thread (the train
step updates the model and the optimizer state in place, so the copy
must be taken before the next step), then write on a background thread
to a temporary file renamed into place. A checkpoint of the JAX package
(orbax, read without JAX by ``utils/orbax_read.py``) becomes this
payload through ``payload_from_jax``; ``cli/convert_orbax.py``
converts a JAX run directory so that ``--resume`` continues it.

One file format for every mesh. With a ``mesh``, a save first gathers the
full state (``parallel/tp.py:gather_state``, a collective over the model
group, on the calling thread of every rank) and only the coordinator
writes it; a restore waits for the coordinator's write (a barrier), then
every rank reads the full file and cuts its own shard. So a checkpoint
of a 2x2 run restores on one rank, and back. The best metric seeded from
disk and the answer of ``has`` are the coordinator's on every rank (JAX
checkpoint.py:49-60, loop.py:398).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from hgr_tpu_torch.parallel import distributed
from hgr_tpu_torch.parallel.tp import gather_state, shard_state
from hgr_tpu_torch.train.state import TrainState
from hgr_tpu_torch.utils.convert import from_flax


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state: TrainState) -> dict:
    """The state as a checkpoint holds it (tensors by reference)."""
    return {"step": int(state.step), "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Load a payload of the state's own shapes into it, in place (the
    model and the optimizer move the tensors to their device)."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def _adam_state(opt_state: Any) -> dict:
    """optax.adamw's ``ScaleByAdamState`` (count, mu, nu) in the restored
    ``opt_state`` chain (hgr_tpu/train/state.py:67-68: scale_by_adam,
    add_decayed_weights, scale_by_learning_rate)."""
    for part in opt_state if isinstance(opt_state, list) else [opt_state]:
        if isinstance(part, dict) and {"count", "mu", "nu"} <= part.keys():
            return part
    raise ValueError("the JAX optimizer state holds no Adam moments "
                     "(count, mu, nu)")


def payload_from_jax(tree: dict, state: TrainState) -> dict:
    """The JAX package's train-state checkpoint ``tree`` ({step, params,
    batch_stats, opt_state}, hgr_tpu/train/checkpoint.py:_save, as
    ``read_orbax`` returns it) as this module's payload for ``state``
    (whose model fixes the parameters' order in the optimizer state, and
    whose optimizer gives the hyperparameters).

    Adam's ``mu`` and ``nu`` become each parameter's ``exp_avg`` and
    ``exp_avg_sq`` through ``from_flax``, with their parameter's renaming
    and transposes; its ``count`` becomes each parameter's ``step``. The
    group's lr is left as ``state`` has it: ``TrainState.apply_gradients``
    sets it from the resuming run's schedule at the step before every
    update."""
    model = state.model
    step = int(tree["step"])
    model_sd = from_flax({"params": tree["params"],
                          "batch_stats": tree.get("batch_stats") or {}})
    want = model.state_dict()
    if want.keys() != model_sd.keys() or any(
            want[k].shape != model_sd[k].shape for k in want):
        diff = sorted(set(want) ^ set(model_sd)) or sorted(
            k for k in want if want[k].shape != model_sd[k].shape)
        raise ValueError(f"the JAX checkpoint does not fit the model: "
                         f"{diff[:5]}")
    adam = _adam_state(tree["opt_state"])
    mu = from_flax({"params": adam["mu"]})
    nu = from_flax({"params": adam["nu"]})
    count = torch.tensor(float(adam["count"]), dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    optimizer = state.optimizer.state_dict()
    optimizer["state"] = {
        i: {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, n in enumerate(names)}
    return {"step": step, "model": model_sd, "optimizer": optimizer}


def best_or_last(save_path: str) -> str:
    """The checkpoint a finished run under ``save_path`` leaves to deploy:
    its best, else its last (a run whose validation never improved)."""
    best = os.path.join(save_path, "weight", "best.pt")
    return best if os.path.exists(best) else os.path.join(
        save_path, "weight", "last.pt")


class CheckpointManager:
    """``best.pt`` and ``last.pt`` under ``directory``; ``mesh``: this
    rank's place on a mesh (the module docstring)."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: list = []
        # Seed 'best' from disk so that a resumed run cannot replace the
        # best checkpoint with a worse first epoch; trust the recorded
        # metric only if the checkpoint it describes exists.
        self._best_metric: Optional[float] = None
        best_file = os.path.join(self.directory, "best_metric.txt")
        if self.has_file("best") and os.path.exists(best_file):
            try:
                with open(best_file) as f:
                    self._best_metric = float(f.read().strip())
            except (OSError, ValueError):
                pass
        if mesh is not None:
            seeded = distributed.coordinator_value(
                float("nan") if self._best_metric is None
                else self._best_metric)
            self._best_metric = None if seeded != seeded else seeded

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def has_file(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def _save(self, name: str, state: TrainState,
              metric: Optional[float] = None) -> None:
        payload = state_payload(state)
        if self.mesh is not None:
            payload = gather_state(payload, self.mesh, state.model)
            if not distributed.is_coordinator():
                return
        payload = _to_host(payload)
        self.wait()
        path = self.path(name)

        def commit():
            try:
                tmp = f"{path}.{os.getpid()}.tmp"
                torch.save(payload, tmp)
                os.replace(tmp, path)
                # the metric only after the checkpoint it describes: a save
                # cut short must not label the previous best.pt with it
                if metric is not None:
                    with open(os.path.join(self.directory,
                                           "best_metric.txt"), "w") as f:
                        f.write(str(metric))
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._error.append(e)

        self._writer = threading.Thread(target=commit,
                                        name=f"ckpt-write-{name}")
        self._writer.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) has committed; raise its
        error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error:
            raise self._error.pop()

    def save_last(self, state: TrainState) -> None:
        self._save("last", state)

    def maybe_save_best(self, state: TrainState, monitored: float) -> bool:
        """Save as best when ``monitored`` improves (min mode); whether a
        save happened (the coordinator's decision on every rank)."""
        better = self._best_metric is None or monitored < self._best_metric
        if self.mesh is not None:
            better = distributed.coordinator_decision(better)
            monitored = distributed.coordinator_value(monitored)
        if not better:
            return False
        self.save_best(state, monitored)
        return True

    def save_best(self, state: TrainState, metric: Optional[float]) -> None:
        """Save ``state`` as best with ``metric`` recorded beside it (none
        where ``metric`` is None), whatever the recorded best."""
        self._best_metric = None if metric is None else float(metric)
        self._save("best", state, metric=self._best_metric)

    def restore(self, state: TrainState, name: str = "last") -> TrainState:
        """Load checkpoint ``name`` into ``state`` (model, optimizer, update
        count), in place; returns it. With a mesh every rank reads the full
        file after the coordinator's write and loads its own shard."""
        self.wait()
        if self.mesh is None:
            return load_payload(state, self._read(name))
        distributed.barrier()
        return load_payload(state, shard_state(self._read(name), self.mesh,
                                               state.model))

    def _read(self, name: str) -> dict:
        return torch.load(self.path(name), map_location="cpu",
                          weights_only=True)

    def has(self, name: str) -> bool:
        """Whether checkpoint ``name`` exists, counting an in-flight save
        (the coordinator's answer on every rank)."""
        self.wait()
        found = self.has_file(name)
        return (distributed.coordinator_decision(found)
                if self.mesh is not None else found)
