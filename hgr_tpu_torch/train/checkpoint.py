"""Best and last checkpoints (port of hgr_tpu/train/checkpoint.py; policy
of the reference's ModelCheckpoint, train.py:214-221: monitor
'val/total_loss', mode min, top 1, plus last).

A checkpoint is one ``torch.save`` file, ``<directory>/<name>.pt``,
holding the update count, the model's state dict (parameters and
BatchNorm statistics) and the AdamW state, so a run resumes exactly.
Saves copy every tensor to the host on the calling thread (the train
step updates the model and the optimizer state in place, so the copy
must be taken before the next step), then write on a background thread
to a temporary file renamed into place. Reading the JAX package's orbax
checkpoints is not ported (ROADMAP A7).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from hgr_tpu_torch.train.state import TrainState


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    """``best.pt`` and ``last.pt`` under ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
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

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def has_file(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def _save(self, name: str, state: TrainState,
              metric: Optional[float] = None) -> None:
        payload = {
            "step": int(state.step),
            "model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
        }
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
        save happened."""
        if self._best_metric is not None and monitored >= self._best_metric:
            return False
        self._best_metric = float(monitored)
        self._save("best", state, metric=self._best_metric)
        return True

    def restore(self, state: TrainState, name: str = "last") -> TrainState:
        """Load checkpoint ``name`` into ``state`` (model, optimizer, update
        count), in place; returns it."""
        self.wait()
        # the model and the optimizer move the tensors to their device
        payload = torch.load(self.path(name), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def has(self, name: str) -> bool:
        """Whether checkpoint ``name`` exists, counting an in-flight save."""
        self.wait()
        return self.has_file(name)
