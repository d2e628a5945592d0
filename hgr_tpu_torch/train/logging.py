"""Metric logging: JSON lines always, TensorBoard when it imports (port
of hgr_tpu/train/logging.py; reference train.py:98-104,224-226)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    """Appends ``{"step", "time", **scalars}`` lines to
    ``<log_dir>/<name>/metrics.jsonl``; mirrors them to a TensorBoard
    ``SummaryWriter`` in the same directory when one can be made."""

    def __init__(self, log_dir: str, name: str = "run"):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(self.dir)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
