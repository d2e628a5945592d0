"""Dynamic micro-batching and the classifier service."""

from hgr_tpu_torch.serve.engine import (
    ClassifierService,
    MicroBatcher,
    ServeMetrics,
)

__all__ = ["ClassifierService", "MicroBatcher", "ServeMetrics"]
