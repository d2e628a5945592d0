"""Dynamic micro-batching, the classifier service and the detector
service."""

from hgr_tpu_torch.serve.engine import (
    ClassifierService,
    DetectorService,
    MicroBatcher,
    ServeMetrics,
)

__all__ = ["ClassifierService", "DetectorService", "MicroBatcher",
           "ServeMetrics"]
