"""The reference's 2-output ``.onnx`` of the classifier (port of
hgr_tpu/infer/onnx_export.py:250-318).

The reference ships its model as a static-shape ONNX file (reference
export.py:72-78: a 1x3x192x192 NCHW input named ``input``, outputs
``label_pred`` (B, classes) and ``heatmap_pred`` (B, joints, H/4, W/4),
the attention map dropped). The JAX package traces a functional torch
mirror of its Flax model for it; the port's model is torch already, so
this exports the port's own ``MultiTaskNet``: float32 on the CPU, with
the ViT built with ``fused_attention=False`` (the unfused chain), so
that only standard operators reach the TorchScript exporter
(``torch.onnx.export(dynamo=False)``, opset 13, constant folding). An
int8 state in the weights is not exported: the file is the float model,
as the JAX package's mirror reads only params and batch_stats.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from hgr_tpu_torch.models.multitasknet import MultiTaskNet, heatmaps_to_nchw


class OnnxModule(nn.Module):
    """NCHW (B, 3, H, W) float32 -> (label_pred, heatmap_pred NCHW)."""

    def __init__(self, model: MultiTaskNet):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        logits, hmap, _ = self.model(x.permute(0, 2, 3, 1),
                                     need_attnmap=False)
        return logits, heatmaps_to_nchw(hmap)


def _ensure_onnx_stub():
    """``torch.onnx.export`` scans for custom onnxscript functions through
    the ``onnx`` package, which this package does not require. The scan
    does not apply here (no custom-domain operators) and returns the
    serialized bytes unchanged, so when ``onnx`` is missing a minimal stub
    short-circuits it; the file itself comes from torch's C++ serializer
    (hgr_tpu/infer/onnx_export.py:250-279). Returns an undo callable."""
    import sys
    import types

    if "onnx" in sys.modules:
        return lambda: None
    try:
        import onnx  # noqa: F401

        return lambda: None
    except ImportError:
        pass
    stub = types.ModuleType("onnx")

    class _Graph:
        node = ()

    class _Model:
        graph = _Graph()
        functions = []

    stub.load_model_from_string = lambda b: _Model()
    sys.modules["onnx"] = stub
    return lambda: sys.modules.pop("onnx", None)


def export_onnx(state_dict: Dict[str, torch.Tensor], path: str, *,
                num_joints: int = 21, num_classes: int = 19,
                image_size: Sequence[int] = (192, 192),
                backbone: str = "small", batch: int = 1,
                opset: int = 13) -> OnnxModule:
    """Write the reference-signature .onnx (static (batch, 3, H, W) input
    ``input``, outputs ``label_pred`` and ``heatmap_pred``) to ``path``;
    returns the traced module, so that callers evaluate the exported
    function without building it again."""
    model = MultiTaskNet(num_joints=num_joints, num_classes=num_classes,
                         image_size=tuple(image_size), backbone=backbone,
                         fused_attention=False)
    model.load_state_dict({k: v for k, v in state_dict.items()
                           if ".quant." not in f".{k}"}, strict=True)
    module = OnnxModule(model).eval()
    dummy = torch.zeros(batch, 3, image_size[0], image_size[1])
    undo_stub = _ensure_onnx_stub()
    try:
        with torch.no_grad():
            torch.onnx.export(
                module, (dummy,), path,
                input_names=["input"],
                output_names=["label_pred", "heatmap_pred"],
                opset_version=opset,
                do_constant_folding=True,
                dynamo=False,
            )
    finally:
        undo_stub()
    return module
