"""Model export and the evaluation through the exported graph (port of
hgr_tpu/infer/export.py:27-157).

The reference exports a 2-output forward (class logits, heatmap; the
attention map dropped, reference export.py:43-45,72-74) and evaluates
the whole test split through the exported artifact: macro F1 and the
mean latency per image (export.py:83-119). The JAX package's artifact is
serialized StableHLO; the port's is a ``torch.export`` program saved as
``.pt2``. Its graph holds the attention forward as one node of the
registered operator ``hgr_tpu_torch::attention_qkv_fwd``, so the loaded
program launches the hand-written kernel on the card: import
``hgr_tpu_torch.ops.attention`` before ``torch.export.load``
(``load_program`` does). The int8 backbone exports too: its buffers are
the program's constants and its conv is ``aten._int_mm``.

The weights bundle beside an artifact is ``utils/convert.py``'s
``save_weights_npz`` (the format both packages load).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from hgr_tpu_torch.models.multitasknet import MultiTaskNet, heatmaps_to_nchw


class InferenceModule(nn.Module):
    """The deployed 2-output forward: (B, H, W, 3) float32 NHWC ->
    (logits (B, C), heatmap (B, J, H/4, W/4)), ``need_attnmap=False``
    (hgr_tpu/infer/export.py:27)."""

    def __init__(self, model: MultiTaskNet):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        logits, hmap, _ = self.model(x, need_attnmap=False)
        return logits, heatmaps_to_nchw(hmap)


def make_inference_fn(model: MultiTaskNet) -> InferenceModule:
    """The 2-output inference forward of ``model`` (in eval mode)."""
    return InferenceModule(model).eval()


def export_program(model: MultiTaskNet, path: str, batch: int = 1) -> str:
    """``torch.export`` the 2-output forward on a static (batch, H, W, 3)
    float32 NHWC input on the model's device, and save it to ``path``
    (.pt2): the counterpart of ``export_stablehlo`` (export.py:40)."""
    h, w = model.image_size
    device = next(model.parameters()).device
    example = torch.zeros(batch, h, w, 3, device=device)
    with torch.no_grad():
        program = torch.export.export(make_inference_fn(model), (example,))
    torch.export.save(program, path)
    return path


def load_program(path: str) -> nn.Module:
    """The saved program as a callable module (on the device it was
    exported on). Registers the port's operators first."""
    import hgr_tpu_torch.ops.attention  # noqa: F401 — registers the ops

    return torch.export.load(path).module()


def program_ops(module: nn.Module) -> Dict[str, int]:
    """Call targets of a loaded program's graph -> their counts."""
    counts: Dict[str, int] = {}
    for node in module.graph.nodes:
        if node.op == "call_function":
            name = str(node.target)
            counts[name] = counts.get(name, 0) + 1
    return counts


def split_loader(data_cfg, split: str, batch: int, canvas_size: int = 256):
    """The eval loader of one split of ``data_cfg`` (in order, the tail
    padded and masked by 'valid'), for ``eval_exported`` and for
    calibration crops."""
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.loader import BatchLoader

    idx = read_annotations(os.path.join(data_cfg.path, split),
                           data_cfg.names)
    return BatchLoader(idx, batch_size=batch, canvas_size=canvas_size,
                       num_joints=data_cfg.num_joints, shuffle=False,
                       drop_last=False, num_workers=4)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_exported(fn: Callable, loader, num_classes: int = 19,
                  image_size=(192, 192), device="cuda") -> Dict[str, float]:
    """The whole split of ``loader`` through ``fn`` (an exported graph, or
    any (B, H, W, 3) -> (logits, heatmap) callable on ``device``): macro
    F1 and the mean latency per image (export.py:73). The crops are made
    on ``device`` by the eval transform (identity augment, no jitter: on
    the card the warp kernel). Only ``fn`` is timed: the preprocessing is
    waited out first, and the first batch warms ``fn`` outside the timed
    window."""
    from hgr_tpu_torch.data.pipeline import (
        apply_augment_batch,
        identity_params,
    )
    from hgr_tpu_torch.ops.metrics import (
        confusion_update,
        macro_f1_from_confusion,
    )
    from hgr_tpu_torch.train.loop import to_device

    device = torch.device(device)
    conf = torch.zeros((num_classes, num_classes), device=device)
    total_time = 0.0
    n_images = 0
    warmed = False
    with torch.no_grad():
        for batch in loader:
            # 'valid' is a per-sample mask (ones then zeros for tail padding)
            mask = batch.pop("valid", None)
            valid = (int(np.asarray(mask).sum()) if mask is not None
                     else len(batch["label"]))
            b = to_device(batch, device)
            images = apply_augment_batch(
                b["canvas"], b["orig_to_canvas"], b["sizes_hw"], b["joints"],
                b["joints_vis"], identity_params(len(b["label"]), device),
                image_size=tuple(image_size),
                heatmap_size=(image_size[0] // 4, image_size[1] // 4),
                enable_jitter=False)["image"]
            _sync(device)
            if not warmed:
                fn(images)
                _sync(device)
                warmed = True
            t0 = time.perf_counter()
            logits, _ = fn(images)
            _sync(device)
            total_time += time.perf_counter() - t0
            preds = torch.argmax(logits, dim=-1)[:valid]
            conf = confusion_update(conf, b["label"][:valid], preds)
            n_images += valid
    return {
        "test_f1": float(macro_f1_from_confusion(conf)),
        "mean_latency_s": total_time / max(n_images, 1),
        "images": n_images,
    }
