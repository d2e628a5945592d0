"""Weight loading (port of hgr_tpu/infer/weights.py:57,77,172).

Classifier: a ``.npz`` written by the JAX package (``save_weights_npz``,
cli/convert.py) loads through the weight bridge, a reference Lightning
``.ckpt`` through ``utils/torch_port.py``, a ``.pt`` checkpoint of the
port's own training loop (``train/checkpoint.py``) as it is; an empty
path gives a seeded random init. An orbax directory that the JAX package
wrote (bare variables, or a training checkpoint's {step, params,
batch_stats, opt_state}) is read without JAX through
``utils/orbax_read.py``, which needs ``tensorstore``: where it is
missing (the card's machine), convert the run with
``cli/convert_orbax.py`` and load its ``.pt``. A state dict with int8
entries (``<module>.quant.*``, from an .npz with a 'quant' collection or
a quantized model's ``state_dict``) builds an int8 model in
``build_classifier``.

Detector: a ``.npz`` of Flax-path arrays, or a yolov7-tiny ``.onnx``
through the port's own reader and porter; an empty path gives a seeded
random init. Both loaders return a float32 CPU state_dict.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from hgr_tpu_torch.utils.convert import from_flax, load_weights_npz


def read_run_meta(path: str) -> Optional[Dict[str, Any]]:
    """The ``run_meta.json`` a training run writes beside its checkpoints
    (backbone, image_size, ...), searched in the checkpoint's directory
    and one level up (hgr_tpu/infer/weights.py:15); None where there is
    none or it does not parse."""
    if not path:
        return None
    p = os.path.abspath(path)
    dirs = ([os.path.dirname(p)] if not os.path.isdir(p)
            else [p, os.path.dirname(p)])
    for d in dirs:
        f = os.path.join(d, "run_meta.json")
        if os.path.exists(f):
            try:
                with open(f) as fh:
                    return json.load(fh)
            except (OSError, ValueError):
                return None
    return None


def resolve_image_size(path: str, flag_value,
                       default: Tuple[int, int] = (192, 192)
                       ) -> Tuple[int, int]:
    """Crop geometry for an inference entry point: the explicit flag, then
    the checkpoint's recorded run_meta.json, then ``default``
    (hgr_tpu/infer/weights.py:43)."""
    if flag_value:
        return (int(flag_value[0]), int(flag_value[1]))
    meta = read_run_meta(path)
    if meta and meta.get("image_size"):
        return tuple(int(v) for v in meta["image_size"])
    return tuple(default)


def infer_backbone_variant(state_dict: Dict[str, torch.Tensor]) -> str:
    """'small' or 'large' from a classifier state_dict's keys.

    The variants share every width and differ only in blocks-per-chain,
    so the extra ``cspelan1.cv2_1`` block is the discriminator
    (hgr_tpu/infer/weights.py:57)."""
    if not any(k.startswith("encoder.cspelan1.") for k in state_dict):
        raise ValueError(
            "not a MultiTaskNet classifier state_dict: missing "
            "encoder.cspelan1")
    large = any(k.startswith("encoder.cspelan1.cv2_1.") for k in state_dict)
    return "large" if large else "small"


def load_classifier_weights(path: str,
                            image_size: Tuple[int, int] = (192, 192),
                            backbone: str = "auto",
                            seed: int = 0) -> Dict[str, torch.Tensor]:
    """Classifier state_dict (CPU) from a .npz, a reference .ckpt, a
    training checkpoint .pt of the port or an orbax directory of the JAX
    package, or a seeded random init for an empty path ('auto' then means
    'small')."""
    if not path:
        from hgr_tpu_torch.models.multitasknet import MultiTaskNet

        model = MultiTaskNet(
            image_size=image_size,
            backbone="small" if backbone == "auto" else backbone,
            generator=torch.Generator().manual_seed(seed))
        return model.state_dict()
    if path.endswith(".npz"):
        loaded = from_flax(load_weights_npz(path))
    elif path.endswith(".ckpt"):
        from hgr_tpu_torch.utils.torch_port import load_reference_checkpoint

        loaded = load_reference_checkpoint(path)
    elif path.endswith(".pt"):
        loaded = torch.load(path, map_location="cpu",
                            weights_only=True)["model"]
    else:
        loaded = from_flax(orbax_variables(path))
    if backbone != "auto":
        found = infer_backbone_variant(loaded)
        if found != backbone:
            raise ValueError(
                f"backbone {backbone!r} requested but {path} holds a "
                f"{found!r} checkpoint (distinguished by the cspelan1/cv2_1 "
                "block)")
    return loaded


def orbax_variables(path: str) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of the orbax checkpoint at ``path``:
    bare variables, or the train-state payload of
    hgr_tpu/train/checkpoint.py:_save, whose step and optimizer state
    are dropped (hgr_tpu/infer/weights.py:_restore_orbax reads both)."""
    from hgr_tpu_torch.utils.orbax_read import read_orbax

    tree = read_orbax(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: an orbax checkpoint without 'params'")
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {}}


def build_classifier(state_dict: Dict[str, torch.Tensor],
                     image_size: Tuple[int, int] = (192, 192),
                     dtype: torch.dtype = torch.float32,
                     backbone: str = "auto", device="cuda",
                     **model_kwargs):
    """A MultiTaskNet in eval mode on ``device`` (the card unless the
    caller asks for the CPU; without a card, 'cuda' raises) holding
    ``state_dict`` (loaded with ``strict=True``): an int8 backbone where
    the state dict holds ``quant`` entries. ``model_kwargs`` go to the
    constructor (num_joints, num_classes, fused_attention)."""
    from hgr_tpu_torch.infer.quant import add_quant_slots
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet
    from hgr_tpu_torch.train.state import resolve_device

    device = resolve_device(device)

    if backbone == "auto":
        backbone = infer_backbone_variant(state_dict)
    model = MultiTaskNet(image_size=tuple(image_size), backbone=backbone,
                         dtype=dtype, **model_kwargs)
    add_quant_slots(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().to(device)


def load_detector_weights(path: str, seed: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """Detector state_dict (float32, CPU) from a .npz (Flax paths) or a
    yolov7-tiny .onnx, or a seeded random init for an empty path."""
    from hgr_tpu_torch.models.yolo import YOLOv7Tiny, load_npz_weights

    if path and path.endswith(".npz"):
        return from_flax(load_npz_weights(path))
    if path and path.endswith(".onnx"):
        from hgr_tpu_torch.utils.onnx_port import port_yolov7_tiny_onnx

        return from_flax(port_yolov7_tiny_onnx(path))
    if path:
        raise ValueError(f"{path}: detector weights are .npz or .onnx")
    return YOLOv7Tiny(num_classes=1, generator=torch.Generator().manual_seed(
        seed)).state_dict()
