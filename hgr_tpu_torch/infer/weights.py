"""Classifier weight loading (port of hgr_tpu/infer/weights.py:57,77).

A ``.npz`` written by the JAX package (``save_weights_npz``,
cli/convert.py) loads through the weight bridge; an empty path gives a
seeded random init. Orbax directories and reference ``.ckpt`` files are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hgr_tpu_torch.utils.convert import from_flax, load_weights_npz


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
    """Classifier state_dict (float32, CPU) from a .npz, or a seeded
    random init for an empty path ('auto' then means 'small')."""
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
        raise NotImplementedError(
            f"{path}: reference .ckpt loading is not ported yet "
            "(ROADMAP A8); convert it to .npz with the JAX package's "
            "cli/convert.py")
    else:
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not ported yet "
            "(ROADMAP A7); export the weights to .npz with the JAX "
            "package's save_weights_npz")
    if backbone != "auto":
        found = infer_backbone_variant(loaded)
        if found != backbone:
            raise ValueError(
                f"backbone {backbone!r} requested but {path} holds a "
                f"{found!r} checkpoint (distinguished by the cspelan1/cv2_1 "
                "block)")
    return loaded
