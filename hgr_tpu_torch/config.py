"""Configuration dataclasses + YAML loading (port of hgr_tpu/config.py).

Only the classifier's serving surface is ported: the data config (class
names, joint/class counts) and the model hyper-parameters. ``yaml`` is
imported inside ``load_data_config``, so the package runs where pyyaml
is not installed as long as no YAML file is read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Stochastic augmentation factors (reference configs/hagrid.yaml
    :33-39)."""

    rotate_factor: float = 20.0
    scale_factor: float = 0.35
    translate_factor: float = 0.02
    horizontal_flip: bool = True
    color_jittering: bool = True
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset description (reference configs/hagrid.yaml)."""

    path: str = "data/hagrid_small"
    train: str = "annotations/train"
    val: str = "annotations/val"
    test: str = "annotations/test"
    num_joints: int = 21
    num_classes: int = 19
    names: Dict[str, int] = dataclasses.field(default_factory=dict)
    augments: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)

    @property
    def id_to_name(self) -> Dict[int, str]:
        return {v: k for k, v in self.names.items()}


# The 19 HaGRID gesture classes (reference configs/hagrid.yaml:11-31).
DEFAULT_NAMES: Dict[str, int] = {
    "call": 0, "dislike": 1, "fist": 2, "four": 3, "like": 4, "mute": 5,
    "ok": 6, "one": 7, "palm": 8, "peace": 9, "peace_inverted": 10,
    "rock": 11, "stop": 12, "stop_inverted": 13, "three": 14, "three2": 15,
    "two_up": 16, "two_up_inverted": 17, "no_gesture": 18,
}


def load_data_config(path: str) -> DataConfig:
    """Load a reference-format YAML data config (configs/hagrid.yaml)."""
    import yaml

    with open(path, "r") as stream:
        raw = yaml.safe_load(stream)
    aug_raw = raw.get("augments", {}) or {}
    augments = AugmentConfig(
        rotate_factor=float(aug_raw.get("rotate_factor", 0.0)),
        scale_factor=float(aug_raw.get("scale_factor", 0.0)),
        translate_factor=float(aug_raw.get("translate_factor", 0.0)),
        horizontal_flip=bool(aug_raw.get("horizontal_flip", False)),
        color_jittering=bool(aug_raw.get("color_jittering", False)),
    )
    return DataConfig(
        path=raw.get("path", ""),
        train=raw.get("train", ""),
        val=raw.get("val", ""),
        test=raw.get("test", ""),
        num_joints=int(raw["num_joints"]),
        num_classes=int(raw["num_classes"]),
        names=dict(raw.get("names", DEFAULT_NAMES)),
        augments=augments,
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MultiTaskNet hyper-parameters (reference model/multitasknet.py:9-22).

    The precision and lowering knobs keep the JAX package's names; the
    ones not ported yet are refused by ``models.MultiTaskNet``.
    """

    num_joints: int = 21
    num_classes: int = 19
    image_size: Tuple[int, int] = (192, 192)  # (H, W)
    backbone: str = "small"  # GELAN variant: 'small' | 'large'
    dim: int = 256
    depth: int = 4
    heads: int = 8
    head_dim: int = 32
    mlp_dim: int = 256
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    decoder_dtype: Optional[str] = None
    early_dtype: Optional[str] = None
    early_units: int = 3
    fused_attention: Any = True
    remat: bool = False

    @property
    def feature_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // 16, self.image_size[1] // 16)

    @property
    def heatmap_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // 4, self.image_size[1] // 4)


# ImageNet normalization constants applied to (BGR-ordered!) images — the
# reference normalizes BGR data with RGB-ordered stats (libs/load.py:46-50
# after cv2.imread BGR); kept as is for weight parity.
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)
