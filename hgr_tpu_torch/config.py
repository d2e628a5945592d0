"""Configuration dataclasses + YAML loading (port of hgr_tpu/config.py).

The data config (class names, joint/class counts, augment factors), the
model hyper-parameters and the training recipe. ``yaml`` is
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

    The precision knobs keep the JAX package's names and meaning
    (``models.MultiTaskNet.from_config`` builds the model); the stride-2
    lowering is a constructor field of the model only, as in JAX.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe (reference train.py:244-283 defaults + README.md:62-71)
    with the JAX package's names and defaults (hgr_tpu/config.py:139-166):
    the fields that ``cli.train.run`` and ``train.loop.fit`` read. Not
    ported: ``steps_per_epoch``, which nothing reads (an epoch is one pass
    of the train loader).
    """

    batch_size: int = 32
    epochs: int = 50
    lr: float = 1e-3
    lr_step: Tuple[int, ...] = (30, 40)
    lr_factor: float = 0.1
    sigma: float = 2.0
    seed: int = 42
    class_loss_weight: float = 0.001  # reference train.py:63
    num_workers: int = 8
    log_dir: str = "logs"
    save_dir: str = "output"
    # the mesh of ranks, e.g. {'data': 8} or {'data': 4, 'model': 2};
    # None = one device (parallel/mesh.py)
    mesh_shape: Optional[Dict[str, int]] = None
    canvas_size: int = 256  # host staging canvas (square)
    # debug image dump cadence in train batches (reference train.py:149)
    debug_every: int = 100
    # Sequential microbatches per optimizer step (train/steps.py).
    grad_accum: int = 1
    # De-mixed task-gradient pullbacks (train/steps.make_train_step):
    # 'auto' = on iff the model computes in bf16, where the merged
    # cotangent stream drowns the CE x 0.001 classification gradient.
    grad_demix: str = "auto"  # 'auto' | 'on' | 'off' | 'batched'


# ImageNet normalization constants applied to (BGR-ordered!) images — the
# reference normalizes BGR data with RGB-ordered stats (libs/load.py:46-50
# after cv2.imread BGR); kept as is for weight parity.
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)
