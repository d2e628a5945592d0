"""Annotation index for the extracted-HaGRID JSON format (port of
hgr_tpu/data/dataset.py; reference libs/load.py:208-228 ``read_data``).

A split is a directory of ``*.json`` files, each mapping image_id ->
{"label": str, "landmark": [[x, y], ...]} with landmarks normalized to
the crop; images live at ``<json_dir>/../../<json_stem>/<image_id>.jpg``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Sample:
    image_path: str
    landmark: List[List[float]]  # normalized [0,1] coords, possibly empty
    label: str


@dataclasses.dataclass
class AnnotationIndex:
    samples: List[Sample]
    names: Dict[str, int]

    def __len__(self) -> int:
        return len(self.samples)

    def labels(self) -> np.ndarray:
        return np.asarray([self.names[s.label] for s in self.samples],
                          np.int32)


def read_annotations(data_dir: str, names: Dict[str, int]) -> AnnotationIndex:
    """The ground-truth index of one split, files in sorted order; raises
    if the directory holds no json file (reference libs/load.py:209-210)."""
    json_paths = sorted(glob.glob(os.path.join(data_dir, "*.json")))
    if not json_paths:
        raise FileNotFoundError(
            f"json files which store annotations are not found in {data_dir}")

    samples: List[Sample] = []
    for json_path in json_paths:
        with open(json_path) as f:
            data = json.load(f)
        root = Path(json_path).parents[2]
        name = Path(json_path).stem
        for image_id, annots in data.items():
            samples.append(Sample(
                image_path=os.path.join(root, name, image_id + ".jpg"),
                landmark=annots["landmark"],
                label=annots["label"],
            ))
    return AnnotationIndex(samples=samples, names=dict(names))
