"""Weight bridge between the JAX package's Flax variable tree and the
port's ``state_dict``.

``from_flax`` walks ``{"params": ..., "batch_stats": ...}`` (numpy or any
array type numpy can read) and joins the module path with dots:

* conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw), and dense
  ``kernel`` (I, O) -> ``weight`` (O, I), as infer/onnx_export.py:40-59
  transposes them. The packed ``to_qkv`` columns (q | k | v, each
  head-major) become weight rows in the same order;
* LayerNorm/BatchNorm ``scale`` -> ``weight``; ``bias``, ``cls_token``
  and the BatchNorm statistics ``mean``/``var`` are copied as they are;
* the int8 ``quant`` collection (hgr_tpu/infer/quant.py) -> the
  ``<module>.quant.<leaf>`` buffers of ``models/layers.py:QuantConv``, in
  their own dtypes: ``kernel_q`` int8 in the JAX (k, k, Cin, Cout) order,
  ``act_scale``, ``out_scale`` and ``bias`` float32.

Every other leaf becomes float32. ``to_flax`` is the exact inverse.
``load_weights_npz`` reads the flat ``collection/path/leaf`` .npz that
hgr_tpu/infer/export.py:133 ``save_weights_npz`` (and cli/convert.py)
writes, without JAX, and ``save_weights_npz`` writes one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_STATS = ("mean", "var")
_QUANT = "quant"  # the module name of QuantConv and the Flax collection


def _leaf_to_torch(name: str, a: np.ndarray):
    if name == "kernel":
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return "weight", a.transpose(1, 0)
        raise ValueError(f"kernel of rank {a.ndim} has no torch layout")
    if name == "scale":
        return "weight", a
    return name, a


def from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables -> the port's state_dict (CPU tensors: float32, and
    the ``quant`` leaves in their own dtypes)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            name, a = _leaf_to_torch(k, np.asarray(v, np.float32))
            out[".".join(path + (name,))] = torch.from_numpy(
                np.ascontiguousarray(a).copy())

    def walk_quant(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk_quant(v, path + (k,))
            else:
                out[".".join(path + (_QUANT, k))] = torch.from_numpy(
                    np.array(v))

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    walk_quant(variables.get(_QUANT, {}), ())
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict -> Flax variables of numpy float32 arrays (and
    a ``quant`` collection in its own dtypes where the model holds one)."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        if path and path[-1] == _QUANT:
            node = tree.setdefault(_QUANT, {})
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[name] = t.detach().cpu().numpy().copy()
            continue
        a = t.detach().cpu().float().numpy()
        if name in _STATS:
            coll = "batch_stats"
        else:
            coll = "params"
            if name == "weight":
                if a.ndim == 4:
                    name, a = "kernel", a.transpose(2, 3, 1, 0)
                elif a.ndim == 2:
                    name, a = "kernel", a.transpose(1, 0)
                else:
                    name = "scale"
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def load_weights_npz(path: str) -> Dict[str, Any]:
    """Flat 'collection/path/leaf' .npz -> nested dict of numpy arrays
    (hgr_tpu/infer/export.py:148)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as raw:
        for key in raw.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = raw[key]
    return tree


def save_weights_npz(variables: Mapping[str, Any], path: str) -> None:
    """A nested tree of arrays -> an .npz of 'collection/path/leaf' arrays
    (hgr_tpu/infer/export.py:133's format, which both packages load)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    walk(variables, "")
    np.savez(path, **flat)
