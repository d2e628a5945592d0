"""Read an orbax checkpoint directory without JAX or orbax.

``orbax.checkpoint.StandardCheckpointer`` (hgr_tpu/train/checkpoint.py,
hgr_tpu/infer/weights.py) writes a directory whose ``_METADATA`` is JSON:
``tree_metadata`` maps each leaf to its ``key_metadata`` (the path from
the root: ``key_type`` 2 is a dict key or a named-tuple field, 1 a
sequence index) and its ``value_metadata`` (``value_type``: an array
type, ``scalar``, or an empty node such as ``None``). The arrays are zarr
arrays named by the path's keys joined with '.', inside one OCDBT
key-value store (``use_ocdbt``) or one directory each, in the zarr v2 or
v3 format (``use_zarr3``). ``tensorstore`` reads them as they were
written.

The reader needs ``tensorstore``, which comes with orbax: run it where
the JAX run was written (``python -m hgr_tpu_torch.cli.convert_orbax``),
and take the ``.pt`` files it writes to the card.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

_DICT_KEY, _SEQ_INDEX = 2, 1
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": tuple,
          "NamedTuple": None}


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint needs the 'tensorstore' package "
            "(it comes with orbax-checkpoint); run the conversion where "
            "the JAX run was written (python -m "
            "hgr_tpu_torch.cli.convert_orbax <save_path>) and take the "
            ".pt files it writes to the card") from e
    return tensorstore


def _spec(path: str, name: str, ocdbt: bool, zarr3: bool) -> dict:
    driver = "zarr3" if zarr3 else "zarr"
    if ocdbt:
        kvstore = {"driver": "ocdbt", "base": f"file://{path}"}
        return {"driver": driver, "kvstore": kvstore, "path": name}
    return {"driver": driver,
            "kvstore": {"driver": "file", "path": os.path.join(path, name)}}


def _nest(entries: List[Tuple[list, Any]]) -> Any:
    """(key_metadata, value) pairs -> the nested tree: dict keys as dicts,
    sequence indices as lists in index order."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}  # id(node) -> key_type of its children

    for keys, value in entries:
        node = root
        for depth, km in enumerate(keys):
            kind = int(km["key_type"])
            if kind not in (_DICT_KEY, _SEQ_INDEX):
                raise ValueError(f"key {km} has an unknown key_type")
            if kinds.setdefault(id(node), kind) != kind:
                raise ValueError(f"mixed key types under {keys[:depth]}")
            key = int(km["key"]) if kind == _SEQ_INDEX else km["key"]
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def finish(node):
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == _SEQ_INDEX:
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sequence indices {sorted(node)} have gaps")
            return [finish(node[i]) for i in range(len(node))]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def read_orbax(path: str) -> Any:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``, as a
    nested dict of numpy arrays (sequences as lists; empty nodes such as
    optax's ``EmptyState`` as None). Every array keeps its saved dtype
    and shape (a train state's ``step`` is a 0-d int32 array)."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{path} is not an orbax checkpoint: no _METADATA file")
    with open(meta_path) as f:
        meta = json.load(f)
    ocdbt = bool(meta.get("use_ocdbt", False))
    zarr3 = bool(meta.get("use_zarr3", False))
    ts = _tensorstore()

    pending = []
    entries: List[Tuple[list, Any]] = []
    for leaf in meta["tree_metadata"].values():
        keys = leaf["key_metadata"]
        vtype = leaf["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            empty = _EMPTY[vtype]
            entries.append((keys, empty() if empty else None))
        elif vtype in _ARRAY_TYPES:
            name = ".".join(str(k["key"]) for k in keys)
            store = ts.open(_spec(path, name, ocdbt, zarr3), open=True,
                            read=True)
            pending.append((keys, vtype, store))
        else:
            raise ValueError(
                f"{path}: leaf {[k['key'] for k in keys]} has value type "
                f"{vtype!r}; only arrays, scalars and empty nodes are read")
    for keys, vtype, store in pending:
        a = store.result().read().result()
        entries.append((keys, a[()] if vtype == "scalar" else a))
    return _nest(entries)
