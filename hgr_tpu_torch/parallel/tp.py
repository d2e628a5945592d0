"""Tensor parallelism of the ViT decoder: the cut of a full model into
this rank's shard under the JAX package's TP_RULES
(hgr_tpu/parallel/mesh.py:77-117), and the cut and gather of a port state
between full and per-rank. The collectives the sharded layers run
(Megatron's functions) are in ``parallel/collectives.py``.

Each leaf takes its own layout (``parallel/mesh.py:tp_layout``): sharded
where its dimension divides by the model axis, replicated elsewhere, as
GSPMD shards it. ``make_tensor_parallel`` records the layouts of an
``Attention``'s or ``FeedForward``'s leaves in its ``tp_cuts``, and
``layouts(model)`` reads them back by state-dict name for the state
functions.

``shard_state`` / ``gather_state`` cut a full port state (the checkpoint
payload: update count, model state dict with the BatchNorm statistics,
AdamW state dict) into this rank's share and put the full one back
together. The gather is an ``all_reduce`` of zero-filled full tensors
over the model group, so it only uses the collectives every backend
offers; it is a collective, so call it on the main thread of every rank.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch import nn

from hgr_tpu_torch.models.vit import Attention, FeedForward
from hgr_tpu_torch.parallel.mesh import tp_layout


# -- cutting and gathering ---------------------------------------------------


def cut(t: torch.Tensor, kind: str, index: int, size: int) -> torch.Tensor:
    """Rank ``index``'s shard (of ``size``) of a full tensor of ``kind``."""
    axis = 1 if kind == "cols" else 0
    if t.shape[axis] % (size * (3 if kind == "qkv" else 1)):
        raise ValueError(f"a {kind} shard of {tuple(t.shape)} does not "
                         f"divide by {size} ranks")
    if kind == "rows":
        return t.chunk(size, 0)[index]
    if kind == "cols":
        return t.chunk(size, 1)[index]
    if kind == "qkv":  # the rows of the rank's heads in q, k and v
        return torch.cat([third.chunk(size, 0)[index]
                          for third in t.chunk(3, 0)], 0)
    raise ValueError(f"unknown shard kind {kind!r}")


def _placed(local: torch.Tensor, kind: str, index: int,
            size: int) -> torch.Tensor:
    """A zero full tensor with the shard ``local`` in its place."""
    shape = list(local.shape)
    shape[1 if kind == "cols" else 0] *= size
    full = local.new_zeros(shape)
    if kind == "qkv":
        for third, part in zip(full.chunk(3, 0), local.chunk(3, 0)):
            third.chunk(size, 0)[index].copy_(part)
    else:
        cut(full, kind, index, size).copy_(local)
    return full


def make_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Turn a full model into this rank's shard, in place: every decoder
    leaf that ``tp_layout`` shards becomes its shard (new ``Parameter``s:
    build the optimizer after this), and the layers run the collectives
    over the mesh's model group. An Attention whose heads divide by the
    model axis takes its local head count; one whose heads do not keeps
    them all and its route (``mesh.attention_route`` gives the packed
    kernel there), and attends over the gathered qkv."""
    m, size = mesh.model_index, mesh.model_size
    with torch.no_grad():
        for prefix, mod in model.named_modules():
            if not isinstance(mod, (Attention, FeedForward)):
                continue
            heads = mod.heads if isinstance(mod, Attention) else None
            mod.tp_group, mod.tp_cuts = mesh.model_group, {}
            for name, p in list(mod.named_parameters()):
                kind = tp_layout(f"{prefix}.{name}", p.shape, size, heads)
                if kind is None:
                    continue
                mod.tp_cuts[name] = kind
                owner_name, attr = name.rsplit(".", 1)
                setattr(mod.get_submodule(owner_name), attr,
                        nn.Parameter(cut(p, kind, m, size).clone()))
            if heads is not None and heads % size == 0:
                mod.heads //= size
    return model


def layouts(model: nn.Module) -> Dict[str, str]:
    """{state-dict name: layout} of the sharded leaves of a model that
    ``make_tensor_parallel`` cut (empty for a model it did not)."""
    return {f"{prefix}.{leaf}": kind
            for prefix, mod in model.named_modules()
            for leaf, kind in getattr(mod, "tp_cuts", {}).items()}


def _param_names(model_state: Dict[str, Any], n_params: int) -> List[str]:
    names = [k for k in model_state
             if not k.endswith((".mean", ".var"))]
    if len(names) != n_params:
        raise ValueError(f"{len(names)} parameter names for {n_params} "
                         "optimizer entries")
    return names


def _map_state(payload: Dict[str, Any], cuts: Dict[str, str],
               fn) -> Dict[str, Any]:
    """``payload`` with ``fn(tensor, layout)`` applied to every sharded
    parameter of ``cuts`` and to its AdamW moments."""
    out = {"step": payload["step"],
           "model": {k: (fn(v, cuts[k]) if k in cuts else v)
                     for k, v in payload["model"].items()}}
    opt = payload.get("optimizer")
    if opt is not None:
        opt = copy.copy(opt)
        names = _param_names(payload["model"],
                             len(opt["param_groups"][0]["params"]))
        pids = opt["param_groups"][0]["params"]
        state = {}
        for pid, st in opt["state"].items():
            kind = cuts.get(names[pids.index(pid)])
            state[pid] = ({k: (fn(v, kind) if torch.is_tensor(v) and v.dim()
                               else v) for k, v in st.items()}
                          if kind else st)
        opt["state"] = state
        out["optimizer"] = opt
    return out


def shard_state(payload: Dict[str, Any], mesh,
                model: nn.Module) -> Dict[str, Any]:
    """This rank's share of a full state payload ({'step', 'model',
    'optimizer'}) under the layouts of ``model``, the rank's model that
    ``make_tensor_parallel`` cut; the identity without a model axis."""
    if not mesh.tensor_parallel:
        return payload
    return _map_state(payload, layouts(model), lambda t, kind: cut(
        t, kind, mesh.model_index, mesh.model_size).clone())


def gather_state(payload: Dict[str, Any], mesh,
                 model: nn.Module) -> Dict[str, Any]:
    """The full state from every model rank's share under the layouts of
    ``model``, the rank's cut model (a collective over the model group;
    the replicated entries are this rank's)."""
    if not mesh.tensor_parallel:
        return payload

    def gather(t, kind):
        full = _placed(t, kind, mesh.model_index, mesh.model_size)
        dist.all_reduce(full, group=mesh.model_group)
        return full

    return _map_state(payload, layouts(model), gather)
