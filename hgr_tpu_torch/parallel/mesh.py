"""The mesh of ranks and its sharding rules (port of
hgr_tpu/parallel/mesh.py).

A mesh ``{'data': D, 'model': M}`` places the D·M ranks row-major, as
``make_mesh`` orders the JAX devices: rank = d·M + m, with d the data
index and m the model index. The ranks of one model group (same d) hold
the same batch rows and one shard each of the ViT decoder; the
ranks of one data group (same m) hold the same shard and different rows.

BatchNorm statistics are taken over the global batch (the JAX package's
note, mesh.py:10-13): the BatchNorm layers sum over the data group
(``models/layers.py``), so one step over D·M ranks equals the
single-device step at the global batch.

Tensor parallelism (``TP_RULES``) shards the same parameters as the JAX
rules (mesh.py:77-83): to_qkv and fc1 (weight and bias) column-parallel,
to_out and fc2 row-parallel, each leaf only where its sharded dimension
divides by the model axis and replicated elsewhere (``param_shardings``,
mesh.py:98-117). One layout differs and the function does not: where the
model axis divides the heads, GSPMD cuts to_qkv's 3·H·D output features
contiguously, while the port gives rank m the q, k and v rows of heads
[m·H/M, (m+1)·H/M), one slice of each third, so that the rank's
projection output is its own [q | k | v] and ``fused_attention_split``
runs on the local head group (``parallel/tp.py``). Where the heads do
not divide, to_qkv is cut contiguously, as GSPMD cuts it, and every
model rank gathers the whole qkv and attends over all the heads.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hgr_tpu_torch.parallel import distributed

AXES = ("data", "model")


def parse_mesh(spec: str) -> Dict[str, int]:
    """'data=4,model=2' -> {'data': 4, 'model': 2}; '' -> {} (the CLI's
    --mesh format, cli/train.py:168-171)."""
    if not spec:
        return {}
    shape = {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))}
    unknown = set(shape) - set(AXES)
    if unknown or any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh axes are {AXES} with sizes >= 1, got {spec!r}")
    return shape


def resolve_fused_attention(mesh_shape: Dict[str, int], heads: int = 8) -> Any:
    """The attention route for a mesh (mesh.py:29-45): the packed kernel
    without a real model axis, 'split' when the model axis divides the
    head count, else False (the JAX package's GSPMD-sharded chain)."""
    tp = mesh_shape.get("model", 1) if mesh_shape else 1
    if tp <= 1:
        return True
    return "split" if heads % tp == 0 else False


def attention_route(mesh_shape: Dict[str, int], heads: int = 8) -> Any:
    """The route the port builds its Attention with for a mesh:
    ``resolve_fused_attention``'s, except that where the model axis does
    not divide the heads (JAX's False) it is the packed kernel (True),
    which every model rank runs over all the heads of the gathered qkv
    in the place of JAX's GSPMD-sharded chain."""
    return resolve_fused_attention(mesh_shape, heads) or True


@dataclasses.dataclass
class Mesh:
    """This rank's place on a {'data': D, 'model': M} mesh and the process
    groups of its axes (None where the axis has one rank)."""

    shape: Dict[str, int]
    rank: int
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return self.shape.get("data", 1)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def tensor_parallel(self) -> bool:
        return self.model_size > 1


def make_mesh(shape: Dict[str, int]) -> Mesh:
    """The mesh over this process group (every rank calls it, in the same
    order, since it creates the axes' groups). Raises as mesh.py:56-59 when
    the group has another number of ranks than the mesh needs."""
    shape = dict(shape)
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes are {AXES}, got {shape}")
    d, m = shape.get("data", 1), shape.get("model", 1)
    world = distributed.process_count()
    if d * m != world:
        raise ValueError(f"mesh {shape} needs {d * m} devices, have {world}")
    mesh = Mesh(shape, distributed.process_index())
    if world == 1:
        return mesh
    for mi in range(m):  # data groups: same model index
        ranks = [di * m + mi for di in range(d)]
        g = dist.new_group(ranks) if d > 1 else None
        if mi == mesh.model_index:
            mesh.data_group = g
    for di in range(d):  # model groups: same data index
        ranks = [di * m + mi for mi in range(m)]
        g = dist.new_group(ranks) if m > 1 else None
        if di == mesh.data_index:
            mesh.model_group = g
    return mesh


# Port parameter names -> the axis of the port's weight whose slices the
# ranks of a model axis hold (the JAX kernels are the transposes): 0 for
# the column-parallel layers (a slice of the output features), 1 for the
# row-parallel ones (a slice of the input features).
TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*transformer\.layers_\d+_attn\.to_qkv\.weight$", 0),
    (r".*transformer\.layers_\d+_attn\.to_out\.weight$", 1),
    (r".*transformer\.layers_\d+_ff\.fc1\.weight$", 0),
    (r".*transformer\.layers_\d+_ff\.fc1\.bias$", 0),
    (r".*transformer\.layers_\d+_ff\.fc2\.weight$", 1),
)


def tp_layout(name: str, shape, model_size: int,
              heads: Optional[int] = None) -> Optional[str]:
    """How a rank of a model axis of ``model_size`` holds parameter
    ``name`` of ``shape``: None (replicated) where no rule names it or
    its sharded dimension does not divide (JAX's ``param_shardings``);
    else 'rows' or 'cols', a contiguous slice along axis 0 or 1, or, for
    to_qkv when ``model_size`` divides its ``heads``, 'qkv' (the rows of
    the rank's heads in each third)."""
    for pattern, axis in TP_RULES:
        if re.match(pattern, name):
            if shape[axis] % model_size:
                return None
            if name.endswith("to_qkv.weight") and heads \
                    and heads % model_size == 0:
                return "qkv"
            return "cols" if axis else "rows"
    return None


def shard_rows(batch_size: int, count: int, index: int,
               microbatches: int = 1) -> np.ndarray:
    """The global batch rows that data rank ``index`` of ``count`` holds.

    Microbatch i of a step is the global rows [i·B/a, (i+1)·B/a)
    (hgr_tpu/parallel/steps.py:86-90, where GSPMD reshards each over
    'data'); the rank holds its contiguous share of every microbatch, in
    order, so its own microbatch i is its share of the global one and the
    BatchNorm statistics of each microbatch are those of the global one.
    With one microbatch this is the contiguous slice
    [index·B/count, (index+1)·B/count) of the JAX loader (loader.py:69-92).
    """
    if batch_size % (count * microbatches):
        raise ValueError(f"batch {batch_size} must divide by data ranks x "
                         f"microbatches ({count} x {microbatches})")
    micro = batch_size // microbatches
    share = micro // count
    return np.concatenate([np.arange(i * micro + index * share,
                                     i * micro + (index + 1) * share)
                           for i in range(microbatches)])


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                microbatches: int = 1) -> Dict[str, Any]:
    """This data rank's rows of a global batch (numpy arrays or tensors;
    0-d leaves stay whole)."""
    b = next(np.shape(v)[0] for v in batch.values() if np.ndim(v))
    rows = shard_rows(b, mesh.data_size, mesh.data_index, microbatches)
    out = {}
    for k, v in batch.items():
        if not np.ndim(v):
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = v[torch.from_numpy(rows).to(v.device)]
        else:
            out[k] = np.asarray(v)[rows]
    return out
