"""Sums over a process group, as the layers and ops call them: the
collectives XLA inserts for the JAX package's mesh, written out.

- ``all_sum`` (no gradient) and ``all_sum_grad`` (``all_reduce`` forward
  and backward) sum over any group; the data-parallel BatchNorm
  statistics and the step's metrics use them over the data group.
- ``gather_cat`` (no gradient) concatenates the ranks' tensors: the
  tensor-parallel attention map's head groups.
- Megatron's ``autograd.Function``s, for the tensor-parallel ViT decoder
  (``parallel/tp.py``):

  - ``copy_to_model``: identity forward, ``all_reduce`` of the cotangent
    over the model group backward, before a column-parallel layer
    (to_qkv, fc1): each rank's shard adds its part of the input's
    gradient;
  - ``reduce_from_model``: ``all_reduce`` of the partial products
    forward, identity backward, after a row-parallel layer (to_out, fc2).
    fc2's bias is added once, after the reduce;
  - ``gather_from_model``: the ranks' feature slices concatenated
    forward, this rank's slice of the cotangent backward, after a
    column-parallel layer whose consumer needs every feature (the qkv of
    heads that do not divide by the model axis): downstream every rank
    holds the same full cotangent, so the slice needs no sum;
  - ``scatter_to_model``: this rank's feature slice forward, the ranks'
    cotangent slices concatenated backward, before a row-parallel layer
    fed by a replicated tensor.

Rounding of the row-parallel partial sums in bf16: each rank's matmul
rounds its partial product to bf16, the partials are widened to f32,
summed in f32 and (after fc2's bias) rounded to bf16 once. Reducing in
bf16 would add a rounding per summand, in an order gloo chooses; the f32
sum keeps the result one rounding of the partials' exact sum, closest to
the single-rank layer, which rounds its full f32 product once.

A group of None is a single rank: every function is then the identity.

Every sum runs through the custom op ``hgr_tpu_torch::all_sum``, and
every concatenation through ``hgr_tpu_torch::all_gather_cat``; both take
their group by name (an operator's schema holds no process group). The
autograd functions' backwards reach a collective only through them:
under ``torch.autograd.grad(..., is_grads_batched=True)`` (the batched
de-mixed step) a backward receives batched wrappers without storage, and
the legacy vmap calls an operator without a batching rule once per
cotangent row, with real tensors. Each row then takes a collective of
its own: the same sum or concatenation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group

from hgr_tpu_torch.utils.cuda_build import require_storage


@torch.library.custom_op("hgr_tpu_torch::all_sum", mutates_args=())
def _all_sum_op(t: torch.Tensor, group_name: str) -> torch.Tensor:
    require_storage("all_sum", t)
    out = torch.clone(t, memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_resolve_process_group(group_name))
    return out


@_all_sum_op.register_fake
def _(t, group_name):
    return torch.empty_like(t, memory_format=torch.contiguous_format)


@torch.library.custom_op("hgr_tpu_torch::all_gather_cat", mutates_args=())
def _all_gather_cat_op(t: torch.Tensor, group_name: str,
                       dim: int) -> torch.Tensor:
    require_storage("all_gather_cat", t)
    group = _resolve_process_group(group_name)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


@_all_gather_cat_op.register_fake
def _(t, group_name, dim):
    shape = list(t.shape)
    shape[dim] *= dist.get_world_size(_resolve_process_group(group_name))
    return t.new_empty(shape)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` itself when
    ``group`` is None); carries no gradient."""
    if group is None:
        return t
    # (no detach of a cotangent: the legacy vmap has no rule for views)
    return _all_sum_op(t.detach() if t.requires_grad else t,
                       group.group_name)


class _AllSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


def all_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable: the cotangent of
    every rank's copy is summed back (the sum's transpose)."""
    if group is None:
        return t
    return _AllSumGrad.apply(t, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
    group's rank order (``t`` itself when ``group`` is None); carries no
    gradient. The tensor-parallel attention map gathers its head groups
    with it."""
    if group is None:
        return t
    return _all_gather_cat_op(t.detach() if t.requires_grad else t,
                              group.group_name, dim)


def _own_slice(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of ``t``'s last axis, one of the group's equal
    slices in rank order."""
    return t.chunk(dist.get_world_size(group), -1)[dist.get_rank(group)]


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.group, -1), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the cotangent over the model group."""
    return _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's slices of the last axis, concatenated in rank
    order; the backward keeps this rank's slice of the cotangent."""
    return _GatherFromModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of the last axis of a replicated ``x``; the
    backward concatenates the ranks' cotangent slices."""
    return _ScatterToModel.apply(x, group)


def reduce_from_model(part: torch.Tensor, group,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum over the model group of each rank's partial product (in
    f32), plus ``bias``, in the partial's dtype; the backward passes the
    cotangent through."""
    out = _ReduceFromModel.apply(part.float(), group)
    if bias is not None:
        out = out + bias.float()
    return out.to(part.dtype)
