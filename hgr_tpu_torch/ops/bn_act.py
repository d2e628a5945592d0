"""Train-mode BatchNorm(+SiLU) with a hand-derived two-pass backward (port
of hgr_tpu/ops/bn_act_pallas.py).

* ``fwd_chain`` — the plain forward: batch mean, two-pass biased variance,
  normalize, scale and shift, optional SiLU, all in float32; the output in
  the input's dtype (bn_act_pallas.py:70).
* ``bn_act_reduce`` and ``bn_act_elem`` — the two passes of the
  closed-form backward (:82) on the (M, C) rows of the NHWC activation:
  ``T1 = Σ dz``, ``T2 = Σ dz·x̂``, then ``dy = r·γ·(dz − T1/M − x̂·T2/M)``
  with ``dz = g·silu′(z)`` (or ``g`` without the activation). On a CUDA
  tensor each launches its kernel of ``csrc/bn_act_bwd.cu`` (ports of
  ``_reduce_kernel`` :102 and ``_elem_kernel`` :129), one launch a call
  with the per-channel vectors passed by pointer, and counts it in
  ``bn_act_reduce.launches`` / ``bn_act_elem.launches``; on a CPU tensor
  each runs its plain version (``bn_act_reduce_reference``,
  ``bn_act_elem_reference``). Each is the custom op
  ``hgr_tpu_torch::bn_act_reduce`` / ``...bn_act_elem``: under a batched
  backward (``is_grads_batched``) the legacy vmap calls it once per
  cotangent row with real tensors, and a launch is counted per row.
  ``bn_act_bwd`` chains the two.
* ``bn_act`` — the differentiable op, a ``torch.autograd.Function`` (the
  custom VJP of :214-243): it saves y, γ, β and the batch statistics,
  and its backward is the two passes. It returns (out, mean, var); mean
  and var feed the running statistics and carry no gradient.

The per-channel vectors (``r = rsqrt(var + eps)``, T1/M, T2/M) are
computed by the wrapper with the same torch ops on either device.

Under data parallelism (``group``: the mesh's data group, every rank
with as many rows) the statistics are the global batch's:
the forward sums y and then (y − mean)² over the ranks, and the backward
sums T1 and T2 over the ranks between the reduce kernel and the
elementwise kernel, with M the global row count. dgamma and dbeta stay
each rank's own T2 and T1: the step's gradient all-reduce adds them.
(The JAX package leaves its Pallas pair under a mesh only for want of a
partitioning rule, bn_act_pallas.py:192-208; the function is the same.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.distributed as dist

from hgr_tpu_torch.parallel.collectives import all_sum
from hgr_tpu_torch.utils.cuda_build import (kernel_device, on_device,
                                            require_storage)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def silu_grads(z: torch.Tensor) -> torch.Tensor:
    """d silu(z) / dz = s·(1 + z·(1 − s)), s = sigmoid(z) (:65-67)."""
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def fwd_chain(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float, act: bool = True, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[silu](batchnorm(y)) over the last (channel) axis with batch
    statistics (over ``group`` when given): (out in y's dtype, mean f32,
    biased var f32)."""
    yf = y.float()
    axes = tuple(range(y.dim() - 1))
    if group is None:
        mean = yf.mean(dim=axes)
        var = torch.square(yf - mean).mean(dim=axes)
    else:
        count = yf[..., 0].numel() * dist.get_world_size(group)
        mean = all_sum(yf.sum(dim=axes), group) / count
        var = all_sum(torch.square(yf - mean).sum(dim=axes), group) / count
    r = torch.rsqrt(var + eps)
    z = (yf - mean) * r * gamma + beta
    out = z * torch.sigmoid(z) if act else z
    return out.to(y.dtype), mean, var


def _dz_xhat(y2, g2, mean, r, gamma, beta, act):
    yf = y2.float()
    gf = g2.float()
    xhat = (yf - mean) * r
    z = xhat * gamma + beta
    dz = gf * silu_grads(z) if act else gf
    return dz, xhat


def bn_act_reduce_reference(y2, g2, mean, r, gamma, beta, act=True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the reduce kernel: (T1, T2), each (C,) f32."""
    dz, xhat = _dz_xhat(y2, g2, mean, r, gamma, beta, act)
    return dz.sum(dim=0), (dz * xhat).sum(dim=0)


def bn_act_elem_reference(y2, g2, mean, r, gamma, beta, t1m, t2m,
                          act=True) -> torch.Tensor:
    """Plain version of the elementwise kernel: dy (M, C) in y's dtype."""
    dz, xhat = _dz_xhat(y2, g2, mean, r, gamma, beta, act)
    return ((r * gamma) * (dz - t1m - xhat * t2m)).to(y2.dtype)


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    lib = load_kernel("bn_act_bwd").lib
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bn_act_reduce_workspace.argtypes = [i64, i32, i32, i32, i32, p, p]
    lib.bn_act_reduce_workspace.restype = i32
    lib.bn_act_reduce.argtypes = [p] * 10 + [i64, i32, i32, i32, i32, p]
    lib.bn_act_reduce.restype = i32
    lib.bn_act_elem.argtypes = [p] * 9 + [i64, i32, i32, i32, i32, p]
    lib.bn_act_elem.restype = i32
    lib.bn_act_error_string.argtypes = [i32]
    lib.bn_act_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(y2: torch.Tensor, g2: torch.Tensor, vecs) -> Tuple[int, int]:
    if y2.dim() != 2:
        raise ValueError(f"expected (M, C) rows, got {tuple(y2.shape)}")
    if g2.shape != y2.shape:
        raise ValueError(f"cotangent {tuple(g2.shape)} != activation "
                         f"{tuple(y2.shape)}")
    if y2.dtype not in _DTYPE_CODES or g2.dtype != y2.dtype:
        raise TypeError(f"bn_act kernels take float32 or bfloat16 y and g "
                        f"of one dtype, got {y2.dtype} and {g2.dtype}")
    if not (y2.is_contiguous() and g2.is_contiguous()):
        raise ValueError("bn_act kernels need contiguous (M, C) rows")
    m, c = y2.shape
    for v in vecs:
        if v.shape != (c,) or v.device != y2.device:
            raise ValueError(f"per-channel vectors must be ({c},) on "
                             f"{y2.device}")
    if m < 1 or not 1 <= c < 2**31:
        raise ValueError(f"empty or oversized rows {tuple(y2.shape)}")
    return m, c


def _vectorized(c: int, *tensors: torch.Tensor) -> int:
    """1 when 16-byte loads apply: C a multiple of 16 bytes of elements
    and every row pointer 16-byte aligned."""
    per16 = 16 // tensors[0].element_size()
    return int(c % per16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.bn_act_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _ptrs(*vecs: torch.Tensor):
    """The data pointers of the (C,) f32 vectors (converted only where
    one is not contiguous f32 already), and the tensors to keep alive."""
    vecs = tuple(v if v.dtype is torch.float32 and v.is_contiguous()
                 else v.float().contiguous() for v in vecs)
    return [v.data_ptr() for v in vecs], vecs


@functools.lru_cache(maxsize=None)
def _reduce_workspace(device: int, m: int, c: int, code: int, vec: int,
                      act: bool) -> Tuple[int, int]:
    """(f32 elements of the partial-sum scratch, channel tiles) of the
    reduce kernel's grid for these rows on card ``device``."""
    lib = _kernel()
    floats, tiles = ctypes.c_int64(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.bn_act_reduce_workspace(m, c, code, vec, int(act),
                                         ctypes.byref(floats),
                                         ctypes.byref(tiles))
    if rc != 0:
        raise ValueError(f"bn_act_reduce takes no rows ({m}, {c})")
    return floats.value, tiles.value


# (device, stream) -> (f32 partial-sum scratch, int32 counters): reused by
# every reduce launch on that stream, which runs them one after another;
# the counters are 0 between launches (the kernel resets them)
_WORKSPACES = {}


def _workspace(dev: torch.device, stream: int, floats: int, tiles: int):
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tiles:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(floats, have[0]), dtype=torch.float32,
                          device=dev),
              torch.zeros(max(tiles, have[1], 64), dtype=torch.int32,
                          device=dev))
        _WORKSPACES[key] = ws
    return ws


def _launch_reduce(y2, g2, mean, r, gamma, beta, act):
    require_storage("bn_act_reduce", y2, g2, mean, r, gamma, beta)
    m, c = _check_rows(y2, g2, (mean, r, gamma, beta))
    lib = _kernel()
    vec = _vectorized(c, y2, g2)
    code = _DTYPE_CODES[y2.dtype]
    dev = y2.device
    floats, tiles = _reduce_workspace(dev.index, m, c, code, vec, act)
    ptrs, _keep = _ptrs(mean, r, gamma, beta)
    t1 = torch.empty(c, dtype=torch.float32, device=dev)
    t2 = torch.empty(c, dtype=torch.float32, device=dev)

    def launch(stream):
        partial, counters = _workspace(dev, stream, floats, tiles)
        return lib.bn_act_reduce(y2.data_ptr(), g2.data_ptr(), *ptrs,
                                 partial.data_ptr(), counters.data_ptr(),
                                 t1.data_ptr(), t2.data_ptr(), m, c, code,
                                 vec, int(act), stream)

    _raise_on(on_device(dev, launch), lib, "bn_act_reduce")
    bn_act_reduce.launches += 1
    return t1, t2


def _launch_elem(y2, g2, mean, r, gamma, beta, t1m, t2m, act):
    require_storage("bn_act_elem", y2, g2, mean, r, gamma, beta, t1m, t2m)
    m, c = _check_rows(y2, g2, (mean, r, gamma, beta, t1m, t2m))
    lib = _kernel()
    dy = torch.empty_like(y2)
    vec = _vectorized(c, y2, g2, dy)
    ptrs, _keep = _ptrs(mean, r, gamma, beta, t1m, t2m)
    code = _DTYPE_CODES[y2.dtype]
    rc = on_device(y2.device, lambda stream: lib.bn_act_elem(
        y2.data_ptr(), g2.data_ptr(), *ptrs, dy.data_ptr(), m, c, code, vec,
        int(act), stream))
    _raise_on(rc, lib, "bn_act_elem")
    bn_act_elem.launches += 1
    return dy


@torch.library.custom_op("hgr_tpu_torch::bn_act_reduce", mutates_args=())
def _bn_act_reduce_op(y2: torch.Tensor, g2: torch.Tensor, mean: torch.Tensor,
                      r: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    if y2.device.type == "cpu":
        return bn_act_reduce_reference(y2, g2, mean, r, gamma, beta, act)
    return _launch_reduce(y2, g2, mean, r, gamma, beta, act)


@_bn_act_reduce_op.register_fake
def _(y2, g2, mean, r, gamma, beta, act):
    c = y2.shape[-1]
    return (y2.new_empty(c, dtype=torch.float32),
            y2.new_empty(c, dtype=torch.float32))


@torch.library.custom_op("hgr_tpu_torch::bn_act_elem", mutates_args=())
def _bn_act_elem_op(y2: torch.Tensor, g2: torch.Tensor, mean: torch.Tensor,
                    r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    t1m: torch.Tensor, t2m: torch.Tensor,
                    act: bool) -> torch.Tensor:
    if y2.device.type == "cpu":
        return bn_act_elem_reference(y2, g2, mean, r, gamma, beta, t1m, t2m,
                                     act)
    return _launch_elem(y2, g2, mean, r, gamma, beta, t1m, t2m, act)


@_bn_act_elem_op.register_fake
def _(y2, g2, mean, r, gamma, beta, t1m, t2m, act):
    return torch.empty_like(y2)


def bn_act_reduce(y2: torch.Tensor, g2: torch.Tensor, mean: torch.Tensor,
                  r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  act: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T1, T2) per channel of the (M, C) rows, through the operator
    ``hgr_tpu_torch::bn_act_reduce``. A CUDA tensor launches the reduce
    kernel (or raises: there is no fallback); a CPU tensor runs
    ``bn_act_reduce_reference``."""
    kernel_device(y2, "bn_act_reduce")
    return _bn_act_reduce_op(y2, g2, mean, r, gamma, beta, bool(act))


def bn_act_elem(y2: torch.Tensor, g2: torch.Tensor, mean: torch.Tensor,
                r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                t1m: torch.Tensor, t2m: torch.Tensor,
                act: bool = True) -> torch.Tensor:
    """dy (M, C) in y's dtype from the rows and T1/M, T2/M, through the
    operator ``hgr_tpu_torch::bn_act_elem``. A CUDA tensor launches the
    elementwise kernel (or raises: there is no fallback); a CPU tensor
    runs ``bn_act_elem_reference``."""
    kernel_device(y2, "bn_act_elem")
    return _bn_act_elem_op(y2, g2, mean, r, gamma, beta, t1m, t2m,
                           bool(act))


bn_act_reduce.launches = 0  # reduce kernel launches, counted above
bn_act_elem.launches = 0  # elementwise kernel launches, counted above


def bn_act_bwd(y, gamma, beta, mean, var, g, eps, act=True, group=None):
    """The two passes on (M, C) views of y and g: (dy in y's dtype, dgamma
    = T2, dbeta = T1). Kernels on CUDA tensors, plain versions on CPU.
    With ``group``, T1 and T2 are summed over it before the elementwise
    pass and M is the global row count; dgamma and dbeta stay local."""
    c = y.shape[-1]
    y2 = y.reshape(-1, c)
    g2 = g.reshape(-1, c)
    r = torch.rsqrt(var + eps)
    t1, t2 = bn_act_reduce(y2, g2, mean, r, gamma, beta, act)
    m = float(y2.shape[0] * (1 if group is None
                             else dist.get_world_size(group)))
    s1, s2 = (t1, t2) if group is None else all_sum(torch.stack([t1, t2]),
                                                    group)
    dy = bn_act_elem(y2, g2, mean, r, gamma, beta, s1 / m, s2 / m, act)
    return dy.reshape(y.shape), t2, t1


class _BNAct(torch.autograd.Function):
    """Forward: ``fwd_chain`` (the saved y is the compute-dtype activation,
    no f32 intermediate is kept); backward: ``bn_act_bwd``."""

    @staticmethod
    def forward(ctx, y, gamma, beta, eps, act, group):
        out, mean, var = fwd_chain(y, gamma, beta, eps, act, group)
        ctx.save_for_backward(y, gamma, beta, mean, var)
        ctx.cfg = (eps, act, group)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        y, gamma, beta, mean, var = ctx.saved_tensors
        dy, dgamma, dbeta = bn_act_bwd(y.contiguous(), gamma, beta, mean, var,
                                       g.contiguous(), *ctx.cfg)
        return dy, dgamma, dbeta, None, None, None


def bn_act(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float = 1e-5, act: bool = True, group=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[silu](batchnorm(y)) with batch statistics, training mode, over the
    last axis of ``y`` (NHWC): (out in y's dtype, batch mean, biased batch
    var), the statistics over the ranks of ``group`` when given.
    Differentiable in y, gamma and beta; mean and var are not."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_act runs on cuda or cpu, got {y.device}")
    return _BNAct.apply(y, gamma, beta, float(eps), bool(act), group)
