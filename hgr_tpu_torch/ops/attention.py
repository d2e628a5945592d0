"""Multi-head attention core of the ViT decoder (port of
hgr_tpu/ops/attention_pallas.py).

* ``fused_attention_qkv`` — the no-map core on the packed ``to_qkv``
  output (B, N, 3·H·D), differentiable through a
  ``torch.autograd.Function`` that saves only ``qkv`` (the custom VJP of
  attention_pallas.py:393-414). On CUDA tensors the forward launches
  ``csrc/attention_qkv_fwd.cu`` (port of ``_attention_qkv_kernel`` :51)
  and the backward ``csrc/attention_qkv_bwd.cu`` (port of
  ``_attention_qkv_bwd_kernel`` :175), counted in
  ``fused_attention_qkv.launches`` and ``fused_attention_qkv_bwd.launches``.
  On CPU tensors they run ``attention_qkv_reference`` and
  ``attention_qkv_bwd_reference``, the kernels' plain versions.
* ``attention_core`` — the unfused chain on heads-first tensors that can
  also return the post-softmax map (``_xla_attention_core`` :139); the
  model's need-map path and ``fused_attention=False`` use it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIM = 32
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def split_heads(qkv: torch.Tensor, heads: int, head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, 3·H·D) -> three (B, H, N, D) (reference transformer.py:66:
    chunk(3) then heads-first rearrange)."""
    b, n, _ = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)

    def hf(t):
        return t.reshape(b, n, heads, head_dim).permute(0, 2, 1, 3)

    return hf(q), hf(k), hf(v)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H·D)."""
    b, h, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, return_attn: bool = False):
    """Unfused chain on heads-first tensors, in the JAX chain's dtype
    placement: the score product rounds to the compute dtype, then f32
    scale and softmax; the map is cast to the compute dtype before the
    value product. ``return_attn`` also returns the f32 map."""
    dots = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    attn = torch.softmax(dots, dim=-1)
    out = torch.matmul(attn.to(q.dtype), v)
    return (out, attn) if return_attn else out


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 inputs (the kernels' accumulation type);
    float64 stays float64, so gradcheck can hold the plain versions."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_qkv_reference(qkv: torch.Tensor, heads: int, head_dim: int,
                            scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3·H·D) -> (B, N, H·D).

    Same arithmetic as the kernel: q·kᵀ in f32, then ``scale``; f32
    softmax; P rounded to qkv's dtype; P·v accumulated in f32 and rounded
    to qkv's dtype. (float64 inputs compute in float64.)
    """
    acc = _acc_dtype(qkv)
    q, k, v = (t.to(acc) for t in split_heads(qkv, heads, head_dim))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype).to(acc)
    out = torch.matmul(p, v).to(qkv.dtype)
    return merge_heads(out)


def attention_qkv_bwd_reference(qkv: torch.Tensor, g: torch.Tensor,
                                heads: int, head_dim: int,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (the math of
    ``_xla_attention_qkv_bwd``, attention_pallas.py:252): qkv (B, N, 3·H·D)
    and the output cotangent g (B, N, H·D) -> the packed gradient
    (B, N, 3·H·D) in qkv's dtype.

    P is recomputed in f32; dA = g·vᵀ; dS = P ⊙ (dA − rowsum(dA ⊙ P)) ·
    scale; dq = dS·k and dk = dSᵀ·q from the f32 P; dv = P̂ᵀ·g with P̂ = P
    rounded to qkv's dtype, as the forward multiplied v by it.
    """
    acc = _acc_dtype(qkv)
    q, k, v = (t.to(acc) for t in split_heads(qkv, heads, head_dim))
    b, n, _ = qkv.shape
    g_f = g.reshape(b, n, heads, head_dim).permute(0, 2, 1, 3).to(acc)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale,
                         dim=-1)
    d_attn = torch.matmul(g_f, v.transpose(-1, -2))
    d_scores = attn * (d_attn - torch.sum(d_attn * attn, dim=-1,
                                          keepdim=True))
    d_scores = d_scores * scale
    dq = torch.matmul(d_scores, k)
    dk = torch.matmul(d_scores.transpose(-1, -2), q)
    attn_q = attn.to(qkv.dtype).to(acc)
    dv = torch.matmul(attn_q.transpose(-1, -2), g_f)
    return torch.cat([merge_heads(t).to(qkv.dtype) for t in (dq, dk, dv)],
                     dim=-1)


def _declare(lib: ctypes.CDLL, name: str, argtypes) -> ctypes.CDLL:
    getattr(lib, name).argtypes = argtypes
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, f"{name}_smem_bytes").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built forward kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    return _declare(load_kernel("attention_qkv_fwd").lib, "attention_qkv_fwd",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                     ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _bwd_kernel() -> ctypes.CDLL:
    """The built backward kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    return _declare(load_kernel("attention_qkv_bwd").lib, "attention_qkv_bwd",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check(qkv: torch.Tensor, heads: int, head_dim: int) -> None:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3·H·D), got {tuple(qkv.shape)}")
    b, n, f = qkv.shape
    if f != 3 * heads * head_dim:
        raise ValueError(
            f"qkv last dim {f} != 3 * heads * head_dim "
            f"= {3 * heads * head_dim}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if head_dim != _KERNEL_HEAD_DIM:
        raise ValueError(
            f"attention kernel supports head_dim {_KERNEL_HEAD_DIM}, "
            f"got {head_dim}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous qkv")
    if not 1 <= b <= 65535 or not 1 <= heads <= 65535:
        raise ValueError(f"batch {b} / heads {heads} outside [1, 65535]")


def _launch(qkv: torch.Tensor, heads: int, head_dim: int,
            scale: float) -> torch.Tensor:
    _check(qkv, heads, head_dim)
    b, n, _ = qkv.shape
    lib = _kernel()
    if n < 1 or lib.attention_qkv_fwd_smem_bytes(n) > _SMEM_LIMIT:
        raise ValueError(
            f"sequence length {n} needs more shared memory than a block has")
    out = torch.empty((b, n, heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.attention_qkv_fwd(qkv.data_ptr(), out.data_ptr(), b, n,
                                   heads, head_dim, float(scale),
                                   _DTYPE_CODES[qkv.dtype], stream)
    if rc != 0:
        msg = lib.attention_qkv_fwd_error_string(rc).decode()
        raise RuntimeError(f"attention_qkv_fwd launch failed: {msg} ({rc})")
    fused_attention_qkv.launches += 1
    return out


def _launch_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                head_dim: int, scale: float) -> torch.Tensor:
    _check(qkv, heads, head_dim)
    b, n, f = qkv.shape
    if tuple(g.shape) != (b, n, f // 3):
        raise ValueError(f"cotangent must be {(b, n, f // 3)}, got "
                         f"{tuple(g.shape)}")
    if g.dtype != qkv.dtype or g.device != qkv.device:
        raise TypeError(f"cotangent {g.dtype} on {g.device} != qkv "
                        f"{qkv.dtype} on {qkv.device}")
    if not g.is_contiguous():
        raise ValueError("attention backward kernel needs a contiguous g")
    lib = _bwd_kernel()
    if n < 1 or lib.attention_qkv_bwd_smem_bytes(n) > _SMEM_LIMIT:
        raise ValueError(
            f"sequence length {n} needs more shared memory than a block has")
    out = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.attention_qkv_bwd(qkv.data_ptr(), g.data_ptr(),
                                   out.data_ptr(), b, n, heads, head_dim,
                                   float(scale), _DTYPE_CODES[qkv.dtype],
                                   stream)
    if rc != 0:
        msg = lib.attention_qkv_bwd_error_string(rc).decode()
        raise RuntimeError(f"attention_qkv_bwd launch failed: {msg} ({rc})")
    fused_attention_qkv_bwd.launches += 1
    return out


def _device_type(t: torch.Tensor, op: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, got {t.device}")
    return t.device.type


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            head_dim: int, scale: float) -> torch.Tensor:
    """The packed gradient (B, N, 3·H·D) of ``fused_attention_qkv`` at
    ``qkv`` for the output cotangent ``g`` (B, N, H·D).

    CUDA tensors launch the backward kernel (or raise: there is no
    fallback); CPU tensors run ``attention_qkv_bwd_reference``.
    """
    if _device_type(qkv, "fused_attention_qkv_bwd") == "cpu":
        return attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
    return _launch_bwd(qkv, g, heads, head_dim, scale)


class _FusedAttentionQKV(torch.autograd.Function):
    """The fused core with its recompute backward: only ``qkv`` is saved,
    no N×N tensor."""

    @staticmethod
    def forward(ctx, qkv, heads, head_dim, scale):
        ctx.save_for_backward(qkv)
        ctx.cfg = (heads, head_dim, scale)
        if qkv.device.type == "cpu":
            return attention_qkv_reference(qkv, heads, head_dim, scale)
        return _launch(qkv, heads, head_dim, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        d = fused_attention_qkv_bwd(qkv, g.contiguous(), *ctx.cfg)
        return d, None, None, None


def fused_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int,
                        scale: float) -> torch.Tensor:
    """out (B, N, H·D) = multi-head softmax(q kᵀ · scale) v on the packed
    qkv projection (B, N, 3·H·D); differentiable in ``qkv``.

    A CUDA tensor launches the kernels (or raises: there is no fallback);
    a CPU tensor runs the plain versions.
    """
    _device_type(qkv, "fused_attention_qkv")
    return _FusedAttentionQKV.apply(qkv, heads, head_dim, scale)


fused_attention_qkv.launches = 0  # forward kernel launches, by _launch
fused_attention_qkv_bwd.launches = 0  # backward launches, by _launch_bwd
