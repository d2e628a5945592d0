"""Multi-head attention core of the ViT decoder (port of
hgr_tpu/ops/attention_pallas.py).

* ``fused_attention_qkv`` — the no-map core on the packed ``to_qkv``
  output (B, N, 3·H·D). On a CUDA tensor it launches the hand-written
  kernel ``csrc/attention_qkv_fwd.cu`` (the port of the TPU kernel
  ``_attention_qkv_kernel``, attention_pallas.py:51) and counts the
  launch in ``fused_attention_qkv.launches``. On a CPU tensor it runs
  ``attention_qkv_reference``, the kernel's plain version.
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


def attention_qkv_reference(qkv: torch.Tensor, heads: int, head_dim: int,
                            scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3·H·D) -> (B, N, H·D).

    Same arithmetic as the kernel: q·kᵀ in f32, then ``scale``; f32
    softmax; P rounded to qkv's dtype; P·v accumulated in f32 and rounded
    to qkv's dtype.
    """
    q, k, v = split_heads(qkv, heads, head_dim)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(p, v.float()).to(qkv.dtype)
    return merge_heads(out)


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    lib = load_kernel("attention_qkv_fwd").lib
    lib.attention_qkv_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.attention_qkv_fwd.restype = ctypes.c_int
    lib.attention_qkv_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.attention_qkv_fwd_smem_bytes.restype = ctypes.c_int
    lib.attention_qkv_fwd_error_string.argtypes = [ctypes.c_int]
    lib.attention_qkv_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv: torch.Tensor, heads: int, head_dim: int,
            scale: float) -> torch.Tensor:
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


def fused_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int,
                        scale: float) -> torch.Tensor:
    """out (B, N, H·D) = multi-head softmax(q kᵀ · scale) v on the packed
    qkv projection (B, N, 3·H·D).

    A CUDA tensor launches the kernel (or raises: there is no fallback);
    a CPU tensor runs ``attention_qkv_reference``.
    """
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, heads, head_dim, scale)
    if qkv.device.type != "cuda":
        raise ValueError(
            f"fused_attention_qkv runs on cuda or cpu, got {qkv.device}")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the attention backward kernel is not ported yet (ROADMAP B2); "
            "run the forward under torch.inference_mode() or no_grad()")
    return _launch(qkv, heads, head_dim, scale)


fused_attention_qkv.launches = 0  # kernel launches, counted by _launch
