"""Multi-head attention core of the ViT decoder (port of
hgr_tpu/ops/attention_pallas.py).

* ``fused_attention_qkv`` — the no-map core on the packed ``to_qkv``
  output (B, N, 3·H·D), through the registered operators
  ``torch.ops.hgr_tpu_torch.attention_qkv_fwd`` and ``...attention_qkv_bwd``
  (``torch.library.custom_op``: importing this module registers them,
  and builds nothing). The forward's autograd saves only ``qkv`` (the
  custom VJP of attention_pallas.py:393-414); its fake (shape) functions
  let ``torch.export`` record each as one node of a graph, so an exported
  program runs the hand-written kernel. Each operator dispatches by
  device: on CUDA tensors the forward launches
  ``csrc/attention_qkv_fwd.cu`` (port of ``_attention_qkv_kernel`` :51)
  and the backward ``csrc/attention_qkv_bwd.cu`` (port of
  ``_attention_qkv_bwd_kernel`` :175), counted in
  ``fused_attention_qkv.launches`` and ``fused_attention_qkv_bwd.launches``.
  On CPU tensors they run ``attention_qkv_reference`` and
  ``attention_qkv_bwd_reference``, the kernels' plain versions.
* ``fused_attention_split`` — the same core on q, k and v as three
  (B, N, H·D) operands (``fused_attention_split`` :343, the form a
  tensor-parallel mesh shards by heads), saving q, k and v. Its CUDA
  entry points ``attention_split_fwd`` / ``attention_split_bwd`` are the
  packed kernels' own bodies (ports of ``_split_fwd_impl`` :294 and
  ``_split_bwd_impl`` :302) reading each operand through its own pointer
  and strides: a ``chunk(3, -1)`` view of a packed tensor or contiguous
  tensors, with no concatenation. Counted in
  ``fused_attention_split.launches`` and
  ``fused_attention_split_bwd.launches``; on CPU tensors the plain
  versions ``attention_split_reference`` and
  ``attention_split_bwd_reference`` run, which the packed plain versions
  call on the three thirds. The split backward is the operator
  ``hgr_tpu_torch::attention_split_bwd``.
* Every backward kernel is reached only through an operator: under a
  batched backward (``torch.autograd.grad(..., is_grads_batched=True)``,
  the batched de-mixed step) the legacy vmap calls an operator without a
  batching rule once per cotangent row, with real tensors, and each row
  launches (and counts) the kernel once.
* On CUDA tensors each kernel runs one body per compute type, both on
  Hopper's tensor cores (``mma.sync``): bf16 directly, float32 by a
  three-way TF32 split of every operand (``csrc/attention_tf32.cuh``:
  big·small + small·big + big·big, which keeps the f32 tolerances), each
  templated over the padded head width (16, 32, 64, 128 or 256). Every
  sequence length runs: the kernels take a head's whole sequence in one
  block while that pays (the forward while one register chunk of scores
  holds it, the backward while an SM holds two such blocks), past that
  (and at every length at padded width 256) they stream the keys (and,
  in the backward, the queries) through shared memory in chunks, with
  the same bits (``kernel_route``; ``launch_on_route`` takes either route
  for the comparison). Head widths above 256 take the bodies of
  ``csrc/attention_wide.cuh`` (route 2, also on the tensor cores): the
  head padded to a multiple of 64 features, each score tile computed
  once per pass over all of them, P or dS shared by the warps through
  shared memory. The chunked and wide backwards keep the rows' softmax
  statistics in a scratch the wrapper allocates.
* ``attention_core`` — the unfused chain on heads-first tensors that can
  also return the post-softmax map (``_xla_attention_core`` :139); the
  model's need-map path and ``fused_attention=False`` use it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hgr_tpu_torch.utils.cuda_build import (
    kernel_device,
    on_device,
    require_storage,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _heads_first(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    b, n, _ = t.shape
    return t.reshape(b, n, heads, head_dim).permute(0, 2, 1, 3)


def attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, heads: int, head_dim: int,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernels: q, k, v (B, N, H·D) -> (B, N,
    H·D).

    Same arithmetic as the kernels: q·kᵀ in f32, then ``scale``; f32
    softmax; P rounded to q's dtype; P·v accumulated in f32 and rounded to
    q's dtype. (float64 inputs compute in float64.)
    """
    acc = _acc_dtype(q)
    qh, kh, vh = (_heads_first(t, heads, head_dim).to(acc) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype).to(acc)
    out = torch.matmul(p, vh).to(q.dtype)
    return merge_heads(out)


def attention_qkv_reference(qkv: torch.Tensor, heads: int, head_dim: int,
                            scale: float) -> torch.Tensor:
    """Plain version on the packed (B, N, 3·H·D) projection: the split one
    on its three thirds."""
    return attention_split_reference(*qkv.chunk(3, dim=-1), heads, head_dim,
                                     scale)


def attention_split_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, g: torch.Tensor,
                                  heads: int, head_dim: int, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the backward kernels (the math of
    ``_xla_attention_qkv_bwd``, attention_pallas.py:252): q, k, v and the
    output cotangent g, each (B, N, H·D) -> (dq, dk, dv) in q's dtype.

    P is recomputed in f32; dA = g·vᵀ; dS = P ⊙ (dA − rowsum(dA ⊙ P)) ·
    scale; dq = dS·k and dk = dSᵀ·q from the f32 P; dv = P̂ᵀ·g with P̂ = P
    rounded to q's dtype, as the forward multiplied v by it.
    """
    acc = _acc_dtype(q)
    qh, kh, vh, g_f = (_heads_first(t, heads, head_dim).to(acc)
                       for t in (q, k, v, g))
    attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale,
                         dim=-1)
    d_attn = torch.matmul(g_f, vh.transpose(-1, -2))
    d_scores = attn * (d_attn - torch.sum(d_attn * attn, dim=-1,
                                          keepdim=True))
    d_scores = d_scores * scale
    dq = torch.matmul(d_scores, kh)
    dk = torch.matmul(d_scores.transpose(-1, -2), qh)
    attn_q = attn.to(q.dtype).to(acc)
    dv = torch.matmul(attn_q.transpose(-1, -2), g_f)
    return tuple(merge_heads(t).to(q.dtype) for t in (dq, dk, dv))


def attention_qkv_bwd_reference(qkv: torch.Tensor, g: torch.Tensor,
                                heads: int, head_dim: int,
                                scale: float) -> torch.Tensor:
    """Plain version of the packed backward: qkv (B, N, 3·H·D) and g (B, N,
    H·D) -> the packed gradient (B, N, 3·H·D), the split one on the three
    thirds."""
    return torch.cat(attention_split_bwd_reference(
        *qkv.chunk(3, dim=-1), g, heads, head_dim, scale), dim=-1)


def _declare(lib: ctypes.CDLL, name: str, argtypes) -> ctypes.CDLL:
    getattr(lib, name).argtypes = argtypes
    getattr(lib, name).restype = ctypes.c_int
    for query in ("smem_bytes", "route"):
        getattr(lib, f"{name}_{query}").argtypes = [ctypes.c_int] * 3
        getattr(lib, f"{name}_{query}").restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    """The built forward kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    lib = _declare(load_kernel("attention_qkv_fwd").lib, "attention_qkv_fwd",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_split_fwd.argtypes = [p, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, i, p]
    lib.attention_split_fwd.restype = i
    lib.attention_qkv_fwd_on_route.argtypes = [p, p, i, i, i, i,
                                               ctypes.c_float, i, i, p]
    lib.attention_qkv_fwd_on_route.restype = i
    lib.attention_qkv_fwd_body.argtypes = [i] * 3
    lib.attention_qkv_fwd_body.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernel() -> ctypes.CDLL:
    """The built backward kernel library with its C signatures declared."""
    from hgr_tpu_torch.utils.cuda_build import load_kernel

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _declare(load_kernel("attention_qkv_bwd").lib, "attention_qkv_bwd",
                   [p, p, p, p, i, i, i, i, ctypes.c_float, i, p])
    lib.attention_split_bwd.argtypes = [p, p, p, i, i, i, i, ctypes.c_float,
                                        i, p]
    lib.attention_split_bwd.restype = i
    lib.attention_qkv_bwd_scratch_floats.argtypes = [i] * 5
    lib.attention_qkv_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.attention_qkv_bwd_on_route.argtypes = [p, p, p, p, i, i, i, i,
                                               ctypes.c_float, i, i, p]
    lib.attention_qkv_bwd_on_route.restype = i
    lib.attention_qkv_bwd_body.argtypes = [i] * 3
    lib.attention_qkv_bwd_body.restype = ctypes.c_char_p
    return lib


def _check_head_dim(head_dim: int) -> None:
    if head_dim < 1:
        raise ValueError(f"attention kernels take head_dim >= 1, got "
                         f"{head_dim}")


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
    _check_head_dim(head_dim)
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous qkv")
    if not 1 <= b <= 65535 or not 1 <= heads <= 65535:
        raise ValueError(f"batch {b} / heads {heads} outside [1, 65535]")


def kernel_route(kernel: str, n: int, head_dim: int,
                 dtype: torch.dtype) -> int:
    """The route ``kernel`` ('fwd' or 'bwd') takes on the card at sequence
    length ``n`` and ``head_dim`` in ``dtype``: 0 = the whole sequence of
    a head in one block's shared memory, 1 = key-chunked, 2 = the bodies
    of head widths above 256. Builds the kernel library (needs nvcc)."""
    lib = _kernel() if kernel == "fwd" else _bwd_kernel()
    return getattr(lib, f"attention_qkv_{kernel}_route")(
        n, _DTYPE_CODES[dtype], head_dim)


def forward_body(n: int, head_dim: int, dtype: torch.dtype) -> str:
    """The name of the forward kernel that runs on the card at sequence
    length ``n`` and ``head_dim`` in ``dtype`` (in
    ``csrc/attention_qkv_fwd.cu``; ``wide_fwd_kernel`` is route 2's): which
    body a shape takes, for chip_smoke's rows and the card tests. Builds
    the kernel library (needs nvcc)."""
    _check_head_dim(head_dim)
    return _kernel().attention_qkv_fwd_body(n, _DTYPE_CODES[dtype],
                                            head_dim).decode()


def backward_body(n: int, head_dim: int, dtype: torch.dtype) -> str:
    """The backward kernels that run on the card at sequence length ``n``
    and ``head_dim`` in ``dtype`` (in ``csrc/attention_qkv_bwd.cu``; a
    pair as ``..._{q,k}_kernel``, ``wide_bwd_{q,k}_kernel`` for route 2):
    which body a shape takes, for chip_smoke's rows and the card tests.
    Builds the kernel library (needs nvcc)."""
    _check_head_dim(head_dim)
    return _bwd_kernel().attention_qkv_bwd_body(n, _DTYPE_CODES[dtype],
                                                head_dim).decode()


def _bwd_scratch(lib, b: int, n: int, heads: int, head_dim: int,
                 t: torch.Tensor):
    """The f32 statistics scratch of the chunked and wide backwards
    (None on the whole-sequence route, which needs none)."""
    count = lib.attention_qkv_bwd_scratch_floats(b, n, heads, head_dim,
                                                 _DTYPE_CODES[t.dtype])
    if count == 0:
        return None
    return torch.empty(count, dtype=torch.float32, device=t.device)


def _launch(qkv: torch.Tensor, heads: int, head_dim: int,
            scale: float) -> torch.Tensor:
    _check(qkv, heads, head_dim)
    b, n, _ = qkv.shape
    lib = _kernel()
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
    require_storage("attention_qkv_bwd", qkv, g)
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
    out = torch.empty_like(qkv)
    scratch = _bwd_scratch(lib, b, n, heads, head_dim, qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.attention_qkv_bwd(qkv.data_ptr(), g.data_ptr(),
                                   out.data_ptr(),
                                   None if scratch is None
                                   else scratch.data_ptr(),
                                   b, n, heads, head_dim,
                                   float(scale), _DTYPE_CODES[qkv.dtype],
                                   stream)
    if rc != 0:
        msg = lib.attention_qkv_bwd_error_string(rc).decode()
        raise RuntimeError(f"attention_qkv_bwd launch failed: {msg} ({rc})")
    fused_attention_qkv_bwd.launches += 1
    return out


def launch_on_route(kernel: str, route: int, qkv: torch.Tensor, heads: int,
                    head_dim: int, scale: float,
                    g: torch.Tensor = None) -> torch.Tensor:
    """The packed kernel ``kernel`` ('fwd', or 'bwd' with the cotangent
    ``g``) on CUDA tensors, launched on ``route`` (0 whole sequence, 1
    key-chunked) whatever ``kernel_route`` would take: the two routes
    compared at one length (chip_smoke's route sweep, the card tests; no
    path of the model calls it). Counted as the entry points' launches.
    The route must exist at that length and width (ValueError
    otherwise)."""
    _check(qkv, heads, head_dim)
    b, n, f = qkv.shape
    code = _DTYPE_CODES[qkv.dtype]
    if kernel == "fwd":
        lib = _kernel()
        out = torch.empty((b, n, f // 3), dtype=qkv.dtype, device=qkv.device)

        def launch(stream):
            return lib.attention_qkv_fwd_on_route(
                qkv.data_ptr(), out.data_ptr(), b, n, heads, head_dim,
                float(scale), code, route, stream)
    else:
        if g is None or tuple(g.shape) != (b, n, f // 3) \
                or g.dtype != qkv.dtype or not g.is_contiguous():
            raise ValueError("the backward needs a contiguous cotangent g "
                             "of qkv's dtype and (B, N, H·D)")
        lib = _bwd_kernel()
        out = torch.empty_like(qkv)
        scratch = torch.empty(b * heads * 3 * (-(-n // 16) * 16),
                              dtype=torch.float32, device=qkv.device)

        def launch(stream):
            return lib.attention_qkv_bwd_on_route(
                qkv.data_ptr(), g.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), b, n, heads, head_dim, float(scale),
                code, route, stream)
    rc = on_device(qkv.device, launch)
    if rc != 0:
        raise ValueError(f"attention_qkv_{kernel} on route {route} at n = "
                         f"{n}, head_dim {head_dim}, {qkv.dtype}: error {rc}")
    counter = fused_attention_qkv if kernel == "fwd" \
        else fused_attention_qkv_bwd
    counter.launches += 1
    return out


def _check_split(ts, heads: int, head_dim: int) -> Tuple[int, int]:
    """(B, N) of the (B, N, H·D) operands ``ts``, which the split kernels
    read by their image and row strides (unit feature stride)."""
    first = ts[0]
    if first.dim() != 3 or first.shape[-1] != heads * head_dim:
        raise ValueError(f"operands must be (B, N, {heads * head_dim}), got "
                         f"{tuple(first.shape)}")
    for t in ts:
        if t.shape != first.shape or t.dtype != first.dtype \
                or t.device != first.device:
            raise ValueError("q, k, v (and g) must share shape, dtype and "
                             f"device: {tuple(t.shape)} {t.dtype} {t.device}"
                             f" vs {tuple(first.shape)} {first.dtype} "
                             f"{first.device}")
        if t.stride(2) != 1:
            raise ValueError("attention split kernels need a unit feature "
                             f"stride, got strides {t.stride()}")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"attention kernel takes float32 or bfloat16, got {first.dtype}")
    _check_head_dim(head_dim)
    b, n, _ = first.shape
    if not 1 <= b <= 65535 or not 1 <= heads <= 65535 or n < 1:
        raise ValueError(f"batch {b} / heads {heads} / length {n} outside "
                         "the kernel's range")
    return b, n


def _strides(ts) -> ctypes.Array:
    vals = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch_split(q, k, v, heads: int, head_dim: int,
                  scale: float) -> torch.Tensor:
    b, n = _check_split((q, k, v), heads, head_dim)
    lib = _kernel()
    out = torch.empty((b, n, heads * head_dim), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_split_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     _strides((q, k, v)), out.data_ptr(), b, n,
                                     heads, head_dim, float(scale),
                                     _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.attention_qkv_fwd_error_string(rc).decode()
        raise RuntimeError(f"attention_split_fwd launch failed: {msg} ({rc})")
    fused_attention_split.launches += 1
    return out


def _launch_split_bwd(q, k, v, g, heads: int, head_dim: int, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    require_storage("attention_split_bwd", q, k, v, g)
    b, n = _check_split((q, k, v, g), heads, head_dim)
    lib = _bwd_kernel()
    outs = tuple(torch.empty((b, n, heads * head_dim), dtype=q.dtype,
                             device=q.device) for _ in range(3))
    scratch = _bwd_scratch(lib, b, n, heads, head_dim, q)
    ts = (q, k, v, g) + outs
    ptrs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in ts))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_split_bwd(ptrs, _strides(ts),
                                     None if scratch is None
                                     else scratch.data_ptr(), b, n, heads,
                                     head_dim, float(scale),
                                     _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.attention_qkv_bwd_error_string(rc).decode()
        raise RuntimeError(f"attention_split_bwd launch failed: {msg} ({rc})")
    fused_attention_split_bwd.launches += 1
    return outs


@torch.library.custom_op("hgr_tpu_torch::attention_qkv_bwd", mutates_args=())
def _attention_qkv_bwd_op(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                          head_dim: int, scale: float) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
    return _launch_bwd(qkv, g, heads, head_dim, scale)


@_attention_qkv_bwd_op.register_fake
def _(qkv, g, heads, head_dim, scale):
    return torch.empty_like(qkv)


@torch.library.custom_op("hgr_tpu_torch::attention_qkv_fwd", mutates_args=())
def _attention_qkv_fwd_op(qkv: torch.Tensor, heads: int, head_dim: int,
                          scale: float) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, heads, head_dim, scale)
    return _launch(qkv, heads, head_dim, scale)


@_attention_qkv_fwd_op.register_fake
def _(qkv, heads, head_dim, scale):
    b, n, _ = qkv.shape
    return qkv.new_empty((b, n, heads * head_dim))


def _fwd_setup_context(ctx, inputs, output):
    qkv, heads, head_dim, scale = inputs
    ctx.save_for_backward(qkv)  # the recompute backward: no N×N tensor
    ctx.cfg = (heads, head_dim, scale)


def _fwd_backward(ctx, g):
    (qkv,) = ctx.saved_tensors
    return _attention_qkv_bwd_op(qkv, g.contiguous(), *ctx.cfg), None, None, \
        None


_attention_qkv_fwd_op.register_autograd(_fwd_backward,
                                        setup_context=_fwd_setup_context)


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, heads: int,
                            head_dim: int, scale: float) -> torch.Tensor:
    """The packed gradient (B, N, 3·H·D) of ``fused_attention_qkv`` at
    ``qkv`` for the output cotangent ``g`` (B, N, H·D).

    CUDA tensors launch the backward kernel (or raise: there is no
    fallback); CPU tensors run ``attention_qkv_bwd_reference``.
    """
    kernel_device(qkv, "fused_attention_qkv_bwd")
    return _attention_qkv_bwd_op(qkv, g, int(heads), int(head_dim),
                                 float(scale))


def fused_attention_qkv(qkv: torch.Tensor, heads: int, head_dim: int,
                        scale: float) -> torch.Tensor:
    """out (B, N, H·D) = multi-head softmax(q kᵀ · scale) v on the packed
    qkv projection (B, N, 3·H·D); differentiable in ``qkv``.

    A CUDA tensor launches the kernels (or raises: there is no fallback);
    a CPU tensor runs the plain versions.
    """
    kernel_device(qkv, "fused_attention_qkv")
    return _attention_qkv_fwd_op(qkv, int(heads), int(head_dim),
                                 float(scale))


@torch.library.custom_op("hgr_tpu_torch::attention_split_bwd",
                         mutates_args=())
def _attention_split_bwd_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor, heads: int,
                            head_dim: int, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    if q.device.type == "cpu":
        return attention_split_bwd_reference(q, k, v, g, heads, head_dim,
                                             scale)
    return _launch_split_bwd(q, k, v, g, heads, head_dim, scale)


@_attention_split_bwd_op.register_fake
def _(q, k, v, g, heads, head_dim, scale):
    return tuple(q.new_empty((q.shape[0], q.shape[1], heads * head_dim))
                 for _ in range(3))


def fused_attention_split_bwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor, heads: int,
                              head_dim: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv), each (B, N, H·D), of ``fused_attention_split`` at q,
    k, v for the output cotangent ``g``, through the operator
    ``hgr_tpu_torch::attention_split_bwd``.

    CUDA tensors launch the backward kernel (or raise: there is no
    fallback); CPU tensors run ``attention_split_bwd_reference``.
    """
    kernel_device(q, "fused_attention_split_bwd")
    return _attention_split_bwd_op(q, k, v, g, int(heads), int(head_dim),
                                   float(scale))


class _FusedAttentionSplit(torch.autograd.Function):
    """The split core with its recompute backward: q, k and v are saved
    (as ``_split_vjp_fwd`` does, attention_pallas.py:369-371), not the
    output."""

    @staticmethod
    def forward(ctx, q, k, v, heads, head_dim, scale):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (heads, head_dim, scale)
        if q.device.type == "cpu":
            return attention_split_reference(q, k, v, heads, head_dim, scale)
        return _launch_split(q, k, v, heads, head_dim, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_split_bwd(q, k, v, g.contiguous(),
                                               *ctx.cfg)
        return dq, dk, dv, None, None, None


def fused_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, head_dim: int,
                          scale: float) -> torch.Tensor:
    """out (B, N, H·D) = multi-head softmax(q kᵀ · scale) v on three (B, N,
    H·D) operands (views with a unit feature stride, e.g. the chunks of a
    packed projection); differentiable in q, k and v.

    A CUDA tensor launches the kernels (or raises: there is no fallback);
    a CPU tensor runs the plain versions.
    """
    kernel_device(q, "fused_attention_split")
    return _FusedAttentionSplit.apply(q, k, v, heads, head_dim, scale)


fused_attention_qkv.launches = 0  # forward kernel launches, by _launch
fused_attention_qkv_bwd.launches = 0  # backward launches, by _launch_bwd
fused_attention_split.launches = 0  # by _launch_split
fused_attention_split_bwd.launches = 0  # by _launch_split_bwd
