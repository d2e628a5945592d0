"""Attention core of the port (hgr_tpu_torch/ops/attention.py) held against
the JAX package's (hgr_tpu/ops/attention_pallas.py).

Chain of checks: the CUDA kernel against its plain version on the card
(tests/test_torch_gpu.py), the plain version against the Pallas kernel
run in interpret mode here. Tolerances are the JAX kernel tests' own
(tests/test_attention_pallas.py): 1e-5 in float32, 2e-2 in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.ops.attention_pallas import (
    _xla_attention_core,
    fused_attention_qkv as jax_fused_attention_qkv,
    split_heads as jax_split_heads,
)
from hgr_tpu_torch.ops import attention as A

torch.set_num_threads(1)

H, D = 8, 32
SCALE = D**-0.5
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2)}


def _qkv(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, 3 * H * D).astype(
        np.float32)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round float32 -> bfloat16 to nearest even)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n", [(3, 145), (2, 37)])
def test_reference_matches_pallas_kernel(b, n, dtype):
    xj, xt = _pair(_qkv(b, n, seed=b), dtype)
    want = jax_fused_attention_qkv(xj, H, D, SCALE, True)  # interpret mode
    got = A.attention_qkv_reference(xt, H, D, SCALE)
    assert got.dtype == xt.dtype and got.shape == (b, n, H * D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_need_map_chain_matches_xla_core(dtype):
    xj, xt = _pair(_qkv(2, 37, seed=7), dtype)
    prec = jax.lax.Precision.HIGHEST
    out_j, attn_j = _xla_attention_core(*jax_split_heads(xj, H, D), SCALE,
                                        precision=prec, return_attn=True)
    out_t, attn_t = A.attention_core(*A.split_heads(xt, H, D), SCALE,
                                     return_attn=True)
    assert attn_t.dtype == torch.float32 and attn_t.shape == (2, H, 37, 37)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL[dtype])
    # the map is f32 softmax of scores that round to the compute dtype
    np.testing.assert_allclose(_np(attn_t), _np(attn_j),
                               atol=1e-6 if dtype == "float32" else 2e-3)
    np.testing.assert_array_equal(
        _np(A.merge_heads(A.split_heads(xt, H, D)[2])),
        _np(xt[..., 2 * H * D:]))


def test_cpu_tensor_takes_plain_route_without_launch():
    x = torch.from_numpy(_qkv(2, 37, seed=3))
    before = A.fused_attention_qkv.launches
    got = A.fused_attention_qkv(x, H, D, SCALE)
    assert A.fused_attention_qkv.launches == before
    torch.testing.assert_close(got, A.attention_qkv_reference(x, H, D, SCALE),
                               rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(1, 10, 3 * H * D, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.fused_attention_qkv(x, H, D, SCALE)


# -- backward ----------------------------------------------------------------

# gradients: tests/test_attention_pallas.py:61-74,103-117 hold the Pallas
# backward at 1e-4; bf16 outputs are one rounding of f32 sums taken in
# another order, so one bf16 ulp (2e-2 at |x| < 4)
GRAD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n", [(2, 145), (2, 37)])
def test_bwd_reference_matches_pallas_bwd_kernel(b, n, dtype):
    from hgr_tpu.ops.attention_pallas import _attention_qkv_bwd_impl

    xj, xt = _pair(_qkv(b, n, seed=20 + n), dtype)
    g = np.random.RandomState(n).randn(b, n, H * D).astype(np.float32)
    gj, gt = _pair(g, dtype)
    want = _attention_qkv_bwd_impl(xj, gj, H, D, SCALE, interpret=True)
    got = A.attention_qkv_bwd_reference(xt, gt, H, D, SCALE)
    assert got.dtype == xt.dtype and got.shape == (b, n, 3 * H * D)
    np.testing.assert_allclose(_np(got), _np(want), **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_jax_vjp(dtype):
    """The port's gradient on the CPU against jax.vjp of the fused op with
    both Pallas kernels in interpret mode."""
    xj, xt = _pair(_qkv(2, 37, seed=5), dtype)
    g = np.random.RandomState(6).randn(2, 37, H * D).astype(np.float32)
    gj, gt = _pair(g, dtype)
    out_j, vjp = jax.vjp(
        lambda q: jax_fused_attention_qkv(q, H, D, SCALE, True), xj)
    (want,) = vjp(gj)
    xt.requires_grad_()
    out_t = A.fused_attention_qkv(xt, H, D, SCALE)
    np.testing.assert_allclose(_np(out_t.detach()), _np(out_j), **TOL[dtype])
    before = A.fused_attention_qkv_bwd.launches
    (got,) = torch.autograd.grad(out_t, xt, gt)
    assert A.fused_attention_qkv_bwd.launches == before  # CPU: plain
    np.testing.assert_allclose(_np(got), _np(want), **GRAD_TOL[dtype])


def test_plain_backward_passes_gradcheck_in_float64():
    """float64 gradcheck of the autograd.Function (plain backward) against
    finite differences, and against autograd of the plain forward chain;
    at a width where the Jacobian is small (2 heads of 4)."""
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 6, 24)
                         ).requires_grad_()
    scale = 4 ** -0.5
    assert torch.autograd.gradcheck(
        lambda q: A.fused_attention_qkv(q, 2, 4, scale), (x,), eps=1e-6,
        atol=1e-6)
    g = torch.from_numpy(np.random.RandomState(8).randn(2, 6, 8))
    (want,) = torch.autograd.grad(A.attention_qkv_reference(x, 2, 4, scale),
                                  x, g)
    got = A.attention_qkv_bwd_reference(x.detach(), g, 2, 4, scale)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
