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


# -- split operands (the tensor-parallel form) -------------------------------


def _split(x):
    """Three (B, N, H·D) operands: q, k, v of the packed projection."""
    return tuple(x[..., i * H * D:(i + 1) * H * D] for i in range(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [H, H // 2])  # full, and a TP head group
def test_split_reference_matches_pallas_split_impl(dtype, heads):
    from hgr_tpu.ops.attention_pallas import _split_fwd_impl

    x = _qkv(2, 37, seed=30)[..., :3 * heads * D]
    qkv = [x[..., i * heads * D:(i + 1) * heads * D] for i in range(3)]
    js, ts = zip(*(_pair(np.ascontiguousarray(t), dtype) for t in qkv))
    want = _split_fwd_impl(*js, heads, D, SCALE, interpret=True)
    got = A.attention_split_reference(*ts, heads, D, SCALE)
    assert got.dtype == ts[0].dtype and got.shape == (2, 37, heads * D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_bwd_reference_matches_pallas_split_bwd_impl(dtype):
    from hgr_tpu.ops.attention_pallas import _split_bwd_impl

    x = _qkv(2, 37, seed=31)
    g = np.random.RandomState(32).randn(2, 37, H * D).astype(np.float32)
    js, ts = zip(*(_pair(np.ascontiguousarray(t), dtype) for t in _split(x)))
    gj, gt = _pair(g, dtype)
    want = _split_bwd_impl(*js, gj, H, D, SCALE, interpret=True)
    got = A.attention_split_bwd_reference(*ts, gt, H, D, SCALE)
    for w, t in zip(want, got):
        assert t.dtype == ts[0].dtype and t.shape == (2, 37, H * D)
        np.testing.assert_allclose(_np(t), _np(w), **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_autograd_matches_jax_vjp(dtype):
    """Gradients of the three operands on the CPU against jax.vjp of the
    JAX split op with both Pallas kernels in interpret mode."""
    from hgr_tpu.ops.attention_pallas import (
        fused_attention_split as jax_fused_attention_split,
    )

    x = _qkv(2, 37, seed=33)
    g = np.random.RandomState(34).randn(2, 37, H * D).astype(np.float32)
    js, ts = zip(*(_pair(np.ascontiguousarray(t), dtype) for t in _split(x)))
    gj, gt = _pair(g, dtype)
    out_j, vjp = jax.vjp(lambda q, k, v: jax_fused_attention_split(
        q, k, v, H, D, SCALE, True), *js)
    want = vjp(gj)
    ts = [t.requires_grad_() for t in ts]
    out_t = A.fused_attention_split(*ts, H, D, SCALE)
    np.testing.assert_allclose(_np(out_t.detach()), _np(out_j), **TOL[dtype])
    before = (A.fused_attention_split.launches,
              A.fused_attention_split_bwd.launches)
    got = torch.autograd.grad(out_t, ts, gt)
    assert (A.fused_attention_split.launches,
            A.fused_attention_split_bwd.launches) == before  # CPU: plain
    for w, t in zip(want, got):
        np.testing.assert_allclose(_np(t), _np(w), **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_on_chunk_views_equals_packed_exactly(dtype):
    """The split op fed the chunk views of a packed projection computes
    the packed op's output and gradient bit for bit (one plain version,
    as on the card one kernel body)."""
    x = torch.from_numpy(_qkv(2, 37, seed=35)).to(getattr(torch, dtype))
    g = torch.from_numpy(np.random.RandomState(36).randn(2, 37, H * D)
                         .astype(np.float32)).to(x.dtype)
    xp = x.clone().requires_grad_()
    xs = x.clone().requires_grad_()
    out_p = A.fused_attention_qkv(xp, H, D, SCALE)
    out_s = A.fused_attention_split(*xs.chunk(3, dim=-1), H, D, SCALE)
    assert torch.equal(out_p, out_s)
    (gp,) = torch.autograd.grad(out_p, xp, g)
    (gs,) = torch.autograd.grad(out_s, xs, g)
    assert torch.equal(gp, gs)


def test_split_operands_are_checked():
    q = torch.zeros(2, 5, H * D)
    with pytest.raises(ValueError, match="share shape"):
        A._check_split((q, torch.zeros(2, 6, H * D), q), H, D)
    with pytest.raises(ValueError, match="unit feature stride"):
        A._check_split((q, q, torch.zeros(2, H * D, 5).transpose(1, 2)),
                       H, D)
    with pytest.raises(ValueError, match="cuda or cpu"):
        m = torch.empty(1, 10, H * D, device="meta")
        A.fused_attention_split(m, m, m, H, D, SCALE)


# -- numerics of the bf16 tensor-core backward --------------------------------


def _tensor_core_bwd_model(q, k, v, g, scale, parts=3):
    """The arithmetic of the bf16 body of csrc/attention_qkv_bwd.cu on
    heads-first operands (B, H, N, D) holding bf16 values: f32 scores on a
    grid padded to a multiple of 16 with zero rows, keys at or beyond n
    masked; P normalised, then rounded to bf16 for dv; dS split into
    ``parts`` bf16 terms (each the rounding of what the terms before it
    leave out) for dq and dk, each product an f32 sum of exact bf16
    products; P and dS zeroed at the pad query rows.

    Returns dq, dk, dv before their bf16 rounding, and the products of
    dS with K and Q (dq, dk) from 1, 2 and 3 terms and in float64."""
    n = q.shape[2]
    npad = -(-n // 16) * 16

    def pad(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, npad - n))

    qp, kp, vp, gp = (pad(t) for t in (q, k, v, g))
    valid = torch.arange(npad) < n
    s = (qp @ kp.transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    da = gp @ vp.transpose(-1, -2)
    ds = p * (da - (da * p).sum(-1, keepdim=True)) * scale
    ds = ds.masked_fill(~valid[:, None], 0.0)
    p = p.masked_fill(~valid[:, None], 0.0)
    terms, rest = [], ds
    for _ in range(3):
        terms.append(rest.to(torch.bfloat16).float())
        rest = rest - terms[-1]

    def dq_dk(x, y=(kp, qp)):
        return x @ y[0], x.transpose(-1, -2) @ y[1]

    def split(count):
        return tuple(sum(ts) for ts in zip(*(dq_dk(t) for t in
                                              terms[:count])))

    dq, dk = split(parts)
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ gp
    cut = (lambda ts: tuple(t[:, :, :n] for t in ts))
    products = {count: cut(split(count)) for count in (1, 2, 3)}
    products["f64"] = cut(dq_dk(ds.double(), (kp.double(), qp.double())))
    return cut((dq, dk, dv)), products


@pytest.mark.parametrize("n", [145, 37])
def test_tensor_core_bwd_numerics_match_pallas_bwd_kernel(n):
    """A model of the bf16 tensor-core backward's arithmetic, held against
    the Pallas backward kernel in interpret mode at the bf16 gradient
    tolerance. dS enters the tensor cores as three bf16 terms: rounded
    once to bf16 its products with K and Q miss the exact ones by ~3e-3,
    as hi + lo by ~5e-6 (enough to flip the bf16 rounding of a gradient
    near 1 now and then over a training batch), as three terms by no more
    than an f32 product's own error."""
    from hgr_tpu.ops.attention_pallas import _attention_qkv_bwd_impl

    xj, xt = _pair(_qkv(2, n, seed=40 + n), "bfloat16")
    g = np.random.RandomState(41 + n).randn(2, n, H * D).astype(np.float32)
    gj, gt = _pair(g, "bfloat16")
    want = _attention_qkv_bwd_impl(xj, gj, H, D, SCALE, interpret=True)

    grads, products = _tensor_core_bwd_model(
        *A.split_heads(xt, H, D), A._heads_first(gt, H, D), SCALE)
    got = torch.cat([A.merge_heads(t).to(torch.bfloat16) for t in grads],
                    dim=-1)
    np.testing.assert_allclose(_np(got), _np(want), **GRAD_TOL["bfloat16"])

    def err(count):
        return max((a.double() - b).abs().max().item()
                   for a, b in zip(products[count], products["f64"]))

    assert err(1) > 1e-3
    assert 1e-6 < err(2) <= 1e-5
    assert err(3) <= 1e-6


# -- long sequences and other head widths -----------------------------------

# (n, head_dim, heads): lengths the card's kernels take key-chunked (401
# in the f32 backward, 785 in the bf16 backward) and the padded widths
# 16, 32 (the model's, which the key-chunked ring bodies serve), 64, 128
# (48 pads to 64); B·H kept to 1-2 for interpret mode
LONG_CASES = [(n, hd, 2 if hd in (16, 32) else 1) for n in (401, 785)
              for hd in (16, 32, 48, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,head_dim,heads", LONG_CASES)
def test_plain_versions_match_pallas_at_long_n_and_other_widths(
        n, head_dim, heads, dtype):
    """The packed and split plain versions (what a CPU tensor runs and
    what the card's kernels are held to) against the Pallas kernels in
    interpret mode: ``_attention_qkv_impl``, ``_attention_qkv_bwd_impl``
    and the split impls, at sequence lengths past the card's
    whole-sequence route and at head widths other than the model's 32."""
    from hgr_tpu.ops.attention_pallas import (
        _attention_qkv_bwd_impl,
        _attention_qkv_impl,
        _split_bwd_impl,
        _split_fwd_impl,
    )

    hd = heads * head_dim
    rng = np.random.RandomState(n + head_dim)
    x = rng.randn(1, n, 3 * hd).astype(np.float32)
    g = rng.randn(1, n, hd).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    scale = head_dim**-0.5
    out = A.attention_qkv_reference(xt, heads, head_dim, scale)
    np.testing.assert_allclose(
        _np(out), _np(_attention_qkv_impl(xj, heads, head_dim, scale,
                                          interpret=True)), **TOL[dtype])
    d = A.attention_qkv_bwd_reference(xt, gt, heads, head_dim, scale)
    want_d = _attention_qkv_bwd_impl(xj, gj, heads, head_dim, scale,
                                     interpret=True)
    np.testing.assert_allclose(_np(d), _np(want_d), **GRAD_TOL[dtype])
    # the split form on three contiguous operands
    js, ts = zip(*(_pair(np.ascontiguousarray(x[..., i * hd:(i + 1) * hd]),
                         dtype) for i in range(3)))
    out_s = A.attention_split_reference(*ts, heads, head_dim, scale)
    np.testing.assert_allclose(
        _np(out_s), _np(_split_fwd_impl(*js, heads, head_dim, scale,
                                        interpret=True)), **TOL[dtype])
    d_s = A.attention_split_bwd_reference(*ts, gt, heads, head_dim, scale)
    for got, want in zip(d_s, _split_bwd_impl(*js, gj, heads, head_dim,
                                              scale, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), **GRAD_TOL[dtype])


def test_head_width_above_128_raises_naming_the_roadmap_item():
    """Every head width is taken since ROADMAP C2 closed: up to 256 by the
    padded bodies, above 256 by those of attention_wide.cuh (the name dates
    from the limit of 128, when widths above it raised naming C2; it is
    kept so that the test's record runs on). Only a width below 1 raises,
    before any launch."""
    A._check(torch.zeros(1, 5, 3 * 257), 1, 257)
    q = torch.zeros(1, 5, 257)
    A._check_split((q, q, q), 1, 257)
    A._check(torch.zeros(1, 5, 3 * 160), 1, 160)  # pads to 256
    A._check(torch.zeros(1, 5, 3 * 2 * 256), 2, 256)  # 256 is taken
    A._check(torch.zeros(1, 5, 3 * 2 * 512), 2, 512)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        A._check(torch.zeros(1, 5, 0), 1, 0)


@pytest.mark.parametrize("head_dim,taken", [
    (1, True), (16, True), (128, True), (129, True), (160, True),
    (192, True), (256, True), (0, False), (257, True), (512, True)])
def test_check_head_dim_takes_1_to_256(head_dim, taken):
    """Widths 1 to 256 (the padded bodies) and above (the bodies of
    attention_wide.cuh) are taken; 0 is not."""
    if taken:
        A._check_head_dim(head_dim)
    else:
        with pytest.raises(ValueError, match="head_dim >= 1"):
            A._check_head_dim(head_dim)


# (n, head_dim): the widths the card's bodies pad to 256 (160 and the
# full 256), at short lengths (interpret mode); 2 heads
WIDE_CASES = [(n, hd) for hd in (160, 256) for n in (17, 33)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,head_dim", WIDE_CASES)
def test_plain_versions_match_pallas_at_head_widths_to_256(n, head_dim,
                                                           dtype):
    """The packed and split plain versions (what the card's Dp = 256
    bodies are held to) against ``_attention_qkv_impl``,
    ``_attention_qkv_bwd_impl``, ``_split_fwd_impl`` and
    ``_split_bwd_impl`` in interpret mode: 1e-5 / 1e-4 in f32, 2e-2 in
    bf16."""
    _plain_against_pallas(n, head_dim, dtype)


# head widths above 256, which the card routes to the bodies of
# csrc/attention_wide.cuh (D padded with zero features to a multiple of
# 64): 320 and 512, 257 (not a multiple of 64, one feature past 256) and
# 384 at a length past one 32-key chunk
WIDER_CASES = [(17, 320), (17, 512), (17, 257), (33, 384)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,head_dim", WIDER_CASES)
def test_plain_versions_match_pallas_at_head_widths_above_256(n, head_dim,
                                                              dtype):
    """What the card's bodies of head widths above 256 are held to,
    against the Pallas kernels (which take any static head width) in
    interpret mode."""
    _plain_against_pallas(n, head_dim, dtype)


def _plain_against_pallas(n, head_dim, dtype):
    """The packed and split plain versions against ``_attention_qkv_impl``,
    ``_attention_qkv_bwd_impl``, ``_split_fwd_impl`` and
    ``_split_bwd_impl`` in interpret mode, 2 heads: 1e-5 / 1e-4 in f32,
    2e-2 in bf16."""
    from hgr_tpu.ops.attention_pallas import (
        _attention_qkv_bwd_impl,
        _attention_qkv_impl,
        _split_bwd_impl,
        _split_fwd_impl,
    )

    heads = 2
    hd = heads * head_dim
    rng = np.random.RandomState(n * 3 + head_dim)
    x = rng.randn(2, n, 3 * hd).astype(np.float32)
    g = rng.randn(2, n, hd).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    scale = head_dim**-0.5
    out = A.attention_qkv_reference(xt, heads, head_dim, scale)
    assert out.shape == (2, n, hd)
    np.testing.assert_allclose(
        _np(out), _np(_attention_qkv_impl(xj, heads, head_dim, scale,
                                          interpret=True)), **TOL[dtype])
    d = A.attention_qkv_bwd_reference(xt, gt, heads, head_dim, scale)
    np.testing.assert_allclose(
        _np(d), _np(_attention_qkv_bwd_impl(xj, gj, heads, head_dim, scale,
                                            interpret=True)),
        **GRAD_TOL[dtype])
    js, ts = zip(*(_pair(np.ascontiguousarray(x[..., i * hd:(i + 1) * hd]),
                         dtype) for i in range(3)))
    np.testing.assert_allclose(
        _np(A.attention_split_reference(*ts, heads, head_dim, scale)),
        _np(_split_fwd_impl(*js, heads, head_dim, scale, interpret=True)),
        **TOL[dtype])
    for got, want in zip(
            A.attention_split_bwd_reference(*ts, gt, heads, head_dim, scale),
            _split_bwd_impl(*js, gj, heads, head_dim, scale, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), **GRAD_TOL[dtype])
    # the autograd route on CPU tensors runs these plain versions
    xr = xt.clone().requires_grad_()
    before = (A.fused_attention_qkv.launches,
              A.fused_attention_qkv_bwd.launches)
    (got_d,) = torch.autograd.grad(
        A.fused_attention_qkv(xr, heads, head_dim, scale), xr, gt)
    assert (A.fused_attention_qkv.launches,
            A.fused_attention_qkv_bwd.launches) == before
    assert torch.equal(got_d, d)
