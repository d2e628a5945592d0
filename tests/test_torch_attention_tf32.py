"""A model of the f32 attention kernels' tensor-core arithmetic
(hgr_tpu_torch/csrc/attention_tf32.cuh), held against the JAX package's
Pallas kernels (hgr_tpu/ops/attention_pallas.py) in interpret mode.

The card's f32 bodies take every product on the tensor cores by a
three-way TF32 split of each f32 operand: big = cvt.rna.tf32(x), small =
cvt.rna.tf32(x - big), and x . y = big_x small_y + small_x big_y +
big_x big_y, each m16n8k8 step (8 deep) added to an f32 accumulator. A
product whose A operand is a C tile (P V, dS K, dS^T Q, P^T G) takes the 8
keys of a step in a permuted order (A's column t is key 2t, column t + 4
key 2t + 1), and at the model's head width sums each 32 keys (or
queries) into a fresh accumulator that a rounding add takes into the
output. The model below does the same in torch: the roundings on the f32
bits, each step's 8 exact products summed in float64 onto the f32
accumulator and rounded once (to nearest, or toward zero as the card's
tensor cores do), the terms in the kernels' order, the scores scaled in
f32, max, exp and sum in f32, P = exp(s - max) times the reciprocal of
the sum, dS = P (dA - sum dA P) scale from the unrounded P.

Tolerances are the JAX kernel tests' own (tests/test_attention_pallas.py):
1e-5 forward, 1e-4 gradients, in float32. B * H <= 16 for interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu_torch.ops import attention as A

torch.set_num_threads(1)

D = 32
SCALE = D**-0.5
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# A step of 8 keys in the order the A fragment takes them: its column c
# holds key PERM[c] (columns t and t + 4 hold keys 2t and 2t + 1).
PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bits: nearest, ties away from zero
    (the magnitude's bits rounded up at half), the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def to_f32(x: torch.Tensor, truncate: bool) -> torch.Tensor:
    """float64 -> float32 to nearest, or toward zero."""
    r = x.float()
    if truncate:
        over = r.double().abs() > x.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def product(x: torch.Tensor, y: torch.Tensor, terms: int = 3,
            perm: bool = False, group: int = 0,
            truncate: bool = False) -> torch.Tensor:
    """x (..., M, K) . y (..., K, N) in f32 as the tensor cores take it:
    K in steps of 8, each step's products exact (float64) and added to the
    f32 accumulator with one rounding (toward zero with ``truncate``);
    three terms in the kernels' order (big small, small big, big big) or
    one (big big). ``perm`` takes each step's 8 rows of y (columns of x)
    in PERM's order. ``group`` > 0 sums each ``group`` rows of K into a
    fresh accumulator, added to the result with a rounding add."""
    xb, xs = split(x)
    yb, ys = split(y)
    pairs = [(xb, ys), (xs, yb), (xb, yb)] if terms == 3 else [(xb, yb)]
    out = torch.zeros(*x.shape[:-1], y.shape[-1], dtype=torch.float32)
    size = group or x.shape[-1]
    for g0 in range(0, x.shape[-1], size):
        c = torch.zeros_like(out)
        for k0 in range(g0, min(g0 + size, x.shape[-1]), 8):
            idx = [k0 + p for p in PERM] if perm else list(range(k0, k0 + 8))
            for a, b in pairs:
                c = to_f32(c.double() + a[..., idx].double()
                           @ b[..., idx, :].double(), truncate)
        out = c if not group else (out.double() + c.double()).float()
    return out


def _pad(t, npad):
    return torch.nn.functional.pad(t, (0, 0, 0, npad - t.shape[-2]))


def model(q, k, v, g=None, scale=SCALE, terms=3, group=32, truncate=False):
    """The f32 bodies on heads-first (B, H, N, D) float32 operands: the
    forward output, and with the cotangent g also (dq, dk, dv). ``group``
    and ``truncate`` as in ``product`` for the products that sum over the
    sequence (the kernels' 32 rows at head widths up to 64)."""
    seq = dict(perm=True, group=group, truncate=truncate)
    n = q.shape[-2]
    npad = -(-n // 16) * 16
    qp, kp, vp = (_pad(t, npad) for t in (q, k, v))
    valid = torch.arange(npad) < n
    s = product(qp, kp.transpose(-1, -2), terms,
                truncate=truncate) * torch.tensor(
        scale, dtype=torch.float32)
    s = s.masked_fill(~valid, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    out = product(p, vp, terms, **seq)[..., :n, :]
    if g is None:
        return out
    gp = _pad(g, npad)
    da = product(gp, vp.transpose(-1, -2), terms, truncate=truncate)
    rd = (da * p).sum(-1, keepdim=True)
    ds = p * (da - rd) * torch.tensor(scale, dtype=torch.float32)
    ds = ds.masked_fill(~valid[:, None], 0.0)
    pq = p.masked_fill(~valid[:, None], 0.0)
    dq = product(ds, kp, terms, **seq)
    dk = product(ds.transpose(-1, -2), qp, terms, **seq)
    dv = product(pq.transpose(-1, -2), gp, terms, **seq)
    return out, tuple(t[..., :n, :] for t in (dq, dk, dv))


def _inputs(b, n, heads, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3 * heads * D).astype(np.float32)
    g = rng.randn(b, n, heads * D).astype(np.float32)
    return x, g


def _heads(x, g, heads):
    xt = torch.from_numpy(x)
    q, k, v = A.split_heads(xt, heads, D)
    return q, k, v, A._heads_first(torch.from_numpy(g), heads, D)


def _packed(out, grads=None):
    """(B, H, N, D) -> (B, N, H*D); the three gradients packed as dqkv."""
    if grads is None:
        return A.merge_heads(out).numpy()
    return torch.cat([A.merge_heads(t) for t in grads], dim=-1).numpy()


def test_tf32_rounding_is_nearest_ties_away_and_split_is_exact():
    """The emulated cvt.rna.tf32 keeps 10 mantissa bits, rounding to
    nearest with ties away from zero; x - big is exact in f32, and big +
    small carries x to within 2^-21 of its magnitude."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0**-10
    cases = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-20,
                          1 + 3 * ulp / 2, 3.14159265, -2.5e-7],
                         dtype=torch.float32)
    got = tf32(cases)
    assert got[0] == 1 + ulp and got[1] == -(1 + ulp)  # ties away
    assert got[2] == one  # below half: down
    assert got[3] == 1 + 2 * ulp
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    big, small = split(x)
    assert torch.equal((x - big).double(), x.double() - big.double())
    rest = (x.double() - big.double() - small.double()).abs()
    assert (rest <= x.double().abs() * 2.0**-21).all()


def test_permuted_key_order_is_a_relabeling_of_the_step():
    """Taking a step's 8 keys in PERM's order (the order of the A fragment
    built from a C tile) gives the same product bit for bit: each step's
    sum is the same sum."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 16, 48).astype(np.float32))
    y = torch.from_numpy(rng.randn(2, 48, 24).astype(np.float32))
    assert torch.equal(product(x, y, perm=True), product(x, y))


def test_fresh_accumulators_bound_the_drift_of_truncating_sums():
    """Why the kernels sum each 32 rows of a sequence product into a fresh
    accumulator: with the accumulation rounding toward zero at every
    step, as the card's tensor cores do, a P V sum over 401 keys taken
    straight into the output drifts from float64 several times farther
    than the same sum taken 32 keys at a time (rounding adds between)."""
    heads = 8
    x, g = _inputs(2, 401, heads, seed=9)
    q, k, v, _ = _heads(x, g, heads)
    exact = A.attention_qkv_reference(torch.from_numpy(x).double(), heads,
                                      D, SCALE).numpy()

    def err(group):
        out = model(q, k, v, group=group, truncate=True)
        return np.abs(_packed(out) - exact).max()

    straight, grouped = err(0), err(32)
    assert grouped * 3 < straight
    assert grouped <= 5e-6


@pytest.mark.parametrize("n", [37, 145, 401])
def test_tf32_model_matches_pallas_kernels(n):
    """The model of the f32 bodies (forward and backward, three terms)
    against ``_attention_qkv_impl`` and ``_attention_qkv_bwd_impl`` in
    interpret mode at the f32 kernel and gradient tolerances; B * H = 16."""
    from hgr_tpu.ops.attention_pallas import (
        _attention_qkv_bwd_impl,
        _attention_qkv_impl,
    )

    heads = 8
    x, g = _inputs(2, n, heads, seed=n)
    out, grads = model(*_heads(x, g, heads))
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    want = _attention_qkv_impl(xj, heads, D, SCALE, interpret=True)
    np.testing.assert_allclose(_packed(out), np.asarray(want), **KERNEL_TOL)
    want_d = _attention_qkv_bwd_impl(xj, gj, heads, D, SCALE, interpret=True)
    np.testing.assert_allclose(_packed(out, grads), np.asarray(want_d),
                               **GRAD_TOL)


@pytest.mark.parametrize("n", [145, 401])
def test_one_tf32_term_misses_and_three_terms_hold_f32(n):
    """Against float64: one TF32 term per product (plain TF32) misses the
    f32 kernels' tolerances (> 1e-4 off, forward and gradients); the three
    terms stay within 5e-6, where the f32 plain version itself sits."""
    heads = 8
    x, g = _inputs(2, n, heads, seed=100 + n)
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(g).double()
    exact = A.attention_qkv_reference(xt, heads, D, SCALE).numpy()
    exact_d = A.attention_qkv_bwd_reference(xt, gt, heads, D, SCALE).numpy()

    def err(terms):
        out, grads = model(*_heads(x, g, heads), terms=terms)
        return (np.abs(_packed(out) - exact).max(),
                np.abs(_packed(out, grads) - exact_d).max())

    one, three = err(1), err(3)
    assert one[0] > 1e-4 and one[1] > 1e-4
    assert three[0] <= 5e-6 and three[1] <= 5e-6


@pytest.mark.parametrize("heads", [8, 4])  # full, and a TP rank's head group
def test_tf32_model_on_split_operands_matches_pallas_split_kernels(heads):
    """The split kernels run the same f32 bodies on q, k and v as three
    operands: the model on them against ``_split_fwd_impl`` and
    ``_split_bwd_impl`` in interpret mode."""
    from hgr_tpu.ops.attention_pallas import _split_bwd_impl, _split_fwd_impl

    x, g = _inputs(2, 145, heads, seed=7 + heads)
    hd = heads * D
    ops = [np.ascontiguousarray(x[..., i * hd:(i + 1) * hd]) for i in range(3)]
    q, k, v = (A._heads_first(torch.from_numpy(t), heads, D) for t in ops)
    out, grads = model(q, k, v, A._heads_first(torch.from_numpy(g), heads, D))
    js = [jnp.asarray(t) for t in ops]
    want = _split_fwd_impl(*js, heads, D, SCALE, interpret=True)
    np.testing.assert_allclose(_packed(out), np.asarray(want), **KERNEL_TOL)
    want_d = _split_bwd_impl(*js, jnp.asarray(g), heads, D, SCALE,
                             interpret=True)
    for got, w in zip(grads, want_d):
        np.testing.assert_allclose(A.merge_heads(got).numpy(), np.asarray(w),
                                   **GRAD_TOL)


def test_tf32_model_agrees_with_the_plain_versions():
    """The model (what the card computes) against the port's plain
    versions (what the card's kernels are held to) at the card checks'
    tolerances, on a batch with several heads and a ragged length."""
    heads = 4
    x, g = _inputs(3, 53, heads, seed=5)
    out, grads = model(*_heads(x, g, heads))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    np.testing.assert_allclose(
        _packed(out), A.attention_qkv_reference(xt, heads, D, SCALE).numpy(),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        _packed(out, grads),
        A.attention_qkv_bwd_reference(xt, gt, heads, D, SCALE).numpy(),
        **GRAD_TOL)
