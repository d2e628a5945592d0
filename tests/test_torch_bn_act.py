"""The port's fused BatchNorm(+SiLU) (hgr_tpu_torch/ops/bn_act.py and the
fused route of models/layers.ConvBnAct) held against the JAX package's
(hgr_tpu/ops/bn_act_pallas.py, layers._FusedBNAct).

The same numpy inputs go to both. The Pallas pair runs in interpret mode
on the CPU through the ``pallas_call`` patch of tests/test_bn_act.py;
the port's two passes run their plain versions (the kernels need the
card: tests/test_torch_gpu.py).

Tolerances and why:
- forward and dy: 1e-5 in f32 (sums in another order), 2e-2 in bf16 (one
  bf16 rounding of values of magnitude ~1): tests/test_bn_act.py;
- T1/T2 (dbeta/dgamma): 1e-3, tests/test_bn_act.py:97;
- the layer and the train step: the JAX package's gradient tolerance 1e-4
  in f32 (tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.models import layers as jax_layers
from hgr_tpu.models.layers import ConvBnAct as JaxConvBnAct
from hgr_tpu.ops import bn_act_pallas as bna
from hgr_tpu_torch.models import layers
from hgr_tpu_torch.models.layers import ConvBnAct
from hgr_tpu_torch.ops import bn_act as B
from hgr_tpu_torch.utils.convert import from_flax
from test_torch_train import (  # noqa: F401 — jax_variables is a fixture
    _compare_grads,
    _compare_metrics,
    _compare_state,
    _inject,
    _one_step,
    jax_variables,
    PARAMS,
)

torch.set_num_threads(1)

EPS = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST
SHAPES = [(2, 6, 6, 32), (1, 33, 7, 64)]
DY_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    y = (rng.randn(*shape) * 1.5 + 0.2).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jax_in = (jnp.asarray(y, jd), jnp.asarray(gamma), jnp.asarray(beta),
              jnp.asarray(g, jd))
    port_in = (torch.from_numpy(y).to(td), torch.from_numpy(gamma),
               torch.from_numpy(beta), torch.from_numpy(g).to(td))
    return jax_in, port_in


@pytest.fixture
def fused_route():
    """The fused route on in both packages, restored afterwards."""
    jax_layers._FUSED_BN = True
    layers._FUSED_BN = True
    yield
    jax_layers._FUSED_BN = None
    layers._FUSED_BN = None


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_and_backward_match_jax(shape, dtype, act):
    (jy, jgam, jbet, jg), (ty, tgam, tbet, tg) = _inputs(shape, dtype, 0)
    j_out, j_mean, j_var = bna._fwd_chain(jy, jgam, jbet, EPS, act)
    t_out, t_mean, t_var = B.fwd_chain(ty, tgam, tbet, EPS, act)
    assert t_out.dtype == ty.dtype
    tol = DY_TOL[dtype]
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(t_mean), _np(j_mean), atol=1e-5)
    np.testing.assert_allclose(_np(t_var), _np(j_var), rtol=1e-5)
    want = bna._bwd_reference(jy, jgam, jbet, j_mean, j_var, jg, EPS, act)
    got = B.bn_act_bwd(ty, tgam, tbet, t_mean, t_var, tg, EPS, act)
    assert got[0].dtype == ty.dtype
    for a, b, t in zip(got, want, (tol, 1e-3, 1e-3)):
        np.testing.assert_allclose(_np(a), _np(b), atol=t, rtol=t)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_two_passes_match_jax_pallas_pair(monkeypatch, shape, dtype, act):
    """The port's reduce + elementwise passes (plain versions on the CPU)
    against the Pallas pair in interpret mode, whose (1, 33, 7) case runs
    the padded last block."""
    from jax.experimental import pallas as pl

    real_call = pl.pallas_call

    def interp_call(*a, **k):
        k.setdefault("interpret", True)
        return real_call(*a, **k)

    monkeypatch.setattr(bna.pl, "pallas_call", interp_call)
    (jy, jgam, jbet, jg), (ty, tgam, tbet, tg) = _inputs(shape, dtype, 1)
    _, j_mean, j_var = bna._fwd_chain(jy, jgam, jbet, EPS, act)
    want = bna._bwd_pallas(jy, jgam, jbet, j_mean, j_var, jg, EPS, act)
    _, t_mean, t_var = B.fwd_chain(ty, tgam, tbet, EPS, act)
    got = B.bn_act_bwd(ty, tgam, tbet, t_mean, t_var, tg, EPS, act)
    assert got[0].dtype == ty.dtype and got[0].shape == ty.shape
    for a, b, t in zip(got, want, (DY_TOL[dtype], 1e-3, 1e-3)):
        np.testing.assert_allclose(_np(a), _np(b), atol=t, rtol=t)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_autograd_of_plain_chain(dtype, act):
    _, (ty, tgam, tbet, tg) = _inputs((3, 5, 4, 24), dtype, 2)

    def grads(fn):
        y, gam, bet = (t.clone().requires_grad_() for t in (ty, tgam, tbet))
        out, _, _ = fn(y, gam, bet, EPS, act)
        return out, torch.autograd.grad(
            (out.float() * tg.float()).sum(), (y, gam, bet))

    out_f, g_f = grads(B.bn_act)
    out_p, g_p = grads(B.fwd_chain)
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    tol = DY_TOL[dtype]
    for a, b in zip(g_f, g_p):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def test_statistics_carry_no_gradient():
    _, (ty, tgam, tbet, _) = _inputs((2, 3, 3, 8), "float32", 3)
    y = ty.clone().requires_grad_()
    out, mean, var = B.bn_act(y, tgam, tbet, EPS)
    assert out.requires_grad and not mean.requires_grad
    assert not var.requires_grad


@pytest.mark.parametrize("use_act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convbnact_fused_route_matches_jax(fused_route, use_act, dtype):
    """Output, parameter gradients and running statistics of one fused
    train-mode forward/backward against the JAX fused route."""
    rng = np.random.RandomState(4)
    x = (rng.randn(4, 8, 8, 16) * 0.5).astype(np.float32)
    ct = rng.randn(4, 8, 8, 32).astype(np.float32)
    jm = JaxConvBnAct(32, 3, 1, use_act=use_act, dtype=getattr(jnp, dtype),
                      precision=HIGHEST)
    variables = jm.init(jax.random.PRNGKey(1), x, train=True)

    def loss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * ct), (out, mut)

    (_, (j_out, j_mut)), j_grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    tm = ConvBnAct(16, 32, 3, 1, use_act=use_act,
                   dtype=getattr(torch, dtype)).train()
    tm.load_state_dict(from_flax(variables), strict=True)
    t_out = tm(torch.from_numpy(x))
    assert t_out.dtype == getattr(torch, dtype)
    params = dict(tm.named_parameters())
    t_grads = torch.autograd.grad(
        (t_out.float() * torch.from_numpy(ct)).sum(), list(params.values()))
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=tol, rtol=tol)
    want = from_flax({"params": j_grads})
    for (k, _), g in zip(params.items(), t_grads):
        scale = max(float(np.abs(want[k].numpy()).max()), 1.0)
        np.testing.assert_allclose(_np(g), want[k].numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=k)
    stats = from_flax({"params": {}, **j_mut})
    for k in ("bn.mean", "bn.var"):
        np.testing.assert_allclose(_np(tm.state_dict()[k]), stats[k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_one_state_dict_serves_both_routes():
    """The fused and plain routes read and write the same parameters and
    buffers: a state dict from one loads into the other, one train step
    of each from the same state updates the statistics alike (two-pass vs
    fast variance: rounding), and eval reads the fused-trained stats."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(6, 7, 7, 8) * 2 + 1).astype(np.float32))
    a = ConvBnAct(8, 16, 3, 1)
    layers.torch_init_(a, torch.Generator().manual_seed(0))
    b = ConvBnAct(8, 16, 3, 1)
    b.load_state_dict(a.state_dict(), strict=True)
    try:
        layers._FUSED_BN = True
        out_a = a.train()(x)
        layers._FUSED_BN = False
        out_b = b.train()(x)
    finally:
        layers._FUSED_BN = None
    assert a.state_dict().keys() == b.state_dict().keys()
    np.testing.assert_allclose(_np(out_a), _np(out_b), atol=1e-5)
    for k in ("bn.mean", "bn.var"):
        np.testing.assert_allclose(_np(a.state_dict()[k]),
                                   _np(b.state_dict()[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(a.eval()(x)), _np(b.eval()(x)), atol=1e-5)


@pytest.mark.parametrize("value", [None, "on", "off", "auto", "1", "0",
                                   "true", "false", "maybe"])
def test_fused_bn_resolution_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HGR_TPU_FUSED_BN", raising=False)
    else:
        monkeypatch.setenv("HGR_TPU_FUSED_BN", value)
    assert layers.fused_bn() == jax_layers.fused_bn()
    monkeypatch.setattr(layers, "_FUSED_BN", True)
    assert layers.fused_bn() is True
    monkeypatch.setattr(layers, "_FUSED_BN", False)
    assert layers.fused_bn() is False


def test_fused_bn_is_off_by_default(monkeypatch):
    monkeypatch.delenv("HGR_TPU_FUSED_BN", raising=False)
    assert layers.fused_bn() is False
    assert layers._FUSED_BN_AUTO is False


def test_f32_train_step_with_fused_bn_matches_jax(jax_variables, monkeypatch,
                                                  fused_route):
    """One f32 merged-loss step of the whole model with every train-mode
    ConvBnAct on the fused route, both sides (the harness and tolerances of
    tests/test_torch_train.py)."""
    _inject(monkeypatch, PARAMS)
    tx_state, m_j, ps, m_p = _one_step(jax_variables, "float32", False)
    _compare_grads(m_p.pop("_grads"), m_j.pop("_grads"), atol=1e-4,
                   rtol=1e-4)
    _compare_metrics(m_p, m_j)
    _compare_state(ps, tx_state)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pass_wrappers_cpu_route_matches_jax_pallas_pair(monkeypatch, dtype,
                                                         act):
    """``bn_act_reduce`` and ``bn_act_elem`` themselves (the wrappers the
    card's kernels sit behind, which now take the per-channel vectors one
    pointer each) on CPU tensors: their plain versions, no launch counted,
    against the Pallas pair in interpret mode; the vectors may be any
    strided float32 view."""
    from jax.experimental import pallas as pl

    real_call = pl.pallas_call
    monkeypatch.setattr(bna.pl, "pallas_call",
                        lambda *a, **k: real_call(*a, **{"interpret": True,
                                                         **k}))
    shape = (2, 12, 12, 64)
    (jy, jgam, jbet, jg), (ty, tgam, tbet, tg) = _inputs(shape, dtype, 4)
    _, j_mean, j_var = bna._fwd_chain(jy, jgam, jbet, EPS, act)
    want_dy, want_t2, want_t1 = bna._bwd_pallas(jy, jgam, jbet, j_mean,
                                                j_var, jg, EPS, act)
    _, mean, var = B.fwd_chain(ty, tgam, tbet, EPS, act)
    r = torch.rsqrt(var + EPS)
    gamma = torch.stack([tgam, tgam])[:, None].expand(2, 3, 64)[1, 2]
    y2, g2 = ty.reshape(-1, 64), tg.reshape(-1, 64)
    before = (B.bn_act_reduce.launches, B.bn_act_elem.launches)
    t1, t2 = B.bn_act_reduce(y2, g2, mean, r, gamma, tbet, act)
    m = float(y2.shape[0])
    dy = B.bn_act_elem(y2, g2, mean, r, gamma, tbet, t1 / m, t2 / m, act)
    assert (B.bn_act_reduce.launches, B.bn_act_elem.launches) == before
    assert t1.dtype == t2.dtype == torch.float32 and dy.dtype == ty.dtype
    np.testing.assert_allclose(_np(t1), _np(want_t1), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(t2), _np(want_t2), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(dy.reshape(shape)), _np(want_dy),
                               atol=DY_TOL[dtype], rtol=DY_TOL[dtype])
