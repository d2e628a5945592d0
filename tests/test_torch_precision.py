"""The classifier's precision and lowering knobs in the port
(``decoder_dtype``, ``early_dtype``/``early_units``, bf16 BN, ``remat``,
``stride2_impl`` 's2d'/'dense_grad', and the training CLI's ``--dtype
mixed``) held against the JAX package and against the default route.

The same Flax variables go through the JAX module (``precision=HIGHEST``)
and, through ``from_flax``, the port. Tolerances: float32 parts 1e-5
(f32 sums in another order), float32 gradients 1e-4 (the JAX package's
gradient tolerance); bf16 parts 2e-2, one bf16 ulp at |x| < 4 (the two
frameworks round bf16 at different places: XLA keeps fused elementwise
chains in f32); a bf16 heatmap of the whole model 6e-2 as in
tests/test_torch_model.py. Steps with bf16 parts are held as
tests/test_torch_train.py holds the bf16 step: the relative norm of the
gradient difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu import config as jax_config
from hgr_tpu.config import AugmentConfig as JaxAugmentConfig
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.models import layers as jax_layers
from hgr_tpu.train import state as jax_state
from hgr_tpu.train import steps as jax_steps
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.config import (
    DEFAULT_NAMES,
    AugmentConfig,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from hgr_tpu_torch.models import MultiTaskNet, layers
from hgr_tpu_torch.ops import bn_act as bn_act_mod
from hgr_tpu_torch.train import state as port_state
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.utils.convert import from_flax
from test_torch_model import _perturb_bn
from test_torch_train import PARAMS, _inject, _np, _staged_batch

torch.set_num_threads(1)

HI = jax.lax.Precision.HIGHEST
S = 48
F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
BF16_HEATMAP = dict(atol=6e-2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, None: None}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}


def _images(b=2, seed=1):
    return np.random.RandomState(seed).randn(b, S, S, 3).astype(np.float32)


def _jax_model(dtype="bfloat16", decoder=None, early=None, units=3,
               **kw):
    return JaxMultiTaskNet(image_size=(S, S), dtype=JDT[dtype],
                           decoder_dtype=JDT[decoder],
                           early_dtype=JDT[early], early_units=units,
                           precision=HI, **kw)


def _port_model(variables, dtype="bfloat16", decoder=None, early=None,
                units=3, **kw):
    m = MultiTaskNet(image_size=(S, S), dtype=TDT[dtype],
                     decoder_dtype=TDT[decoder], early_dtype=TDT[early],
                     early_units=units, **kw)
    m.load_state_dict(from_flax(variables), strict=True)
    return m


@pytest.fixture(scope="module")
def variables():
    """Flax variables of MultiTaskNet small at 48 px, BN perturbed (they
    do not depend on the dtypes)."""
    jm = _jax_model("float32")
    return _perturb_bn(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, S, S, 3)), train=False), seed=3)


@pytest.fixture
def bf16_bn(monkeypatch):
    """bf16 BN on both sides, through each package's override."""
    monkeypatch.setattr(jax_layers, "_BN_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(layers, "_BN_DTYPE", torch.bfloat16)


def _intermediates(jm, variables, x, train):
    kw = dict(mutable=["batch_stats", "intermediates"]) if train else dict(
        mutable=["intermediates"])
    (cls, hmap, _), mut = jm.apply(variables, x, train=train,
                                   need_attnmap=False,
                                   capture_intermediates=True, **kw)
    return cls, hmap, mut


def _stats_of(mutated):
    return from_flax({"params": {}, "batch_stats": mutated["batch_stats"]})


# -- the forwards ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_early_dtype_forward_matches_jax(variables, train):
    """bf16 body, the first 3 units f32: the units' dtypes, the f32 early
    units' output (cspelan1) within 1e-5, the whole model within bf16's
    rounding, the train-mode statistics within 1e-5 in the f32 units."""
    jm = _jax_model("bfloat16", early="float32")
    x = _images()
    jc, jh, mut = _intermediates(jm, variables, x, train)
    tm = _port_model(variables, "bfloat16", early="float32").train(train)
    enc = tm.encoder
    assert [enc.conv1.dtype, enc.conv2.dtype, enc.cspelan1.cv1.dtype,
            enc.down1.dtype, enc.cspelan3.cv4.dtype] == [
        torch.float32, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16]
    seen = {}
    enc.cspelan1.register_forward_hook(
        lambda m, a, out: seen.setdefault("cspelan1", out))
    with torch.no_grad():
        tc, th, _ = tm(torch.from_numpy(x), need_attnmap=False)
    want = mut["intermediates"]["encoder"]["cspelan1"]["__call__"][0]
    assert seen["cspelan1"].dtype == torch.float32
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(_np(seen["cspelan1"]), _np(want), **F32)
    np.testing.assert_allclose(_np(tc), _np(jc), **BF16)
    np.testing.assert_allclose(_np(th), _np(jh), **BF16_HEATMAP)
    if train:
        want_s, got_s = _stats_of(mut), tm.state_dict()
        for k, w in want_s.items():
            early = k.startswith(("encoder.conv1.", "encoder.conv2.",
                                  "encoder.cspelan1."))
            np.testing.assert_allclose(_np(got_s[k]), w.numpy(),
                                       **(F32 if early else BF16),
                                       err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_decoder_dtype_forward_matches_jax(variables, train):
    """bf16 backbone, f32 decoder (--dtype mixed): the projection and the
    ViT in f32; fed the JAX backbone's features they give the JAX
    outputs within 1e-5, and the whole model is within bf16's rounding."""
    jm = _jax_model("bfloat16", decoder="float32")
    x = _images(seed=2)
    jc, jh, mut = _intermediates(jm, variables, x, train)
    tm = _port_model(variables, "bfloat16", decoder="float32").train(train)
    assert tm.proj.dtype == tm.decoder.dtype == torch.float32
    assert tm.encoder.conv1.dtype == torch.bfloat16
    feats = mut["intermediates"]["encoder"]["__call__"][0]
    assert feats.dtype == jnp.bfloat16
    with torch.no_grad():
        f = torch.from_numpy(np.asarray(feats, np.float32)).to(
            torch.bfloat16)
        dc, dh, _ = tm.decoder(tm.proj(f), need_attnmap=False)
        tc, th, _ = tm(torch.from_numpy(x), need_attnmap=False)
    np.testing.assert_allclose(_np(dc), _np(jc), **F32)
    np.testing.assert_allclose(_np(dh), _np(jh), **F32)
    np.testing.assert_allclose(_np(tc), _np(jc), **BF16)
    np.testing.assert_allclose(_np(th), _np(jh), **BF16_HEATMAP)


@pytest.mark.parametrize("train", [False, True])
def test_bf16_bn_forward_matches_jax(variables, bf16_bn, train):
    """HGR_TPU_BN_DTYPE=bfloat16 under a bf16 model: the BN output cast to
    bf16 before the SiLU, as Flax's bf16 BatchNorm; the statistics stay
    f32 and within 1e-5 of Flax's where the conv outputs agree."""
    jm = _jax_model("bfloat16")
    x = _images(seed=4)
    jc, jh, mut = _intermediates(jm, variables, x, train)
    tm = _port_model(variables, "bfloat16").train(train)
    with torch.no_grad():
        tc, th, _ = tm(torch.from_numpy(x), need_attnmap=False)
    np.testing.assert_allclose(_np(tc), _np(jc), **BF16)
    np.testing.assert_allclose(_np(th), _np(jh), **BF16_HEATMAP)
    if train:
        got = tm.state_dict()
        # the stem's statistics come from identical bf16 conv outputs
        for k in ("encoder.conv1.bn.mean", "encoder.conv1.bn.var"):
            np.testing.assert_allclose(_np(got[k]), _stats_of(mut)[k]
                                       .numpy(), **F32, err_msg=k)


def test_bf16_bn_changes_only_the_chain_rounding(variables, bf16_bn):
    """One ConvBnAct: bf16 BN is the f32 chain's output rounded to bf16,
    then the SiLU in bf16; under an f32 conv dtype the knob does nothing
    (hgr_tpu/models/layers.py:334-336)."""
    x = torch.from_numpy(_images(seed=5))
    for dtype in (torch.bfloat16, torch.float32):
        m = layers.ConvBnAct(3, 8, 3, 2, dtype=dtype).eval()
        layers.torch_init_(m, torch.Generator().manual_seed(5))
        with torch.no_grad():
            m.bn.mean.uniform_(-0.2, 0.2)
            got = m(x)
            y = m.bn(m.conv(x))
            want = (torch.nn.functional.silu(y.to(torch.bfloat16))
                    if dtype == torch.bfloat16
                    else torch.nn.functional.silu(y))
        assert torch.equal(got, want.to(dtype)), dtype


def test_bn_dtype_reads_the_environment_lazily(monkeypatch):
    monkeypatch.setattr(layers, "_BN_DTYPE", None)
    monkeypatch.delenv("HGR_TPU_BN_DTYPE", raising=False)
    assert layers.bn_dtype() == torch.float32
    monkeypatch.setenv("HGR_TPU_BN_DTYPE", "bfloat16")
    assert layers.bn_dtype() == torch.bfloat16
    monkeypatch.setattr(layers, "_BN_DTYPE", torch.float32)
    assert layers.bn_dtype() == torch.float32


@pytest.mark.parametrize("bn,dtype,units,fused_calls", [
    ("float32", "bfloat16", 0, "all"),
    ("bfloat16", "bfloat16", 0, 0),
    ("bfloat16", "bfloat16", 3, "early"),
    ("bfloat16", "float32", 0, "all"),
])
def test_fused_route_taken_only_on_an_f32_chain(monkeypatch, bn, dtype,
                                                 units, fused_calls):
    """fused_bn() on: a ConvBnAct takes ops/bn_act.bn_act only when its
    chain is f32 (layers.py:337-342): bf16 BN under a bf16 conv keeps the
    plain bf16 chain, f32 early units still take the fused route."""
    calls = []
    real = bn_act_mod.bn_act

    def counting(y, *a, **k):
        calls.append(y.dtype)
        return real(y, *a, **k)

    monkeypatch.setattr(layers, "bn_act", counting)
    monkeypatch.setattr(layers, "_FUSED_BN", True)
    monkeypatch.setattr(layers, "_BN_DTYPE", TDT[bn])
    m = MultiTaskNet(image_size=(S, S), dtype=TDT[dtype],
                     early_dtype=torch.float32 if units else None,
                     early_units=units, depth=1).train()
    m(torch.from_numpy(_images(seed=6)), need_attnmap=False)
    n_all = sum(isinstance(x, layers.ConvBnAct) for x in m.modules())
    n_early = sum(isinstance(x, layers.ConvBnAct) for name, x in
                  m.named_modules() if name.startswith(
                      ("encoder.conv1", "encoder.conv2",
                       "encoder.cspelan1")))
    want = {"all": n_all, "early": n_early, 0: 0}[fused_calls]
    assert len(calls) == want
    if fused_calls == "early":
        assert set(calls) == {torch.float32}


# -- the train steps ---------------------------------------------------------


def _steps(variables, demix, **model_kw):
    """One de-mixed step of the JAX package and of the port from the same
    variables and staged batch (the injected draw off the pixel grid)."""
    jm = _jax_model(**model_kw)
    tx_state, _ = jax_state.create_train_state(
        jm, jax.random.PRNGKey(0), (1, S, S, 3), lr=1e-3)
    tx_state = tx_state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    tx_state = tx_state.replace(opt_state=tx_state.tx.init(
        variables["params"]))
    pm = _port_model(variables, **model_kw)
    ps = port_state.create_train_state(pm, lr=1e-3, device="cpu")
    kw = dict(image_size=(S, S), heatmap_size=(S // 4, S // 4),
              grad_demix=demix, debug_return_grads=True)
    batch = _staged_batch()
    tx_state, m_j = jax_steps.make_train_step(
        JaxAugmentConfig(), donate=False, **kw)(
            tx_state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(7))
    ps, m_p = port_steps.make_train_step(AugmentConfig(), **kw)(
        ps, batch, torch.Generator().manual_seed(7))
    return tx_state, m_j, ps, m_p


def _grad_errors(m_p, m_j):
    want = from_flax({"params": jax.tree_util.tree_map(
        np.asarray, m_j["_grads"])})
    got = m_p["_grads"]
    assert got.keys() == want.keys()
    rel = {}
    num = den = 0.0
    for k, w in want.items():
        g = _np(got[k])
        assert np.isfinite(g).all(), k
        w = w.numpy()
        num += float(np.sum((g - w) ** 2))
        den += float(np.sum(w ** 2))
        rel[k] = (g, w)
    return rel, (num / den) ** 0.5


@pytest.mark.parametrize("name,model_kw,f32_prefixes", [
    ("mixed", dict(dtype="bfloat16", decoder="float32"), ()),
    ("early_dtype", dict(dtype="bfloat16", early="float32"), ()),
    ("early_dtype_f32_body", dict(dtype="float32", early="float32"),
     ("",)),
])
def test_precision_train_step_matches_jax(variables, monkeypatch, name,
                                          model_kw, f32_prefixes):
    """One de-mixed train step under each knob: grad_demix resolves as in
    JAX, the losses agree, the gradients agree to bf16's rounding (the
    relative norm of the difference below 0.1, as the bf16 default step)
    and to 1e-4 where the whole step is f32."""
    _inject(monkeypatch, PARAMS)
    mcfg = dict(compute_dtype=model_kw["dtype"],
                decoder_dtype=model_kw.get("decoder"),
                early_dtype=model_kw.get("early"))
    demix = jax_steps.resolve_grad_demix(jax_config.TrainConfig(),
                                         jax_config.ModelConfig(**mcfg))
    assert demix == port_steps.resolve_grad_demix(TrainConfig(),
                                                  ModelConfig(**mcfg))
    tx_state, m_j, ps, m_p = _steps(variables, demix, **model_kw)
    rel, norm_err = _grad_errors(m_p, m_j)
    assert norm_err <= (1e-4 if f32_prefixes else 0.1), norm_err
    for k, (g, w) in rel.items():
        if any(k.startswith(p) for p in f32_prefixes):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=k)
    tol = 1e-5 if f32_prefixes else 2e-2
    for k in ("total_loss", "class_loss", "joints_loss"):
        np.testing.assert_allclose(_np(m_p[k]), _np(m_j[k]), rtol=tol,
                                   err_msg=k)


def test_grad_demix_resolves_as_jax_for_every_combination():
    for mode in ("auto", "on", "off", "batched"):
        for dt in ("float32", "bfloat16"):
            for dec in (None, "float32", "bfloat16"):
                for early in (None, "float32", "bfloat16"):
                    kw = dict(compute_dtype=dt, decoder_dtype=dec,
                              early_dtype=early)
                    want = jax_steps.resolve_grad_demix(
                        jax_config.TrainConfig(grad_demix=mode),
                        jax_config.ModelConfig(**kw))
                    got = port_steps.resolve_grad_demix(
                        TrainConfig(grad_demix=mode), ModelConfig(**kw))
                    assert got == want, (mode, kw)


# -- remat --------------------------------------------------------------------


def _demixed_grads(model, x, fused):
    """Outputs, both pullbacks' summed gradients and the running stats of
    one train-mode forward, the de-mixed step's two backwards."""
    layers._FUSED_BN = fused
    try:
        cls, hmap, _ = model.train()(x, need_attnmap=False)
        params = [p for _, p in model.named_parameters()]
        g1 = torch.autograd.grad(torch.logsumexp(cls, -1).mean(), params,
                                 retain_graph=True, allow_unused=True,
                                 materialize_grads=True)
        g2 = torch.autograd.grad(hmap.square().mean(), params,
                                 allow_unused=True, materialize_grads=True)
    finally:
        layers._FUSED_BN = None
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return (cls.detach(), hmap.detach(),
            [a + 1e-3 * b for a, b in zip(g2, g1)], stats)


@pytest.mark.parametrize("fused", [False, True])
def test_remat_equals_no_remat_and_updates_the_stats_once(fused):
    """remat recomputes the backbone body and the pose head in each of the
    two pullbacks: outputs, gradients and running statistics equal the
    plain model's bit for bit, with the fused BN route off and on."""
    x = torch.from_numpy(_images(seed=8))
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    plain = MultiTaskNet(image_size=(S, S), depth=1, generator=gen())
    remat = MultiTaskNet(image_size=(S, S), depth=1, remat=True,
                         generator=gen())
    assert remat.state_dict().keys() == plain.state_dict().keys()
    want = _demixed_grads(plain, x, fused)
    got = _demixed_grads(remat, x, fused)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    assert layers._STATS_FROZEN == 0


def test_remat_recomputation_would_move_the_stats_without_the_freeze(
        monkeypatch):
    """The check above has teeth: with the freeze disabled, the
    recomputations of the two pullbacks update the statistics again."""
    monkeypatch.setattr(layers, "stats_frozen",
                        lambda: __import__("contextlib").nullcontext())
    x = torch.from_numpy(_images(seed=8))
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    want = _demixed_grads(MultiTaskNet(image_size=(S, S), depth=1,
                                       generator=gen()), x, False)[3]
    got = _demixed_grads(MultiTaskNet(image_size=(S, S), depth=1,
                                      remat=True, generator=gen()),
                         x, False)[3]
    assert not torch.equal(got["encoder.conv1.bn.mean"],
                           want["encoder.conv1.bn.mean"])


def test_remat_is_a_plain_call_without_autograd():
    m = MultiTaskNet(image_size=(S, S), depth=1, remat=True).eval()
    with torch.no_grad():
        c, h, _ = m(torch.from_numpy(_images(seed=9)), need_attnmap=False)
    assert c.shape == (2, 19) and h.shape == (2, S // 4, S // 4, 21)


# -- stride-2 lowerings ------------------------------------------------------


@pytest.mark.parametrize("impl", ["s2d", "dense_grad"])
def test_stride2_lowering_equals_plain(impl):
    """The model with the four stride-2 convs lowered: the same parameter
    tree, forward and de-mixed gradients within 1e-5 of 'plain' (f32)."""
    x = torch.from_numpy(_images(seed=10))
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    plain = MultiTaskNet(image_size=(S, S), depth=1, generator=gen())
    low = MultiTaskNet(image_size=(S, S), depth=1, stride2_impl=impl,
                       generator=gen())
    assert low.state_dict().keys() == plain.state_dict().keys()
    cls = {"s2d": layers.S2DConv3x3s2,
           "dense_grad": layers.DenseGradConv3x3s2}[impl]
    lowered = [n for n, m in low.named_modules() if isinstance(m, cls)]
    assert lowered == ["encoder.conv1.conv", "encoder.conv2.conv",
                       "encoder.down1.conv", "encoder.down2.conv"]
    want = _demixed_grads(plain, x, False)
    got = _demixed_grads(low, x, False)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    for (name, _), g, w in zip(plain.named_parameters(), got[2], want[2]):
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


@pytest.mark.parametrize("impl", ["s2d", "dense_grad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stride2_conv_matches_jax(impl, dtype):
    """One 3x3/stride-2 conv against JAX's _S2DConv3x3s2 and
    conv3x3s2_dense_grad: the output, the input gradient and the kernel
    gradient for a seeded cotangent (f32 1e-5, bf16 2e-2)."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 12, 10, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    ct = rng.randn(2, 6, 5, 16).astype(np.float32)
    jdt = JDT[dtype]
    if impl == "s2d":
        jmod = jax_layers._S2DConv3x3s2(16, dtype=jdt, precision=HI)

        def jf(xx, kk):
            return jmod.apply({"params": {"kernel": kk}}, xx)
    else:
        def jf(xx, kk):
            return jax_layers.conv3x3s2_dense_grad(
                xx.astype(jdt), kk.astype(jdt), HI)
    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(k))
    jdx, jdk = vjp(jnp.asarray(ct).astype(jy.dtype))
    cls = {"s2d": layers.S2DConv3x3s2,
           "dense_grad": layers.DenseGradConv3x3s2}[impl]
    conv = cls(8, 16, 3, 2, 1, dtype=TDT[dtype])
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    tx = torch.from_numpy(x).requires_grad_()
    ty = conv(tx)
    tdx, tdw = torch.autograd.grad(ty, (tx, conv.weight),
                                   torch.from_numpy(ct).to(ty.dtype))
    tol = F32 if dtype == "float32" else dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    np.testing.assert_allclose(_np(tdx), _np(jdx), **tol)
    np.testing.assert_allclose(_np(tdw).transpose(2, 3, 1, 0), _np(jdk),
                               **(tol if dtype == "float32"
                                  else dict(atol=2e-1, rtol=2e-2)))


def test_only_eligible_convs_are_lowered():
    """A 1x1 or stride-1 conv keeps the plain lowering under any
    stride2_impl (layers.py:308-309)."""
    for impl in ("s2d", "dense_grad"):
        assert type(layers.ConvBnAct(4, 8, 1, 2, stride2_impl=impl).conv) \
            is layers.Conv
        assert type(layers.ConvBnAct(4, 8, 3, 1, stride2_impl=impl).conv) \
            is layers.Conv
    with pytest.raises(ValueError, match="stride2_impl"):
        layers.ConvBnAct(4, 8, 3, 2, stride2_impl="winograd")


# -- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("argv,want", [
    ([], ("bfloat16", None, None, False)),
    (["--dtype", "mixed"], ("bfloat16", "float32", None, False)),
    (["--dtype", "mixed", "--decoder_dtype", "bfloat16"],
     ("bfloat16", "bfloat16", None, False)),
    (["--early_dtype", "float32", "--early_units", "2", "--remat"],
     ("bfloat16", None, "float32", True)),
    (["--dtype", "float32", "--decoder_dtype", "bfloat16"],
     ("float32", "bfloat16", None, False)),
])
def test_cli_builds_the_jax_model_config(argv, want):
    """The ModelConfig of the flags is the JAX CLI's
    (cli/train.py:179-191), and the model built from it carries it."""
    args = cli.parse_args(["--data_config", "x", "--image_size", "48"]
                          + argv)
    cfg = cli.model_config(args, DataConfig(names=dict(DEFAULT_NAMES)))
    assert (cfg.compute_dtype, cfg.decoder_dtype, cfg.early_dtype,
            cfg.remat) == want
    assert cfg.early_units == (2 if "--early_units" in argv else 3)
    m = MultiTaskNet.from_config(cfg)
    assert m.dtype == TDT[want[0]]
    assert m.decoder.dtype == TDT[want[1] or want[0]]
    assert m.encoder.conv1.dtype == TDT[want[2] or want[0]]
    assert m.encoder.remat == want[3] == m.decoder.remat_pose_head
