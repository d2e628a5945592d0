"""The port's model (hgr_tpu_torch/models) and weight bridge
(hgr_tpu_torch/utils/convert.py) held against the JAX package.

The same Flax variables (BatchNorm statistics and affine perturbed away
from identity so the BN path is exercised) go through the JAX module and,
converted by ``from_flax``, through the port. JAX runs with
``precision=HIGHEST``: its default matmul precision is reduced even on
the CPU.

Tolerances: float32 1e-4 (measured ~2e-6; the margin covers summation
order across ~30 layers). bfloat16 is looser, because the two frameworks
round at different places: XLA on the CPU keeps fused elementwise chains
(GELU, SiLU, residual adds) in float32 and rounds once, PyTorch rounds
every op's output; one bf16 ulp of a heatmap value near 2-4 is 1.6e-2.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu import config as jax_config
from hgr_tpu.infer.export import save_weights_npz
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.models.gelan import GELANNet as JaxGELANNet
from hgr_tpu.models.layers import ConvBnAct as JaxConvBnAct
from hgr_tpu.ops.heatmap import get_max_preds as jax_get_max_preds
from hgr_tpu.ops.posemb import pos_emb_sincos_2d as jax_pos_emb
from hgr_tpu.ops.resize import (
    upsample_bilinear_align_corners as jax_upsample,
)
from hgr_tpu_torch import config as port_config
from hgr_tpu_torch.infer.weights import (
    infer_backbone_variant,
    load_classifier_weights,
)
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.models.gelan import GELANNet
from hgr_tpu_torch.models.layers import ConvBnAct
from hgr_tpu_torch.ops.heatmap import get_max_preds
from hgr_tpu_torch.ops.posemb import pos_emb_sincos_2d
from hgr_tpu_torch.ops.resize import upsample_bilinear_align_corners
from hgr_tpu_torch.utils.convert import from_flax, to_flax

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = {"logits": 2e-2, "heatmap": 6e-2, "attn": 1e-2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_bn(variables, seed):
    """Random BN running stats and affine, so eval BN is not identity."""
    rng = np.random.RandomState(seed)
    v = _np_tree(variables)

    def walk(node, in_bn):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x, in_bn or k == "bn")
            elif k == "mean":
                node[k] = (0.1 * rng.randn(*x.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif in_bn and k == "scale":
                node[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif in_bn and k == "bias":
                node[k] = (0.1 * rng.randn(*x.shape)).astype(np.float32)

    walk(v, False)
    return v


def _images(b, size, seed=0):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """jax_model(backbone, size, dtype) -> (Flax module, perturbed
    variables), each config built once for the module."""
    built = {}

    def get(backbone, size, dtype="float32"):
        key = (backbone, size, dtype)
        if key not in built:
            model = JaxMultiTaskNet(image_size=(size, size),
                                    backbone=backbone,
                                    dtype=getattr(jnp, dtype),
                                    precision=HIGHEST)
            variables = model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, size, size, 3)), train=False)
            built[key] = (model, _perturb_bn(variables, seed=size))
        return built[key]

    return get


def _port_model(variables, size, backbone, dtype="float32", **kw):
    model = MultiTaskNet(image_size=(size, size), backbone=backbone,
                         dtype=getattr(torch, dtype), **kw).eval()
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


# -- config ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig",
                                  "AugmentConfig"])
def test_config_dataclasses_match_jax(name):
    def fields(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    got, want = getattr(port_config, name), getattr(jax_config, name)
    assert [f[0] for f in fields(got)] == [f[0] for f in fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def test_config_constants_and_yaml_match_jax():
    for const in ("DEFAULT_NAMES", "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(port_config, const) == getattr(jax_config, const)
    path = str(pathlib.Path(__file__).parents[1] / "configs" / "hagrid.yaml")
    assert dataclasses.asdict(port_config.load_data_config(path)) == \
        dataclasses.asdict(jax_config.load_data_config(path))
    assert port_config.ModelConfig().heatmap_size == (48, 48)


# -- weight bridge ---------------------------------------------------------


@pytest.mark.parametrize("backbone", ["small", "large"])
def test_bridge_loads_strict_with_equal_param_count(jax_model, backbone):
    _, variables = jax_model(backbone, 48)
    model = _port_model(variables, 48, backbone)  # strict load
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    n_stats = sum(a.size for a in jax.tree_util.tree_leaves(
        variables["batch_stats"]))
    assert sum(b.numel() for b in model.buffers() if b.dim() == 1) == n_stats
    if backbone == "small":
        assert n_jax == 7_409_000


def test_bridge_round_trips_exactly(jax_model):
    _, variables = jax_model("small", 48)
    back = to_flax(from_flax(variables))
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_bridge_keeps_packed_qkv_column_order(jax_model):
    _, variables = jax_model("small", 48)
    kernel = variables["params"]["decoder"]["transformer"][
        "layers_0_attn"]["to_qkv"]["kernel"]  # (dim, 3*H*D), q|k|v
    w = from_flax(variables)["decoder.transformer.layers_0_attn.to_qkv.weight"]
    np.testing.assert_array_equal(w.numpy(), kernel.T)


@pytest.mark.parametrize("backbone", ["small", "large"])
def test_npz_from_jax_package_loads_without_jax(jax_model, tmp_path,
                                                backbone):
    _, variables = jax_model(backbone, 48)
    path = str(tmp_path / "cls.npz")
    save_weights_npz(variables, path)
    loaded = load_classifier_weights(path, (48, 48))
    want = from_flax(variables)
    assert loaded.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(loaded[k], want[k], rtol=0, atol=0)
    assert infer_backbone_variant(loaded) == backbone
    other = "large" if backbone == "small" else "small"
    with pytest.raises(ValueError, match="cspelan1"):
        load_classifier_weights(path, (48, 48), backbone=other)


def test_unported_checkpoint_formats_raise(tmp_path):
    """Every format the JAX loader reads is ported: reference .ckpt files
    load (tests/test_torch_yolo.py) and orbax directories too
    (tests/test_torch_orbax.py), so a missing .ckpt is a missing file, and
    a directory without orbax's _METADATA is no checkpoint."""
    with pytest.raises(FileNotFoundError):
        load_classifier_weights(str(tmp_path / "ref.ckpt"))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        load_classifier_weights(str(tmp_path))


def test_empty_path_is_a_seeded_random_init():
    a = load_classifier_weights("", (48, 48), seed=1)
    b = load_classifier_weights("", (48, 48), seed=1)
    c = load_classifier_weights("", (48, 48), seed=2)
    key = "decoder.transformer.layers_0_attn.to_qkv.weight"
    torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a[key], c[key])
    assert infer_backbone_variant(a) == "small"
    # torch Conv2d/Linear default init: U(+-1/sqrt(fan_in))
    assert a[key].abs().max() <= 1 / 256**0.5


# -- per-module parity -----------------------------------------------------


@pytest.mark.parametrize("kernel,stride,act", [(3, 2, True), (1, 1, False)])
def test_conv_bn_act_matches(kernel, stride, act):
    jm = JaxConvBnAct(16, kernel, stride, use_act=act, precision=HIGHEST)
    x = _images(2, 12, seed=1)
    variables = _perturb_bn(jm.init(jax.random.PRNGKey(1), x), seed=1)
    want = jm.apply(variables, x)
    tm = ConvBnAct(3, 16, kernel, stride, use_act=act).eval()
    tm.load_state_dict(from_flax(variables), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backbone", ["small", "large"])
def test_gelan_matches(jax_model, backbone):
    _, variables = jax_model(backbone, 48)
    enc = {c: variables[c]["encoder"] for c in ("params", "batch_stats")}
    x = _images(2, 48, seed=2)
    want = JaxGELANNet(backbone, precision=HIGHEST).apply(enc, x)
    tm = GELANNet(backbone).eval()
    tm.load_state_dict(from_flax(enc), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 3, 3, 512)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_posemb_equals_jax():
    np.testing.assert_array_equal(pos_emb_sincos_2d(12, 12, 256),
                                  jax_pos_emb(12, 12, 256))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_matches(dtype):
    x = np.random.RandomState(3).randn(2, 3, 5, 4).astype(np.float32)
    want = jax_upsample(jnp.asarray(x, getattr(jnp, dtype)), 4,
                        compute_dtype=getattr(jnp, dtype))
    got = upsample_bilinear_align_corners(
        torch.from_numpy(x).to(getattr(torch, dtype)), 4,
        compute_dtype=getattr(torch, dtype))
    assert got.shape == (2, 12, 20, 4) and got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_get_max_preds_matches():
    rng = np.random.RandomState(4)
    hm = rng.randn(3, 21, 12, 12).astype(np.float32)
    hm[0, 0] = -1.0  # all-negative map: zeroed prediction
    hm[1, 1] = 0.0
    hm[1, 1, 5, 7] = hm[1, 1, 9, 2] = 2.0  # tie: first flat index wins
    want_p, want_v = jax_get_max_preds(hm)
    got_p, got_v = get_max_preds(torch.from_numpy(hm))
    np.testing.assert_array_equal(_np(got_p), _np(want_p))
    np.testing.assert_array_equal(_np(got_v), _np(want_v))
    assert got_p[1, 1].tolist() == [7.0, 5.0]


# -- whole model -----------------------------------------------------------


def _compare_model(jax_model, backbone, size, b, dtype, need_attnmap):
    jm, variables = jax_model(backbone, size, dtype)
    x = _images(b, size, seed=size + b)
    jl, jh, ja = jm.apply(variables, x, train=False,
                          need_attnmap=need_attnmap)
    tm = _port_model(variables, size, backbone, dtype)
    with torch.inference_mode():
        tl, th, ta = tm(torch.from_numpy(x), need_attnmap=need_attnmap)
    n_tok = (size // 16) ** 2 + 1
    assert tl.shape == (b, 19) and tl.dtype == torch.float32
    assert th.shape == (b, size // 4, size // 4, 21)
    assert th.dtype == torch.float32
    if dtype == "float32":
        tols = {"logits": F32_TOL, "heatmap": F32_TOL, "attn": F32_TOL}
    else:
        tols = {k: dict(atol=v) for k, v in BF16_TOL.items()}
    np.testing.assert_allclose(_np(tl), _np(jl), **tols["logits"])
    np.testing.assert_allclose(_np(th), _np(jh), **tols["heatmap"])
    if need_attnmap:
        assert ta.shape == (b, 8, n_tok, n_tok)
        np.testing.assert_allclose(_np(ta), _np(ja), **tols["attn"])
    else:
        assert ta is None and ja is None


@pytest.mark.parametrize("need_attnmap", [True, False])
@pytest.mark.parametrize("backbone", ["small", "large"])
def test_multitasknet_f32_48px(jax_model, backbone, need_attnmap):
    _compare_model(jax_model, backbone, 48, 2, "float32", need_attnmap)


@pytest.mark.parametrize("backbone", ["small", "large"])
def test_multitasknet_f32_192px_real_posemb_grid(jax_model, backbone):
    """N = 12*12 + 1 = 145 tokens, the serving sequence length."""
    _compare_model(jax_model, backbone, 192, 1, "float32", True)


@pytest.mark.parametrize("need_attnmap", [True, False])
def test_multitasknet_bf16_48px(jax_model, need_attnmap):
    _compare_model(jax_model, "small", 48, 2, "bfloat16", need_attnmap)


def test_unfused_attention_route_matches_fused(jax_model):
    _, variables = jax_model("small", 48)
    x = torch.from_numpy(_images(2, 48, seed=9))
    fused = _port_model(variables, 48, "small")
    plain = _port_model(variables, 48, "small", fused_attention=False)
    with torch.inference_mode():
        a = fused(x, need_attnmap=False)
        b = plain(x, need_attnmap=False)
    for u, v in zip(a[:2], b[:2]):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_split_attention_route_equals_packed_exactly(jax_model, dtype,
                                                     train):
    """On one rank 'split' is the packed route bit for bit (the one-card
    {data: 1, model: 1} run of hgr_tpu/tools/sharded_onechip.py:67-72),
    outputs and, in train mode, gradients."""
    _, variables = jax_model("small", 48)
    x = torch.from_numpy(_images(2, 48, seed=10))
    models = [_port_model(variables, 48, "small", dtype, fused_attention=f)
              for f in (True, "split")]
    outs, grads = [], []
    for m in models:
        m.train(train)
        lo, hm, _ = m(x, need_attnmap=False)
        outs.append((lo, hm))
        if train:
            params = [p for _, p in m.named_parameters()]
            grads.append(torch.autograd.grad((lo.sum() + hm.sum()), params))
    for u, v in zip(*outs):
        assert torch.equal(u, v)
    for u, v in zip(*grads):
        assert torch.equal(u, v)


@pytest.mark.parametrize("train", [False, True])
def test_split_attention_model_matches_jax_split_model(train):
    """MultiTaskNet(fused_attention='split') against the JAX model built
    the same way, f32 at Precision.HIGHEST, eval and train mode (batch
    statistics and their update)."""
    jm = JaxMultiTaskNet(image_size=(48, 48), precision=HIGHEST,
                         fused_attention="split")
    variables = _perturb_bn(jm.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 48, 48, 3)), train=False),
                            seed=3)
    x = _images(2, 48, seed=11)
    tm = _port_model(variables, 48, "small", fused_attention="split")
    tm.train(train)
    with torch.no_grad():
        tl, th, _ = tm(torch.from_numpy(x), need_attnmap=False)
    if train:
        (jl, jh, _), mutated = jm.apply(variables, x, train=True,
                                        need_attnmap=False,
                                        mutable=["batch_stats"])
        want = from_flax({"params": {}, **mutated})
        for k, w in want.items():
            np.testing.assert_allclose(_np(tm.state_dict()[k]), w.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    else:
        jl, jh, _ = jm.apply(variables, x, train=False, need_attnmap=False)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32_TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **F32_TOL)


@pytest.mark.parametrize("field,value,item", [
    ("stride2_impl", "s2d", "A13"),
    ("remat", True, "A13"),
    ("early_dtype", torch.float32, "A13"),
    ("decoder_dtype", torch.float32, "A13"),
])
def test_unported_fields_raise(field, value, item):
    """The fields ROADMAP ``item`` (A13) left unported raised here; they
    are ported now: each builds, keeps the parameter tree and runs a
    train-mode forward and backward (held against JAX in
    tests/test_torch_precision.py)."""
    m = MultiTaskNet(image_size=(48, 48), dtype=torch.bfloat16,
                     **{field: value})
    assert m.state_dict().keys() == MultiTaskNet(
        image_size=(48, 48)).state_dict().keys()
    cls, hmap, _ = m.train()(torch.from_numpy(_images(2, 48)),
                             need_attnmap=False)
    (cls.float().sum() + hmap.sum()).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in m.parameters())


def test_build_classifier_on_the_cpu_when_asked_else_the_card(monkeypatch):
    """``build_classifier`` puts the served model on the CPU only when the
    caller asks; by default it is the card's, and without a card that
    raises rather than landing on the CPU."""
    from hgr_tpu_torch.infer.weights import build_classifier

    state = load_classifier_weights("", (48, 48))
    m = build_classifier(state, (48, 48), device="cpu")
    assert not m.training
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_classifier(state, (48, 48))
