"""int8 PTQ of the port (hgr_tpu_torch/infer/quant.py, the int8 branch of
models/layers.py:ConvBnAct, ops/int8_conv.py) held against the JAX
package (hgr_tpu/infer/quant.py, hgr_tpu/models/layers.py:354-389) on the
same seeded numpy inputs and weights.

Tolerances: int32 accumulators, int8 codes and quant trees exact; float32
outputs of one ConvBnAct 1e-5; the whole int8 MultiTaskNet's logits 1e-4
of their largest magnitude with the same argmax. (An f32 rounding
difference upstream of a quantizer could move an int8 code by one at a
.5 boundary; the per-layer test, on identical inputs, is exact and is
the binding one.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.infer.quant import calibrate_act_scales as jax_calibrate
from hgr_tpu.infer.quant import quantize_variables as jax_quantize_variables
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.models.gelan import GELANBlock as JaxGELANBlock
from hgr_tpu.models.layers import ConvBnAct as JaxConvBnAct
from hgr_tpu_torch.cli import serve as cli_serve
from hgr_tpu_torch.config import DEFAULT_NAMES
from hgr_tpu_torch.infer import quant as Q
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.models.gelan import GELANBlock
from hgr_tpu_torch.models.layers import ConvBnAct
from hgr_tpu_torch.ops import int8_conv
from hgr_tpu_torch.ops.int8_conv import conv_int8, conv_int8_reference
from hgr_tpu_torch.utils.convert import (
    from_flax,
    load_weights_npz,
    save_weights_npz,
    to_flax,
)

HIGHEST = jax.lax.Precision.HIGHEST


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_bn(variables, seed):
    """Non-trivial BN parameters and statistics, so that the fold moves
    every weight."""
    v = _tree_np(variables)
    rng = np.random.RandomState(seed)

    def walk(p, s):
        for key, node in p.items():
            if key == "bn":
                c = node["scale"].shape
                node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
                s[key]["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(node, dict):
                walk(node, s.get(key, {}))

    walk(v["params"], v["batch_stats"])
    return v


def _has_quant(model):
    return any(isinstance(m, ConvBnAct) and m.quant is not None
               for m in model.modules())


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype and g.shape == w.shape, (path, key)
            assert np.array_equal(g, w), f"{path}/{key} differs"


# -- the int8 conv -----------------------------------------------------------


def _card_rules_int_mm(a, b):
    """torch._int_mm with the card's shape rules, which the CPU does not
    enforce (more than 16 rows, depth and width multiples of 8)."""
    assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0, (
        tuple(a.shape), tuple(b.shape))
    return _INT_MM(a, b)


_INT_MM = torch._int_mm


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", [
    (1, 3, 3, 3, 64, 3, 2),     # the stem's depth 27; 4 rows
    (2, 7, 5, 3, 16, 3, 1),     # depth 27, odd sizes
    (1, 4, 4, 64, 8, 1, 1),     # 16 rows
    (2, 9, 9, 64, 16, 3, 2),
    (1, 12, 12, 128, 256, 1, 2),
])
def test_conv_int8_equals_plain_version_within_card_rules(
        monkeypatch, b, h, w, cin, cout, k, s):
    monkeypatch.setattr(torch, "_int_mm", _card_rules_int_mm)
    rng = np.random.RandomState(b * 100 + cin + k + s)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, cin), np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, cin, cout), np.int8))
    got = conv_int8(xq, wq, s, k // 2)
    want = conv_int8_reference(xq, wq, s, k // 2)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    # the plain version is the exact integer sum
    xd, wd = xq.double().permute(0, 3, 1, 2), wq.double().permute(3, 2, 0, 1)
    exact = torch.nn.functional.conv2d(xd, wd, stride=s, padding=k // 2)
    assert torch.equal(want, exact.permute(0, 2, 3, 1).to(torch.int32))


def test_conv_int8_raises_outside_what_the_card_takes():
    xq = torch.zeros(1, 8, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_int8(xq, torch.zeros(1, 1, 16, 12, dtype=torch.int8), 1, 0)
    with pytest.raises(TypeError, match="int8"):
        conv_int8(xq.float(), torch.zeros(1, 1, 16, 8, dtype=torch.int8),
                  1, 0)
    with pytest.raises(ValueError, match="channels"):
        conv_int8(xq, torch.zeros(3, 3, 8, 8, dtype=torch.int8), 1, 1)
    a, bt = int8_conv.int_mm_operands(torch.zeros(5, 27, dtype=torch.int8),
                                      torch.zeros(27, 64, dtype=torch.int8))
    assert tuple(a.shape) == (17, 32) and tuple(bt.shape) == (32, 64)


# -- one ConvBnAct against the JAX package -----------------------------------


@pytest.mark.parametrize("cin", [3, 64])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_quantized_convbnact_matches_jax(k, stride, cin):
    """Same input, same quant leaves (the JAX tree through the converter):
    the int8 codes and the int32 accumulators equal JAX's exactly, the
    f32 output within 1e-5."""
    rng = np.random.RandomState(k * 10 + stride + cin)
    x = (rng.randn(2, 10, 10, cin) * 1.5).astype(np.float32)
    jm = JaxConvBnAct(16, k, stride, dtype=jnp.float32, precision=HIGHEST)
    variables = _random_bn(jm.init(jax.random.PRNGKey(k + cin), x), cin)
    stats = jax_calibrate(jm, variables, [x])
    qvars = jax_quantize_variables(variables, stats)
    want = np.asarray(jm.apply(qvars, jnp.asarray(x)))

    mod = ConvBnAct(cin, 16, k, stride)
    mod.add_quant()
    mod.load_state_dict(from_flax(qvars), strict=True)
    mod.eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    # the steps of layers.py:372-378 on both sides
    q = qvars["quant"]
    xq_j = jnp.clip(jnp.round(jnp.asarray(x) / q["act_scale"]), -127, 127
                    ).astype(jnp.int8)
    acc_j = jax.lax.conv_general_dilated(
        xq_j, jnp.asarray(q["kernel_q"]), (stride, stride),
        ((k // 2, k // 2),) * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    xq_t = torch.clamp(torch.round(torch.from_numpy(x) / mod.quant.act_scale),
                       -127, 127).to(torch.int8)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    acc_t = conv_int8(xq_t, mod.quant.kernel_q, stride, k // 2)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))


def test_train_mode_takes_the_float_route():
    gen = torch.Generator().manual_seed(0)
    mod = ConvBnAct(8, 16, 3, 1)
    torch.nn.init.normal_(mod.conv.weight, generator=gen)
    x = torch.randn(1, 6, 6, 8, generator=gen)
    Q.quantize_model(mod, [x])
    mod.train()
    ref = ConvBnAct(8, 16, 3, 1)
    ref.load_state_dict({k: v for k, v in mod.state_dict().items()
                         if "quant" not in k})
    ref.train()
    assert torch.equal(mod(x), ref(x))


# -- calibration and the quant tree, on a narrow GELAN block ------------------


@pytest.fixture(scope="module")
def narrow_block():
    """A GELAN block at narrow widths (16 in, 32 out, hidden 32 / 16) with
    random BN, both packages, and JAX's calibration of two batches."""
    rng = np.random.RandomState(0)
    batches = [(rng.randn(2, 8, 8, 16) * s).astype(np.float32)
               for s in (1.0, 2.5)]
    jm = JaxGELANBlock(32, 32, 16, dtype=jnp.float32, precision=HIGHEST)
    variables = _random_bn(jm.init(jax.random.PRNGKey(1), batches[0]), 2)
    stats = _tree_np(jax_calibrate(jm, variables, batches))
    model = GELANBlock(16, 32, 32, 16)
    model.load_state_dict(from_flax(variables), strict=True)
    return jm, variables, stats, model, batches


def test_calibration_matches_jax(narrow_block):
    _, _, want, model, batches = narrow_block
    got = Q.calibrate_act_scales(model, batches)
    assert model.training  # the mode is restored
    assert not any(m._forward_pre_hooks for m in model.modules())

    def walk(g, w, path=""):
        assert set(g) == set(w), path
        for key in w:
            if isinstance(w[key], dict):
                walk(g[key], w[key], f"{path}/{key}")
            else:
                assert np.asarray(g[key]).dtype == np.float32
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=f"{path}/{key}")

    walk(got, want)
    # the block's input: the largest |x| of both batches, exactly
    assert got["cv1"]["in_absmax"] == np.abs(batches[1]).max()


def test_quant_tree_equals_jax_bit_for_bit(narrow_block):
    jm, variables, stats, model, batches = narrow_block
    want = _tree_np(jax_quantize_variables(variables, stats)["quant"])
    got = Q.quantize_variables(to_flax(model.state_dict()), stats)["quant"]
    _assert_trees_equal(got, want)
    # attached to the port's block: the state dict carries the same tree,
    # and the int8 forward matches JAX's
    Q.attach_quant(model, got)
    assert _has_quant(model)
    _assert_trees_equal(to_flax(model.state_dict())["quant"], want)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(batches[0])).numpy()
    qvars = jax_quantize_variables(variables, stats)
    ref = np.asarray(jm.apply(qvars, jnp.asarray(batches[0])))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    model.train()


def test_quantize_raises_on_empty_calibration_and_unmatched_stats():
    with pytest.raises(ValueError, match="at least one batch"):
        Q.calibrate_act_scales(ConvBnAct(3, 8, 3, 1), [])
    with pytest.raises(ValueError, match="matched"):
        Q.quantize_variables({"params": {}, "batch_stats": {}}, {})
    with pytest.raises(ValueError):  # the JAX package refuses it too
        jax_quantize_variables({"params": {}, "batch_stats": {}}, {})


def test_converter_carries_the_quant_collection(narrow_block, tmp_path):
    _, variables, stats, _, _ = narrow_block
    qvars = _tree_np(jax_quantize_variables(variables, stats))
    state = from_flax(qvars)
    kq = [k for k in state if k.endswith(".quant.kernel_q")]
    assert len(kq) == 6 and all(state[k].dtype == torch.int8 for k in kq)
    assert state["cv1.quant.act_scale"].shape == ()
    assert state["cv1.quant.out_scale"].dtype == torch.float32
    back = to_flax(state)
    _assert_trees_equal(back["quant"], qvars["quant"])
    _assert_trees_equal(back["params"], qvars["params"])
    # the float leaves as they were without a quant collection
    plain = from_flax({k: v for k, v in qvars.items() if k != "quant"})
    assert all(torch.equal(plain[k], state[k]) for k in plain)
    # through the .npz bundle both packages read
    path = str(tmp_path / "q.npz")
    save_weights_npz(back, path)
    _assert_trees_equal(load_weights_npz(path)["quant"], qvars["quant"])


# -- the whole model ---------------------------------------------------------


def test_int8_multitasknet_matches_jax():
    """The published widths, f32, batch 2 at 64 px (4 x 4 tokens): one set
    of weights (the port's seeded init with random BN, through the
    converter), the port's calibration (held against JAX's above), the
    JAX package's quant tree; the port's int8 logits equal JAX's."""
    x = (np.random.RandomState(3).randn(2, 64, 64, 3) * 0.5).astype(
        np.float32)
    model = MultiTaskNet(image_size=(64, 64),
                         generator=torch.Generator().manual_seed(3))
    variables = _random_bn(to_flax(model.state_dict()), 3)
    model.load_state_dict(from_flax(variables), strict=True)
    stats = Q.calibrate_act_scales(model, [x], need_attnmap=False)
    qvars = _tree_np(jax_quantize_variables(variables, stats))
    jm = JaxMultiTaskNet(image_size=(64, 64), dtype=jnp.float32,
                         precision=HIGHEST)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, train=False, need_attnmap=False)[0])(qvars, jnp.asarray(x)))

    Q.add_quant_slots(model, from_flax(qvars))
    model.load_state_dict(from_flax(qvars), strict=True)
    model.eval()
    assert sum(m.quant is not None for m in model.modules()
               if isinstance(m, ConvBnAct)) == 22
    with torch.no_grad():
        got, _, _ = model(torch.from_numpy(x), need_attnmap=False)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# -- --quantize through the serving CLI ---------------------------------------


def test_serve_quantize_serves_int8_on_classify_and_detect(tmp_path, capsys):
    crops = np.random.RandomState(5).randint(0, 256, (70, 48, 48, 3),
                                             np.uint8)
    path = str(tmp_path / "calib.npz")
    np.savez(path, crops=crops)
    args = cli_serve.build_parser().parse_args(
        ["--device", "cpu", "--image_size", "48", "48", "--dtype", "float32",
         "--max_batch", "2", "--quantize", path, "--det_weight", "",
         "--frame_hw", "64", "96", "--det_max_batch", "1"])
    svc = cli_serve.build_service(args)
    det = None
    try:
        assert "quantized backbone from 70 calibration crops" in \
            capsys.readouterr().out
        assert _has_quant(svc.model)
        det = cli_serve.build_detector_service(args, svc)
        cls = det.pipeline.classifier
        assert _has_quant(cls) and not cls.training
        served = {k: v for k, v in svc.model.state_dict().items()
                  if ".quant." in k}
        assert len(served) == 4 * 22
        for k, v in served.items():
            assert torch.equal(cls.state_dict()[k], v), k
        out = svc.classify(crops[0], timeout=60.0)
        assert out["label_name"] in DEFAULT_NAMES
        # the pipeline's classifier forward is the int8 service's
        x = torch.from_numpy(np.random.RandomState(7).randn(
            2, 48, 48, 3).astype(np.float32))
        with torch.no_grad():
            assert torch.equal(cls(x, need_attnmap=False)[0],
                               svc.model(x, need_attnmap=False)[0])
    finally:
        svc.stop()
        if det is not None:
            det.stop()


def test_quantize_from_crops_matches_jax_calibration_input(tmp_path,
                                                          monkeypatch):
    """The serving CLI's calibration batches (``--quantize``) are the JAX
    CLI's: /255, −mean, /std in numpy float32, 64 a batch
    (cli/serve.py:107-121)."""
    from hgr_tpu.config import IMAGENET_MEAN, IMAGENET_STD

    crops = np.random.RandomState(6).randint(0, 256, (65, 16, 16, 3),
                                             np.uint8)
    path = str(tmp_path / "calib.npy")
    np.save(path, crops)
    seen = []
    monkeypatch.setattr(Q, "quantize_model",
                        lambda m, batches, need_attnmap: seen.extend(batches))
    Q.quantize_from_crops(None, path)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    assert [len(b) for b in seen] == [64, 1]
    np.testing.assert_array_equal(
        seen[0], ((crops[:64].astype(np.float32) / 255.0) - mean) / std)
