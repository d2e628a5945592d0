"""Export of the port (hgr_tpu_torch/infer/export.py, infer/onnx_export.py,
cli/export.py, the registered attention operators of ops/attention.py)
held against the JAX package's export surface (hgr_tpu/infer/export.py,
hgr_tpu/infer/onnx_export.py) on the CPU.

Tolerances: a reloaded program equals the eager forward bit for bit (the
same operators on the same inputs); the ONNX module against the JAX
package's torch mirror of the same weights 1e-5; initializers exact.
"""

import os

import numpy as np
import pytest
import torch

from hgr_tpu.infer.onnx_export import TorchMirror
from hgr_tpu_torch.cli import export as cli_export
from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig
from hgr_tpu_torch.infer import quant as Q
from hgr_tpu_torch.infer.export import (
    eval_exported,
    export_program,
    load_program,
    make_inference_fn,
    program_ops,
    split_loader,
)
from hgr_tpu_torch.infer.onnx_export import export_onnx
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.ops import attention as A
from hgr_tpu_torch.utils.convert import save_weights_npz, to_flax
from hgr_tpu_torch.utils.onnx_reader import load_onnx_graph

PX = 64  # 4 x 4 tokens: the published widths at a small crop
ATTN = "hgr_tpu_torch.attention_qkv_fwd.default"


def _model(seed=0, px=PX):
    return MultiTaskNet(image_size=(px, px),
                        generator=torch.Generator().manual_seed(seed)).eval()


def _x(b, seed, px=PX):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        b, px, px, 3).astype(np.float32))


# -- the registered operators ------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_attention_ops_pass_opcheck(dtype):
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 6, 24)).to(dtype)
    g = torch.from_numpy(rng.randn(2, 6, 8)).to(dtype)
    scale = 4 ** -0.5
    torch.library.opcheck(torch.ops.hgr_tpu_torch.attention_qkv_fwd.default,
                          (qkv.clone().requires_grad_(), 2, 4, scale))
    torch.library.opcheck(torch.ops.hgr_tpu_torch.attention_qkv_bwd.default,
                          (qkv, g, 2, 4, scale))


def test_attention_op_is_the_wrapper_and_its_plain_version_on_cpu():
    qkv = torch.from_numpy(np.random.RandomState(2).randn(2, 9, 3 * 8 * 32)
                           .astype(np.float32))
    want = A.attention_qkv_reference(qkv, 8, 32, 32 ** -0.5)
    got = torch.ops.hgr_tpu_torch.attention_qkv_fwd(qkv, 8, 32, 32 ** -0.5)
    assert torch.equal(got, want)
    assert torch.equal(A.fused_attention_qkv(qkv, 8, 32, 32 ** -0.5), want)


# -- torch.export ------------------------------------------------------------


def test_exported_program_reloads_equal_to_eager_with_the_attention_op(
        tmp_path):
    model = _model()
    path = export_program(model, str(tmp_path / "m.pt2"), batch=2)
    loaded = load_program(path)
    ops = program_ops(loaded)
    assert ops.get(ATTN) == 4  # one node per transformer layer
    x = _x(2, 3)
    with torch.no_grad():
        want = make_inference_fn(model)(x)
        got = loaded(x)
    assert [tuple(t.shape) for t in got] == [(2, 19), (2, 21, PX // 4,
                                                        PX // 4)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = A.fused_attention_qkv.launches
    loaded(x)
    assert A.fused_attention_qkv.launches == before  # CPU: plain version


def test_int8_program_exports_and_reloads(tmp_path):
    """Mirror of tests/test_quant.py::test_quantized_graph_exports_stablehlo:
    the int8 model's program, reloaded, equals its eager forward."""
    model = _model(seed=4)
    Q.quantize_model(model, [_x(2, 5)], need_attnmap=False)
    path = export_program(model, str(tmp_path / "q.pt2"), batch=1)
    loaded = load_program(path)
    ops = program_ops(loaded)
    assert ops.get(ATTN) == 4 and ops.get("aten._int_mm.default") == 22
    x = _x(1, 6)
    with torch.no_grad():
        want = make_inference_fn(model)(x)
        got = loaded(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- ONNX --------------------------------------------------------------------


def test_onnx_file_has_the_reference_signature_and_the_weights(tmp_path):
    state = MultiTaskNet(generator=torch.Generator().manual_seed(7)
                         ).state_dict()
    path = str(tmp_path / "m.onnx")
    module = export_onnx(state, path)
    graph = load_onnx_graph(path)
    assert graph.inputs == {"input": (1, 3, 192, 192)}
    assert graph.outputs == {"label_pred": (1, 19),
                             "heatmap_pred": (1, 21, 48, 48)}
    ops = [n.op_type for n in graph.nodes]
    assert ops.count("Conv") == 24 and ops.count("Softmax") == 4
    # every weight is an initializer bit for bit (dense kernels transposed
    # for MatMul); each BN's scale and variance enter as the constant-
    # folded factor rsqrt(var + eps) · scale
    inits = [t.to_numpy() for t in graph.initializers.values()]

    def present(a):
        return any(b.shape == a.shape and np.array_equal(b, a)
                   for b in inits)

    for key, t in state.items():
        a = t.numpy()
        if key.endswith((".bn.weight", ".bn.var")):
            continue
        assert present(a) or (a.ndim == 2 and present(a.T)), key
    for key in state:
        if key.endswith(".bn.var"):
            pre = key[:-len("var")]
            fold = torch.rsqrt(state[pre + "var"] + 1e-5) * state[
                pre + "weight"]
            assert present(fold.numpy()), pre
    # the traced module against the JAX package's ONNX mirror
    x = torch.from_numpy(np.random.RandomState(8).rand(1, 3, 192, 192)
                         .astype(np.float32))
    mirror = TorchMirror(to_flax(state))
    with torch.no_grad():
        for g, w in zip(module(x), mirror(x)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)


# -- the export CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def export_fixture(tmp_path_factory):
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    root = tmp_path_factory.mktemp("export")
    data = str(root / "data")
    write_synthetic_split(data, "test", 4, seed=0)
    cfg = str(root / "data.yaml")
    with open(cfg, "w") as f:
        f.write(f"path: {data}\ntest: annotations/test\nnum_joints: 21\n"
                "num_classes: 19\n")
    weights = str(root / "w.npz")
    save_weights_npz(to_flax(_model(seed=9).state_dict()), weights)
    return root, cfg, weights


def test_cli_export_pt2_end_to_end_on_cpu(export_fixture):
    root, cfg, weights = export_fixture
    out = str(root / "cls.pt2")
    res = cli_export.main(["--data_config", cfg, "--weight_path", weights,
                           "--out", out, "--image_size", str(PX), str(PX),
                           "--batch", "2", "--device", "cpu"])
    assert os.path.exists(out) and os.path.exists(out + ".weights.npz")
    assert program_ops(load_program(out)).get(ATTN) == 4
    # the eval through the loaded program equals the eager model's
    from hgr_tpu_torch.config import load_data_config

    data_cfg = load_data_config(cfg)
    eager = eval_exported(make_inference_fn(_model(seed=9)),
                          split_loader(data_cfg, data_cfg.test, 2), 19,
                          (PX, PX), "cpu")
    assert res["images"] == eager["images"] == 4
    assert res["test_f1"] == eager["test_f1"]


def test_cli_export_onnx_skip_eval(export_fixture, capsys):
    root, cfg, weights = export_fixture
    out = str(root / "cls.onnx")
    assert cli_export.main(["--data_config", cfg, "--weight_path", weights,
                            "--out", out, "--image_size", str(PX), str(PX),
                            "--format", "onnx", "--skip_eval",
                            "--device", "cpu"]) is None
    assert "exported ONNX artifact" in capsys.readouterr().out
    graph = load_onnx_graph(out)
    assert graph.inputs == {"input": (1, 3, PX, PX)}


def test_cli_export_defaults_to_the_card():
    args = cli_export.build_parser().parse_args(
        ["--data_config", "x.yaml", "--weight_path", "w.npz"])
    assert (args.device, args.format, args.batch) == ("cuda", "pt2", 1)


def test_eval_exported_counts_only_valid_rows():
    """A tail batch padded by repetition counts its real rows only."""
    cfg = DataConfig(names=dict(DEFAULT_NAMES))
    rng = np.random.RandomState(0)
    batch = {"canvas": rng.randint(0, 256, (2, 80, 80, 3), np.uint8),
             "orig_to_canvas": np.tile(np.array([[1, 0, 0], [0, 1, 0]],
                                                np.float32), (2, 1, 1)),
             "sizes_hw": np.full((2, 2), 80, np.float32),
             "joints": np.zeros((2, 21, 2), np.float32),
             "joints_vis": np.zeros((2, 21), np.float32),
             "label": np.array([3, 3], np.int32),
             "valid": np.array([1, 0], np.float32)}

    def fn(images):
        logits = torch.zeros(len(images), 19)
        logits[:, 3] = 1.0
        return logits, None

    res = eval_exported(fn, [batch], cfg.num_classes, (PX, PX), "cpu")
    assert res["images"] == 1 and res["test_f1"] == pytest.approx(1 / 19)
