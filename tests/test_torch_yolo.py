"""The detector's port (hgr_tpu_torch/models/yolo.py, ops/resize.py,
utils/onnx_port.py, utils/torch_port.py, the detector half of
utils/convert.py) held against the JAX package on the CPU.

Inputs are made by numpy from a seed and fed to both; JAX models are
built at ``precision=HIGHEST`` (its default f32 matmul precision is low
even on the CPU). Tolerances are stated per test.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.models import yolo as jyolo
from hgr_tpu.ops.resize import _half_pixel_matrix
from hgr_tpu_torch.models import yolo as tyolo
from hgr_tpu_torch.utils.convert import from_flax, to_flax

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolo_smoke_weights.npz")


def _f32_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def det_vars():
    """The repository's detector weights (trained from scratch on
    synthetic scenes, stored as float16), as a float32 Flax tree."""
    return _f32_tree(jyolo.load_npz_weights(FIXTURE))


@pytest.fixture(scope="module")
def det_pair(det_vars):
    """The JAX model and the port's model (eval) holding the same
    variables, through ``from_flax``."""
    jm = jyolo.YOLOv7Tiny(num_classes=1, precision=HI)
    tm = tyolo.YOLOv7Tiny(num_classes=1)
    tm.load_state_dict(from_flax(det_vars), strict=True)
    return jm, tm.eval()


def test_raw_heads_match_jax_at_det_160(det_vars, det_pair):
    """Raw head maps of YOLOv7Tiny at 160 px, f32, same variables: 1e-4
    (f32 sums over ~58 convs taken in another order; the heads are of
    order 1-10)."""
    jm, tm = det_pair
    x = np.random.RandomState(0).rand(2, 160, 160, 3).astype(np.float32)
    want = jax.jit(lambda v, im: jm.apply(v, im, train=False))(
        det_vars, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == 3
    for s, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, s
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"scale {s}")


def test_detector_weights_round_trip_through_the_flax_tree(det_vars,
                                                           det_pair):
    """from_flax maps every leaf of the Flax tree onto the port's
    state_dict (strict load above) and to_flax gives the tree back,
    bit for bit."""
    _, tm = det_pair
    back = to_flax(tm.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(det_vars), flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_model_keeps_the_jax_dtypes(det_vars):
    """bf16 convs, f32 BN and leaky ReLU, f32 detect convs: the heads are
    f32 and agree with the f32 model to bf16's rounding."""
    tm = tyolo.YOLOv7Tiny(num_classes=1, dtype=torch.bfloat16)
    tm.load_state_dict(from_flax(det_vars), strict=True)
    tm.eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 64, 96, 3)
                         .astype(np.float32))
    with torch.no_grad():
        outs = tm(x)
    jm = jyolo.YOLOv7Tiny(num_classes=1, dtype=jnp.bfloat16)
    want = jm.apply(det_vars, jnp.asarray(x.numpy()), train=False)
    for g, w in zip(outs, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        # one bf16 rounding per layer, in different places of the sums
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0.25)


def test_training_mode_raises():
    """Training mode raised until detector training was ported (ROADMAP
    A8): the detector now runs ``.train()``, takes batch statistics and
    updates its running ones (held against JAX in
    tests/test_torch_yolo_train.py)."""
    tm = tyolo.YOLOv7Tiny().train()
    outs = tm(torch.rand(2, 32, 32, 3))
    assert [tuple(o.shape) for o in outs] == [(2, 4, 4, 18), (2, 2, 2, 18),
                                              (2, 1, 1, 18)]
    assert not torch.equal(tm.stem1.bn.var, torch.ones(32))


def _raw_outs(seed, b=2, sizes=((8, 10), (4, 5), (2, 3)), nc=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, 3 * (5 + nc)).astype(np.float32) * 2.0
            for h, w in sizes]


@pytest.mark.parametrize("nc", [1, 3])
def test_decode_and_best_box_match_jax(nc):
    """decode_predictions and best_box on seeded raw maps: values 1e-5
    (sigmoid and the pixel scale in f32), the chosen rows equal."""
    outs = _raw_outs(nc, nc=nc)
    want = np.asarray(jyolo.decode_predictions(
        [jnp.asarray(o) for o in outs], num_classes=nc))
    got = tyolo.decode_predictions([torch.from_numpy(o) for o in outs],
                                   num_classes=nc)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    jb, js = jyolo.best_box(jnp.asarray(want))
    tb, ts = tyolo.best_box(torch.from_numpy(want))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("max_det", [8, 100])
def test_nms_matches_jax(max_det):
    """nms on seeded rows with overlapping boxes of 3 classes: the kept
    slots equal, their boxes and scores 1e-5, classes equal."""
    rng = np.random.RandomState(max_det)
    n = 60
    centers = rng.rand(4, 2) * 200
    rows = np.zeros((2, n, 8), np.float32)
    rows[..., :2] = (centers[rng.randint(0, 4, (2, n))]
                     + rng.randn(2, n, 2) * 6)
    rows[..., 2:4] = 20 + rng.rand(2, n, 2) * 30
    rows[..., 4] = rng.rand(2, n)
    rows[..., 5:] = rng.rand(2, n, 3)
    jb, js, jc = (np.asarray(a) for a in jyolo.nms(
        jnp.asarray(rows), score_thresh=0.2, iou_thresh=0.45,
        max_det=max_det))
    tb, ts, tc = (a.numpy() for a in tyolo.nms(
        torch.from_numpy(rows), score_thresh=0.2, iou_thresh=0.45,
        max_det=max_det))
    kept = js > 0
    assert kept.sum() > 2 and (kept != (ts > 0)).sum() == 0
    np.testing.assert_allclose(ts[kept], js[kept], atol=1e-5)
    np.testing.assert_allclose(tb[kept], jb[kept], atol=1e-5)
    np.testing.assert_array_equal(tc[kept], jc[kept])


@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (20, 41)),
                                          ((37, 53), (80, 120)),
                                          ((360, 640), (234, 416))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    """The half-pixel resize, down and up, and at the letterbox of a
    360x640 frame to 416: within one f32 ulp. Each output is the sum of
    two products; the port rounds both and adds (the same bits on the
    card and the CPU), while XLA's CPU product fuses the second into a
    multiply-add at some shapes and not at others (measured: the 37 ->
    20 rows equal bit for bit, the 53 -> 120 columns one ulp apart where
    fused), so bit equality holds only per shape."""
    from hgr_tpu.ops.resize import resize_bilinear as jresize
    from hgr_tpu_torch.ops.resize import resize_bilinear

    x = np.random.RandomState(5).rand(2, *in_hw, 3).astype(np.float32) * 255
    want = np.asarray(jresize(jnp.asarray(x), out_hw))
    got = resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2**-23, atol=0)
    if out_hw[0] < in_hw[0] < 40:
        # the same two-product sums as the JAX package's rows at 37 -> 20
        from hgr_tpu_torch.ops.resize import _blend, _taps

        jrows = jnp.einsum("oh,...hwc->...owc", jnp.asarray(
            _half_pixel_matrix(in_hw[0], out_hw[0])), jnp.asarray(x),
            precision=HI)
        np.testing.assert_array_equal(
            _blend(torch.from_numpy(x), _taps(in_hw[0], out_hw[0], None),
                   1).numpy(), np.asarray(jrows))


@pytest.mark.parametrize("new", [160, 416])
def test_letterbox_params_match_jax(new):
    from hgr_tpu.infer.detect import letterbox_params as jlb
    from hgr_tpu_torch.infer.detect import letterbox_params

    for h, w in [(360, 640), (480, 640), (640, 480), (416, 416),
                 (180, 320), (101, 333), (333, 101)]:
        assert letterbox_params(h, w, new) == jlb(h, w, new)


# -- the ONNX porter ----------------------------------------------------------

@pytest.fixture(scope="module")
def onnx_pb2(tmp_path_factory):
    """The minimal ONNX schema of tests/onnx_mini.proto, with onnx.proto's
    tensor attribute (AttributeProto.t = 5, what a Constant node holds)
    added, compiled by protoc: an encoder independent of both packages'
    readers (tests/test_onnx_port.py:55-76)."""
    out = tmp_path_factory.mktemp("onnx_pb_torch")
    with open(os.path.join(os.path.dirname(__file__),
                           "onnx_mini.proto")) as f:
        text = f.read()
    anchor = "message AttributeProto {\n"
    assert anchor in text
    text = text.replace(anchor, anchor + "  TensorProto t = 5;\n")
    (out / "onnx_mini_t.proto").write_text(
        text.replace("package onnx_mini;", "package onnx_mini_t;"))
    subprocess.run(["protoc", f"--python_out={out}", f"--proto_path={out}",
                    "onnx_mini_t.proto"], check=True, capture_output=True)
    sys.path.insert(0, str(out))
    try:
        import onnx_mini_t_pb2

        return onnx_mini_t_pb2
    finally:
        sys.path.remove(str(out))


def _conv_shapes():
    """(O, I, k, k) of the 55 ConvActs in CONV_ORDER and the 3 detect
    convs, from the port's module."""
    from hgr_tpu_torch.utils.onnx_port import CONV_ORDER, DETECT_CONVS

    sd = tyolo.YOLOv7Tiny().state_dict()
    return ([tuple(sd[n.replace("/", ".") + ".conv.weight"].shape)
             for n in CONV_ORDER]
            + [tuple(sd[n + ".weight"].shape) for n in DETECT_CONVS])


def _write_onnx(pb2, path, seed, form="fused", weights="init",
                fp16=False, bn_via_identity=False, drop_bn_param=None):
    """A graph with the 58 Conv nodes in execution order. ``form``:
    'fused' (conv with bias) or 'bn' (conv without bias, then an explicit
    BatchNormalization, epsilon 1e-5); ``weights``: 'init' (graph
    initializers) or 'constant' (Constant nodes behind Identity
    nodes); ``fp16``: FLOAT16 storage; ``bn_via_identity``: the BN reads
    the conv's output through an Identity; ``drop_bn_param``: the conv
    index whose BN names a mean that resolves to nothing."""
    rng = np.random.RandomState(seed)
    model = pb2.ModelProto(ir_version=8, producer_name="pytorch")
    model.opset_import.add(domain="", version=12)
    g = model.graph
    g.name = "torch_jit"
    g.input.add(name="images")
    dtype, code = (np.float16, 10) if fp16 else (np.float32, 1)

    def tensor(name, a):
        a = np.ascontiguousarray(a, dtype)
        if weights == "constant":
            node = g.node.add(op_type="Constant", name=f"c_{name}")
            node.output.append(f"{name}_const")
            attr = node.attribute.add(name="value", type=4)
            attr.t.dims.extend(a.shape)
            attr.t.data_type = code
            attr.t.raw_data = a.tobytes()
            ident = g.node.add(op_type="Identity", name=f"i_{name}")
            ident.input.append(f"{name}_const")
            ident.output.append(name)
        else:
            t = g.initializer.add(name=name, data_type=code,
                                  dims=list(a.shape))
            t.raw_data = a.tobytes()

    prev = "images"
    shapes = _conv_shapes()
    for idx, (o, i, k, _) in enumerate(shapes):
        detect = idx >= len(shapes) - 3
        w = rng.randn(o, i, k, k).astype(np.float32) * 0.1
        tensor(f"w{idx}", w)
        node = g.node.add(op_type="Conv", name=f"Conv_{idx}")
        ins = [prev, f"w{idx}"]
        if form == "fused" or detect:
            tensor(f"b{idx}", rng.randn(o).astype(np.float32) * 0.1)
            ins.append(f"b{idx}")
        node.input.extend(ins)
        out = f"y{idx}"
        node.output.append(out)
        if form == "bn" and not detect:
            src = out
            if bn_via_identity:
                ident = g.node.add(op_type="Identity", name=f"id_y{idx}")
                ident.input.append(out)
                src = f"y{idx}_alias"
                ident.output.append(src)
            vals = [rng.rand(o) + 0.5, rng.randn(o) * 0.1,
                    rng.randn(o) * 0.1, rng.rand(o) + 0.5]
            names = []
            for leaf, v in zip(("scale", "bias", "mean", "var"), vals):
                tensor(f"bn{idx}_{leaf}", v)
                names.append(f"bn{idx}_{leaf}")
            if drop_bn_param == idx:
                names[2] = "nowhere"
            bn = g.node.add(op_type="BatchNormalization", name=f"BN_{idx}")
            bn.input.extend([src] + names)
            bn.attribute.add(name="epsilon", type=1, f=1e-5)
            out = f"bn_y{idx}"
            bn.output.append(out)
        prev = out
    g.output.add(name=prev)
    with open(path, "wb") as f:
        f.write(model.SerializeToString())


def _assert_trees_equal(got, want):
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("form,weights,fp16", [
    ("fused", "init", False), ("bn", "init", False),
    ("fused", "constant", False), ("bn", "constant", True),
    ("fused", "init", True)],
    ids=["fused", "explicit_bn", "constant_identity", "bn_constant_fp16",
         "fused_fp16"])
def test_onnx_porter_trees_equal_jax(onnx_pb2, tmp_path, form, weights,
                                     fp16):
    """The port's porter against hgr_tpu.utils.onnx_port on the same
    file: equal trees (each leaf bit for bit), for the fused and the
    explicit-BN forms, Constant/Identity weights and float16 storage."""
    from hgr_tpu.utils.onnx_port import port_yolov7_tiny_onnx as jport
    from hgr_tpu_torch.utils.onnx_port import port_yolov7_tiny_onnx

    path = str(tmp_path / "m.onnx")
    _write_onnx(onnx_pb2, path, seed=11, form=form, weights=weights,
                fp16=fp16)
    got = port_yolov7_tiny_onnx(path)
    _assert_trees_equal(got, jport(path))
    # and it loads into the port's model
    tyolo.YOLOv7Tiny().load_state_dict(from_flax(got), strict=True)


def test_onnx_porter_raises_on_an_unresolved_bn_parameter(onnx_pb2,
                                                          tmp_path):
    """A BatchNormalization after a conv whose mean names nothing: the
    port raises naming the conv, where the JAX porter writes an identity
    BN (hgr_tpu/utils/onnx_port.py:134; ROADMAP C, deliberate
    differences)."""
    from hgr_tpu.utils.onnx_port import port_yolov7_tiny_onnx as jport
    from hgr_tpu_torch.utils.onnx_port import port_yolov7_tiny_onnx

    path = str(tmp_path / "m.onnx")
    _write_onnx(onnx_pb2, path, seed=12, form="bn", drop_bn_param=7)
    with pytest.raises(ValueError, match="Conv_7.*elan2/cv1"):
        port_yolov7_tiny_onnx(path)
    silent = jport(path)  # the reference's behaviour, for the record
    np.testing.assert_array_equal(silent["params"]["elan2"]["cv1"]["bn"]
                                  ["scale"], 1.0)


def test_onnx_porter_follows_identity_into_the_bn(onnx_pb2, tmp_path):
    """A BatchNormalization reading its conv through an Identity: the port
    takes its parameters (the same tree as the direct form's), where the
    JAX porter misses it and writes identity BNs."""
    from hgr_tpu.utils.onnx_port import port_yolov7_tiny_onnx as jport
    from hgr_tpu_torch.utils.onnx_port import port_yolov7_tiny_onnx

    direct, aliased = str(tmp_path / "d.onnx"), str(tmp_path / "a.onnx")
    _write_onnx(onnx_pb2, direct, seed=13, form="bn")
    _write_onnx(onnx_pb2, aliased, seed=13, form="bn", bn_via_identity=True)
    got = port_yolov7_tiny_onnx(aliased)
    _assert_trees_equal(got, jport(direct))
    var = got["batch_stats"]["stem1"]["bn"]["var"]
    assert not np.allclose(var, 1.0 - tyolo.BN_EPS)
    assert np.allclose(jport(aliased)["batch_stats"]["stem1"]["bn"]["var"],
                       1.0 - tyolo.BN_EPS)


# -- reference Lightning checkpoints ------------------------------------------

def test_ckpt_loading_equals_jax_port(tmp_path):
    """A Lightning .ckpt in the reference's key names (``model.`` prefix,
    ``cv2.0``, ``layers.0.1.net.1``, ``running_mean``) through
    hgr_tpu.utils.torch_port.load_reference_checkpoint -> from_flax and
    through the port's loader: equal state_dicts, bit for bit; and the
    classifier loader takes the file."""
    from hgr_tpu.utils.torch_port import load_reference_checkpoint as jload
    from hgr_tpu_torch.infer.weights import load_classifier_weights
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet
    from hgr_tpu_torch.utils.torch_port import (
        _key_map,
        load_reference_checkpoint,
    )

    port_sd = MultiTaskNet(generator=torch.Generator().manual_seed(3)
                           ).state_dict()
    rng = np.random.RandomState(3)
    port_sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
               for k, v in port_sd.items()}
    to_ref = {p: r for r, p in _key_map({}, 4, 1).items()}
    assert set(to_ref) == set(port_sd)
    ref = {"model." + to_ref[k]: v for k, v in port_sd.items()}
    path = str(tmp_path / "best.ckpt")
    torch.save({"state_dict": ref, "epoch": 3}, path)

    want = from_flax(jload(path))
    got = load_reference_checkpoint(path)
    assert set(got) == set(want) == set(port_sd)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    loaded = load_classifier_weights(path)
    assert all(torch.equal(loaded[k], port_sd[k]) for k in port_sd)
