"""ONNX -> detector weights for the YOLOv7-tiny port (port of
hgr_tpu/utils/onnx_port.py:45).

The reference ships its detector as an ONNX file trained elsewhere
(reference README.md:84, detect.py:67). ``port_yolov7_tiny_onnx`` reads
its weights through the port's own wire-format reader
(``utils/onnx_reader.py``) and returns the Flax-layout variable tree
{params, batch_stats} of the JAX package's ``YOLOv7Tiny`` (numpy f32),
which ``utils/convert.py:from_flax`` turns into the port's state_dict.
Convs are matched by graph order, which for the yolov7 exporter (torch.onnx
tracing) is the module execution order, ``CONV_ORDER``.

It takes the exporter's variants as the JAX porter does: BN fused into
the conv (the published deploy form) or explicit BatchNormalization
nodes; weights as initializers or ``Constant`` nodes; ``Identity``
indirection; float16 storage. One deliberate difference (ROADMAP C,
"Deliberate differences"): where a BatchNormalization node consumes a
conv (its input resolved through the ``Identity`` aliases, which the JAX
porter does not follow there) but one of its parameters does not
resolve, the JAX porter writes an identity BN silently
(hgr_tpu/utils/onnx_port.py:134); this one raises, naming the conv.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from hgr_tpu_torch.models.yolo import BN_EPS
from hgr_tpu_torch.utils.onnx_reader import load_onnx_graph

# ConvAct blocks in YOLOv7Tiny's forward order: the exporter's
# topological Conv order (backbone -> neck -> heads)
CONV_ORDER: List[str] = [
    "stem1", "stem2",
    "elan1/cv1", "elan1/cv2", "elan1/cv3", "elan1/cv4", "elan1/out",
    "elan2/cv1", "elan2/cv2", "elan2/cv3", "elan2/cv4", "elan2/out",
    "elan3/cv1", "elan3/cv2", "elan3/cv3", "elan3/cv4", "elan3/out",
    "elan4/cv1", "elan4/cv2", "elan4/cv3", "elan4/cv4", "elan4/out",
    "spp/cv1", "spp/cv2", "spp/cv3", "spp/out",
    "up4_conv", "route4",
    "neck4/cv1", "neck4/cv2", "neck4/cv3", "neck4/cv4", "neck4/out",
    "up3_conv", "route3",
    "neck3/cv1", "neck3/cv2", "neck3/cv3", "neck3/cv4", "neck3/out",
    "down4",
    "neck4b/cv1", "neck4b/cv2", "neck4b/cv3", "neck4b/cv4", "neck4b/out",
    "down5",
    "neck5b/cv1", "neck5b/cv2", "neck5b/cv3", "neck5b/cv4", "neck5b/out",
    "head0_conv", "head1_conv", "head2_conv",
]
DETECT_CONVS = ["detect0", "detect1", "detect2"]


def _put(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def port_yolov7_tiny_onnx(path: str) -> Dict[str, Any]:
    """A yolov7-tiny .onnx -> YOLOv7Tiny variables {params, batch_stats}
    (Flax layout, numpy float32)."""
    graph = load_onnx_graph(path)
    inits = {name: t.to_numpy() for name, t in graph.initializers.items()}
    alias: Dict[str, str] = {}
    for node in graph.nodes:
        if node.op_type == "Constant" and node.outputs:
            t = node.attr_tensors.get("value")
            if t is not None:
                inits[node.outputs[0]] = t.to_numpy()
        elif node.op_type == "Identity" and node.inputs and node.outputs:
            alias[node.outputs[0]] = node.inputs[0]

    def resolve(name):
        seen = set()
        while name in alias and name not in seen:  # Identity chains
            seen.add(name)
            name = alias[name]
        return name

    def lookup(name):
        v = inits.get(resolve(name))
        return None if v is None else np.asarray(v, np.float32)

    # BatchNormalization nodes by the activation they consume, through
    # Identity aliases; inputs are [X, scale, B, mean, var]
    bn_by_input = {}
    for node in graph.nodes:
        if node.op_type == "BatchNormalization" and node.inputs:
            params = [lookup(n) for n in node.inputs[1:5]]
            params += [None] * (4 - len(params))
            bn_by_input[resolve(node.inputs[0])] = (
                params, node.attr_floats.get("epsilon", 1e-5))

    convs = []
    for node in graph.nodes:
        if node.op_type == "Conv":
            w = lookup(node.inputs[1])
            b = lookup(node.inputs[2]) if len(node.inputs) > 2 else None
            bn = bn_by_input.get(node.outputs[0]) if node.outputs else None
            convs.append((node.name or node.outputs[0], w, b, bn))

    n_named = len(CONV_ORDER)
    if len(convs) < n_named + len(DETECT_CONVS):
        raise ValueError(
            f"unexpected Conv count {len(convs)} in {path}; expected >= "
            f"{n_named + len(DETECT_CONVS)}")
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    # a fused conv (bias, no BN node) becomes an EXACT identity BN: with
    # var = 1 - eps the factor 1/sqrt(var + eps) is exactly 1
    identity_var = np.float32(1.0 - BN_EPS)
    for name, (node_name, w, b, bn) in zip(CONV_ORDER, convs[:n_named]):
        kernel = np.transpose(w, (2, 3, 1, 0))
        _put(params, f"{name}/conv/kernel", kernel)
        c = kernel.shape[-1]
        if bn is not None:
            (scale, bias, mean, var), eps_onnx = bn
            if any(v is None for v in (scale, bias, mean, var)):
                raise ValueError(
                    f"{path}: the BatchNormalization after conv "
                    f"{node_name!r} ({name}) has a parameter that resolves "
                    "to no initializer or Constant")
            # a conv bias folds into the BN mean; the node's epsilon is
            # reconciled with BN_EPS through the variance
            if b is not None:
                mean = mean - b
            _put(params, f"{name}/bn/scale", scale)
            _put(params, f"{name}/bn/bias", bias)
            _put(stats, f"{name}/bn/mean", mean)
            _put(stats, f"{name}/bn/var",
                 var + np.float32(eps_onnx - BN_EPS))
        else:
            _put(params, f"{name}/bn/scale", np.ones((c,), np.float32))
            _put(params, f"{name}/bn/bias",
                 b if b is not None else np.zeros((c,), np.float32))
            _put(stats, f"{name}/bn/mean", np.zeros((c,), np.float32))
            _put(stats, f"{name}/bn/var", np.full((c,), identity_var))
    for name, (_n, w, b, _bn) in zip(DETECT_CONVS,
                                     convs[n_named:n_named + 3]):
        _put(params, f"{name}/kernel", np.transpose(w, (2, 3, 1, 0)))
        _put(params, f"{name}/bias",
             b if b is not None else np.zeros((w.shape[0],), np.float32))
    return {"params": params, "batch_stats": stats}
