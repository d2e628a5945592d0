"""Post-training int8 quantization of the GELAN backbone for serving (port
of hgr_tpu/infer/quant.py:38-148).

Scheme (standard symmetric PTQ), as the JAX package builds it:
  * BatchNorm folded into the conv: W' = W · gamma/sqrt(var+eps),
    b' = beta − mean · gamma/sqrt(var+eps);
  * weights: per-output-channel symmetric int8 (scale = absmax/127);
  * activations: per-tensor symmetric int8, the scale calibrated from
    representative batches (the absmax at each ConvBnAct input);
  * the conv accumulates exactly in int32 (``ops/int8_conv.py``); the
    dequantization, bias and SiLU stay float32 (``models/layers.py``).
The ViT decoder, the projection and the pose head keep their float path.

Flow:
  stats = calibrate_act_scales(model, batches, need_attnmap=False)
  quant = quantize_variables(to_flax(model.state_dict()), stats)["quant"]
  attach_quant(model, quant)       # or: quantize_model(model, batches)

The stats and quant trees are nested dicts keyed by the module path, as
the Flax trees are (the port's module names are the Flax names), so they
compare leaf for leaf with the JAX package's. ``quantize_variables`` and
``_quantize_convbn`` are a copy of the JAX package's numpy arithmetic,
so the same stats give the same int8 tree bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch
from torch import nn

from hgr_tpu_torch.models.layers import ConvBnAct
from hgr_tpu_torch.utils.convert import to_flax

BN_EPS = 1e-5  # models/layers.py BatchNorm epsilon
CALIB_BATCH = 64  # the serving CLI's calibration batch (cli/serve.py:107-121)


def _set_leaf(tree: Dict[str, Any], path: str, name: str, value) -> None:
    node = tree
    for p in path.split(".") if path else ():
        node = node.setdefault(p, {})
    node[name] = value


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, batches: Iterable,
                         **forward_kwargs) -> Dict[str, Any]:
    """Run the calibration batches (arrays or tensors, (B, H, W, 3)) through
    ``model`` in eval mode on its device and return the absmax of every
    ConvBnAct input, merged by max over the batches: a module-path tree of
    float32 ``in_absmax`` leaves (the JAX ``quant_stats`` sow,
    hgr_tpu/models/layers.py:290-299). The recording hooks are installed
    for the run and removed after it."""
    device = next(model.parameters()).device
    absmax: Dict[str, torch.Tensor] = {}

    def recorder(name):
        def hook(_module, inputs):
            m = torch.amax(torch.abs(inputs[0].float()))
            absmax[name] = m if name not in absmax else torch.maximum(
                absmax[name], m)
        return hook

    was_training = model.training
    handles = [mod.register_forward_pre_hook(recorder(name))
               for name, mod in model.named_modules()
               if isinstance(mod, ConvBnAct)]
    seen = 0
    try:
        model.eval()
        for batch in batches:
            model(torch.as_tensor(batch).to(device), **forward_kwargs)
            seen += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if not seen:
        raise ValueError("calibrate_act_scales needs at least one batch")
    stats: Dict[str, Any] = {}
    for name, m in absmax.items():
        # the sow's init is 0 (layers.py:298): max(0, absmax)
        _set_leaf(stats, name, "in_absmax",
                  np.float32(max(float(m), 0.0)))
    return stats


def _is_convbn(node: Any) -> bool:
    return (isinstance(node, dict) and "conv" in node and "bn" in node
            and isinstance(node["conv"], dict)
            and "kernel" in node["conv"])


def quantize_variables(variables: Dict[str, Any], act_stats: Dict[str, Any],
                       eps: float = BN_EPS) -> Dict[str, Any]:
    """``variables`` (Flax layout, e.g. ``to_flax(model.state_dict())``)
    plus a 'quant' collection of int8 entries for every calibrated
    ConvBnAct (hgr_tpu/infer/quant.py:68-109). Raises where no ConvBnAct
    matches the stats."""
    params = variables["params"]
    bstats = variables["batch_stats"]

    def walk(p: Dict[str, Any], b: Dict[str, Any], s: Dict[str, Any]
             ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, node in p.items():
            if key not in s:
                continue  # module never calibrated (e.g. not a ConvBnAct)
            if _is_convbn(node):
                absmax = float(np.asarray(s[key]["in_absmax"]))
                out[key] = _quantize_convbn(node, b[key], absmax, eps)
            elif isinstance(node, dict):
                sub = walk(node, b.get(key, {}), s[key])
                if sub:
                    out[key] = sub
        return out

    if _is_convbn(params):  # the model IS a single ConvBnAct
        quant = _quantize_convbn(
            params, bstats, float(np.asarray(act_stats["in_absmax"])), eps)
    else:
        quant = walk(params, bstats, act_stats)
    if not quant:
        raise ValueError("no ConvBnAct modules matched the calibration "
                         "stats — did calibration run on this model?")
    new_vars = dict(variables)
    new_vars["quant"] = quant
    return new_vars


def _quantize_convbn(p: Dict[str, Any], b: Dict[str, Any], absmax: float,
                     eps: float) -> Dict[str, np.ndarray]:
    w = np.asarray(p["conv"]["kernel"], np.float32)  # (k, k, Cin, Cout)
    gamma = np.asarray(p["bn"]["scale"], np.float32)
    beta = np.asarray(p["bn"]["bias"], np.float32)
    mean = np.asarray(b["bn"]["mean"], np.float32)
    var = np.asarray(b["bn"]["var"], np.float32)

    a = gamma / np.sqrt(var + eps)  # (Cout,)
    w_folded = w * a  # broadcast over the last (out-channel) axis
    bias = beta - mean * a

    w_scale = np.abs(w_folded).max(axis=(0, 1, 2)) / 127.0  # (Cout,)
    w_scale = np.maximum(w_scale, 1e-12)
    kernel_q = np.clip(np.round(w_folded / w_scale), -127, 127
                       ).astype(np.int8)

    act_scale = np.float32(max(absmax, 1e-12) / 127.0)
    return {
        "kernel_q": kernel_q,
        "act_scale": act_scale,
        "out_scale": (act_scale * w_scale).astype(np.float32),
        "bias": bias.astype(np.float32),
    }


def _quant_modules(tree: Dict[str, Any], path: str = ""):
    """(module path, leaves) of every ConvBnAct entry of a quant tree."""
    if "kernel_q" in tree:
        yield path, tree
        return
    for key, node in tree.items():
        yield from _quant_modules(node, f"{path}.{key}" if path else key)


def attach_quant(model: nn.Module, quant: Dict[str, Any]) -> nn.Module:
    """Give every ConvBnAct named in the quant tree its int8 buffers (on
    the module's device); returns ``model``."""
    for path, leaves in _quant_modules(quant):
        mod = model.get_submodule(path) if path else model
        if not isinstance(mod, ConvBnAct):
            raise ValueError(f"{path or 'the model'} is not a ConvBnAct")
        q = mod.quant if mod.quant is not None else mod.add_quant()
        for name, buf in q.named_buffers():
            src = torch.as_tensor(np.asarray(leaves[name]))
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(
                    f"{path}.quant.{name}: {tuple(src.shape)} {src.dtype}, "
                    f"the module takes {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(src)
    return model


def add_quant_slots(model: nn.Module, state_dict: Dict[str, Any]
                    ) -> nn.Module:
    """Give every ConvBnAct that ``state_dict`` holds ``quant.*`` entries
    for an empty int8 state, so that the state dict loads with
    ``strict=True`` and the model serves int8; returns ``model``."""
    suffix = ".quant.kernel_q"
    for key in state_dict:
        if key.endswith(suffix):
            mod = model.get_submodule(key[:-len(suffix)])
            if mod.quant is None:
                mod.add_quant()
    return model


def quantize_model(model: nn.Module, calibration_batches: Iterable,
                   eps: float = BN_EPS, **forward_kwargs) -> nn.Module:
    """One-call PTQ (hgr_tpu/infer/quant.py:138): calibrate, fold and
    quantize, then attach the int8 buffers to ``model``; returns it."""
    stats = calibrate_act_scales(model, calibration_batches, **forward_kwargs)
    qvars = quantize_variables(to_flax(model.state_dict()), stats, eps)
    return attach_quant(model, qvars["quant"])


def normalize_crops(crops: np.ndarray) -> np.ndarray:
    """uint8 (N, H, W, 3) crops -> float32 model inputs: /255, −mean, /std
    in numpy float32, as the JAX serving CLI normalizes its calibration
    crops."""
    from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

    return ((crops.astype(np.float32) / 255.0)
            - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
                IMAGENET_STD, np.float32)


def quantize_from_crops(model: nn.Module, path: str) -> nn.Module:
    """Quantize ``model``'s backbone to int8 in place from the calibration
    crops at ``path`` (cli/serve.py:107-121): a .npy, or an .npz's first
    array, of (N, H, W, 3) uint8 crops, normalized and calibrated in
    batches of CALIB_BATCH. Returns the model."""
    crops = np.load(path)
    if hasattr(crops, "files"):  # npz
        crops = crops[crops.files[0]]
    batches = [normalize_crops(crops[i:i + CALIB_BATCH])
               for i in range(0, len(crops), CALIB_BATCH)]
    quantize_model(model, batches, need_attnmap=False)
    print(f"quantized backbone from {len(crops)} calibration crops")
    return model

