"""Reference (Lightning) MultiTaskNet checkpoints -> the port's state_dict
(port of hgr_tpu/utils/torch_port.py:47,84,154).

The reference stores its model as a Lightning ``.ckpt`` whose
``state_dict`` keys carry a ``model.`` prefix (reference export.py:34-40).
Its tensors already have PyTorch's layouts (OIHW convs, (out, in) linear
weights), which the port's modules keep, so porting is a renaming of keys:
the reference's module paths (``encoder.cspelan1.cv2.0``,
``decoder.transformer.layers.0.1.net.1``, BatchNorm ``running_mean``)
become the port's (``encoder.cspelan1.cv2_0``,
``decoder.transformer.layers_0_ff.fc1``, ``mean``), the same names the
JAX package's ``port_multitasknet`` gives its Flax tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def strip_lightning_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the Lightning ``model.`` prefix (reference export.py:36-39)."""
    return {k.replace("model.", "", 1) if k.startswith("model.") else k: v
            for k, v in state_dict.items()}


def _convbn(names: Dict[str, str], t: str, p: str) -> None:
    """One reference Conv (conv + bn, model/gelan.py:18-56)."""
    names[f"{t}.conv.weight"] = f"{p}.conv.weight"
    for leaf in ("weight", "bias"):
        names[f"{t}.bn.{leaf}"] = f"{p}.bn.{leaf}"
    names[f"{t}.bn.running_mean"] = f"{p}.bn.mean"
    names[f"{t}.bn.running_var"] = f"{p}.bn.var"


def _key_map(state_dict: Mapping[str, Any], depth: int,
             nblocks: int) -> Dict[str, str]:
    """Reference key -> port key for every tensor the model has."""
    names: Dict[str, str] = {}
    for t in ("conv1", "conv2", "down1", "down2"):
        _convbn(names, f"encoder.{t}", f"encoder.{t}")
    for blk in ("cspelan1", "cspelan2", "cspelan3"):
        t = p = f"encoder.{blk}"
        _convbn(names, f"{t}.cv1", f"{p}.cv1")
        _convbn(names, f"{t}.cv4", f"{p}.cv4")
        for i in range(nblocks):
            for cv in ("cv2", "cv3"):
                rt, rp = f"{t}.{cv}.{i}", f"{p}.{cv}_{i}"
                _convbn(names, f"{rt}.cv1", f"{rp}.cv1")
                _convbn(names, f"{rt}.cv2", f"{rp}.cv2")
                if f"{rt}.downsample.conv.weight" in state_dict:
                    _convbn(names, f"{rt}.downsample", f"{rp}.downsample")
    names["proj.weight"] = "proj.weight"
    names["decoder.cls_token"] = "decoder.cls_token"
    for i in range(depth):
        a = f"decoder.transformer.layers.{i}.0"
        pa = f"decoder.transformer.layers_{i}_attn"
        for leaf in ("norm.weight", "norm.bias", "to_qkv.weight",
                     "to_out.weight"):
            names[f"{a}.{leaf}"] = f"{pa}.{leaf}"
        f = f"decoder.transformer.layers.{i}.1.net"
        pf = f"decoder.transformer.layers_{i}_ff"
        for idx, mod in (("0", "norm"), ("1", "fc1"), ("4", "fc2")):
            for leaf in ("weight", "bias"):
                names[f"{f}.{idx}.{leaf}"] = f"{pf}.{mod}.{leaf}"
    for idx, mod in (("mlp_head.0", "mlp_head_norm"),
                     ("mlp_head.1", "mlp_head_fc"),
                     ("simple_decoder.1", "simple_decoder_conv")):
        for leaf in ("weight", "bias"):
            names[f"decoder.{idx}.{leaf}"] = f"decoder.{mod}.{leaf}"
    return names


def port_multitasknet(state_dict: Mapping[str, Any], depth: int = 4,
                      nblocks: int = 1) -> Dict[str, torch.Tensor]:
    """A reference MultiTaskNet state dict (Lightning prefix stripped) ->
    the port's state_dict, float32 CPU tensors. ``depth``: transformer
    layers (the reference hard-codes 4); ``nblocks``: ResBasicBlocks per
    GELAN chain (1 for 'small'). A missing reference key raises
    KeyError, as the reference's strict load does."""
    out = {}
    for ref, port in _key_map(state_dict, depth, nblocks).items():
        out[port] = torch.as_tensor(state_dict[ref]).detach().to(
            "cpu", torch.float32).contiguous().clone()
    return out


def load_reference_checkpoint(path: str, **kwargs) -> Dict[str, torch.Tensor]:
    """Load a Lightning .ckpt and port it (reference export.py:31-40).

    ``torch.load`` is called with ``weights_only=True``, torch's default
    since 2.6 and what the JAX package's own call gets, passed explicitly
    so an older torch behaves the same: the file is read as tensors and
    plain containers, and a checkpoint that pickles arbitrary objects is
    refused rather than executed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return port_multitasknet(strip_lightning_prefix(sd), **kwargs)
