"""Inputs made from the seed: sub-seeds, and the classifier's weights
drawn on the device in a few large calls."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

from hgr_bench.reference import mtn


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def mtn_state(cfg: Dict, image_size, seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """The classifier's state dict (float32 on ``device``): conv and
    dense weights and biases U(±1/sqrt(fan_in)), the class token N(0, 1),
    norm scales 1 and shifts 0, BatchNorm statistics 0 and 1, as the
    package initializes them; drawn from the seed in two calls."""
    with torch.device("meta"):
        ref = mtn.from_config(cfg, image_size)
    plan = mtn.init_scales(ref)
    shapes = dict((n, p.shape) for n, p in ref.named_parameters())
    sizes = torch.tensor([shapes[n].numel() for n, _, _ in plan])
    kinds = torch.tensor([("uniform", "normal", "const").index(k)
                          for _, k, _ in plan])
    values = torch.tensor([v for _, _, v in plan], dtype=torch.float32)
    total = int(sizes.sum())
    gen = generator(seed, "classifier", device)
    uni = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(total, generator=gen, device=device)
    kind = torch.repeat_interleave(kinds.to(device), sizes.to(device))
    val = torch.repeat_interleave(values.to(device), sizes.to(device))
    flat = torch.where(kind == 0, uni * val,
                       torch.where(kind == 1, nor * val, val))
    state = dict(zip(shapes, (t.view(shapes[n]) for n, t in zip(
        shapes, flat.split(sizes.tolist())))))
    for name, buf in ref.named_buffers():
        if name.endswith(".mean"):
            state[name] = torch.zeros(buf.shape, device=device)
        elif name.endswith(".var"):
            state[name] = torch.ones(buf.shape, device=device)
    return state


def serving_state(cfg: Dict, image_size, seed: int, device,
                  crops: int = 64) -> Dict[str, torch.Tensor]:
    """``mtn_state`` with the BatchNorm statistics a trained network would
    hold: the batch statistics of each BatchNorm's input over ``crops``
    seeded hand crops, through the plain reference in train mode (so every
    layer sees normalized inputs). With the init's statistics (0 and 1)
    a served network's activations fade layer by layer and its answers
    hardly depend on the crop."""
    from hgr_bench import scenes
    from hgr_bench.reference import exact_float32
    from hgr_bench.reference.serve import normalize

    state = mtn_state(cfg, image_size, seed, device)
    x = torch.from_numpy(scenes.crops(crops, image_size[0], subseed(
        seed, "calibration"))).to(device)
    with exact_float32(), torch.no_grad():
        model = mtn.from_config(cfg, image_size).to(device)
        model.load_state_dict(state, strict=True)
        stats, hooks = {}, []
        for name, mod in model.named_modules():
            if isinstance(mod, mtn.BatchNorm):
                def hook(mod, inp, out, name=name):
                    v = inp[0].float().flatten(0, -2)
                    mean = v.mean(0)
                    stats[name] = (mean, torch.clamp(
                        (v * v).mean(0) - mean * mean, min=0.0))
                hooks.append(mod.register_forward_hook(hook))
        model.train()
        model(normalize(x))
        for h in hooks:
            h.remove()
    for name, (mean, var) in stats.items():
        state[f"{name}.mean"] = mean
        state[f"{name}.var"] = var
    return state
