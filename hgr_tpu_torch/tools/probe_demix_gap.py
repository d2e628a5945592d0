"""Where does the batched de-mixed backward round away from two pullbacks?

``grad_demix='batched'`` takes both de-mixed pullbacks as one
``torch.autograd.grad(..., is_grads_batched=True)``; torch runs it under
its legacy vmap, which loops over the two cotangent rows at operators
without a batching rule (the same kernel on the same row: the same bits)
and runs the others batched. A batched operator may sum in another order
than the same operator on one row. In float32 (TF32 off) this probe
measures, on the card:

1. ``readings``: per model/batch seed and batch size, one step's
   per-tensor gap ||g_batched - g_pullbacks|| / ||g_pullbacks|| (the
   measure of chip_smoke.py's path 15, JAX's tolerance 1e-5 of the norm),
   its worst tensor, median and the tensors equal bit for bit; beside it
   the same gap between two runs of the two-pullback step and between
   two runs of the batched step (the run-to-run floor), and the worst
   gap per group of parameters (the first two parts of their names).
2. ``operators``: every module of the model, replayed alone on the input
   it took in that step, its backward of a seeded two-row cotangent
   batched against row by row, and one row taken twice (the operator's
   own run-to-run floor): the module classes whose batched gradients are
   not equal bit for bit, with their gap.

``--deterministic`` runs both under ``torch.use_deterministic_algorithms``
(warn only; the operators that have no deterministic implementation are
listed) with cuDNN's deterministic algorithms and a fixed cuBLAS
workspace.

Seed s builds the model from seed s, the staged batch from seed 2 + s and
the augment draw from seed s; seed 0 is chip_smoke.py's f32 check.

    python -m hgr_tpu_torch.tools.probe_demix_gap [--seeds 0 1 2] \\
        [--batches 8 32] [--out build/probe_demix_gap.json]

Runs on the card (nvcc builds the kernels) unless ``--device cpu``
(plain versions; with ``--image 64`` a quick rehearsal); prints one JSON
line per reading and per replayed batch, and writes every tensor's gap
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Dict, List

import numpy as np
import torch

CANVAS_MARGIN = 64  # canvas side = crop side + 64, as chip_smoke stages


def staged_batch(b: int, seed: int, canvas: int) -> Dict[str, np.ndarray]:
    """chip_smoke.py's staged batch: random uint8 canvases holding images
    of 200-400 px, joints in the central window, valid all ones."""
    rng = np.random.RandomState(seed)
    sizes = rng.uniform(200, 400, (b, 2)).astype(np.float32)
    a = np.zeros((b, 2, 3), np.float32)
    a[:, 0, 0] = a[:, 1, 1] = canvas / sizes.max(axis=1)
    return {
        "canvas": rng.randint(0, 256, (b, canvas, canvas, 3), np.uint8),
        "orig_to_canvas": a,
        "sizes_hw": sizes,
        "joints": (rng.uniform(0.35, 0.65, (b, 21, 2))
                   * sizes[:, None, ::-1]).astype(np.float32),
        "joints_vis": np.ones((b, 21), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int64),
        "valid": np.ones((b,), np.float32),
    }


def step_grads(demix, b: int, seed: int, dev: str, image: int,
               hooks=None):
    """The pre-update f32 gradients of one step of a fresh seeded model;
    ``hooks(model)`` is called before the step."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.train.steps import make_train_step

    model = MultiTaskNet(image_size=(image, image), dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, device=dev)
    if hooks is not None:
        hooks(state.model)
    step = make_train_step(AugmentConfig(), image_size=(image, image),
                           heatmap_size=(image // 4, image // 4),
                           grad_demix=demix, debug_return_grads=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             staged_batch(b, 2 + seed, image + CANVAS_MARGIN).items()}
    _, m = step(state, batch, torch.Generator(device=dev).manual_seed(seed))
    return {k: g.detach().clone() for k, g in m["_grads"].items()}, state


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def gaps(got, want) -> Dict[str, float]:
    return {k: float((got[k] - a).norm() / a.norm().clamp_min(1e-30))
            for k, a in want.items()}


def summary(errs: Dict[str, float], got, want) -> dict:
    worst = max(errs, key=errs.get)
    groups: Dict[str, float] = {}
    for k, e in errs.items():
        g = ".".join(k.split(".")[:2])
        groups[g] = max(groups.get(g, 0.0), e)
    return {"max": errs[worst], "worst_tensor": worst,
            "median": float(np.median(list(errs.values()))),
            "equal_bits": sum(bool(torch.equal(got[k], want[k]))
                              for k in want),
            "tensors": len(want), "by_group": groups}


def readings(seeds: List[int], batches: List[int], dev: str, image: int,
             out: dict) -> None:
    for b in batches:
        for seed in seeds:
            pb, _ = step_grads(True, b, seed, dev, image)
            pb2, _ = step_grads(True, b, seed, dev, image)
            bt, _ = step_grads("batched", b, seed, dev, image)
            bt2, _ = step_grads("batched", b, seed, dev, image)
            errs = gaps(bt, pb)
            row = {"batch": b, "seed": seed,
                   "batched_vs_pullbacks": summary(errs, bt, pb),
                   "pullbacks_twice": summary(gaps(pb2, pb), pb2, pb),
                   "batched_twice": summary(gaps(bt2, bt), bt2, bt),
                   "second_run_batched_vs_pullbacks":
                       summary(gaps(bt2, pb2), bt2, pb2)}
            print(json.dumps({"reading": row}), flush=True)
            out["readings"].append({**row, "per_tensor": errs})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _leafed(x, leaves: list):
    """``x`` with each float tensor replaced by a clone of a new leaf that
    requires grad (a clone, so in-place modules do not touch the leaf)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        leaf = x.detach().clone().requires_grad_(True)
        leaves.append(leaf)
        return leaf.clone()
    if isinstance(x, tuple):
        return tuple(_leafed(v, leaves) for v in x)
    if isinstance(x, list):
        return [_leafed(v, leaves) for v in x]
    if isinstance(x, dict):
        return {k: _leafed(v, leaves) for k, v in x.items()}
    return x


def operators(b: int, seed: int, dev: str, image: int, out: dict) -> None:
    """Replay every module on the input it took in one two-pullback step,
    and compare its batched backward with its row-by-row backward."""
    taken: Dict[str, tuple] = {}

    def hooks(model):
        for name, mod in model.named_modules():
            def pre(m, args, kwargs, name=name):
                if name not in taken:
                    taken[name] = (m, *_detached((args, kwargs)))
            mod.register_forward_pre_hook(pre, with_kwargs=True)

    step_grads(True, b, seed, dev, image, hooks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, (mod, args, kwargs) in taken.items():
        leaves: list = []
        a, kw = _leafed(args, leaves), _leafed(kwargs, leaves)
        params = [p for p in mod.parameters() if p.requires_grad]
        outs = [o for o in _tensors(mod(*a, **kw))
                if o.is_floating_point() and o.requires_grad]
        wrt = leaves + params
        if not outs or not wrt:
            continue
        vs = [torch.randn((2,) + tuple(o.shape), generator=gen,
                          device=o.device, dtype=o.dtype) for o in outs]
        batched = torch.autograd.grad(outs, wrt, vs, retain_graph=True,
                                      allow_unused=True,
                                      is_grads_batched=True)
        single, again = ([torch.autograd.grad(outs, wrt, [v[r] for v in vs],
                                              retain_graph=True,
                                              allow_unused=True)
                          for r in range(2)] for _ in range(2))
        gap, floor, unequal = 0.0, 0.0, []
        for i, g in enumerate(batched):
            if g is None:
                continue
            label = f"input{i}" if i < len(leaves) else "param"
            for r in range(2):
                ref = single[r][i]
                if not torch.equal(g[r], ref):
                    gap = max(gap, _rel(g[r], ref))
                    unequal.append(label)
                if not torch.equal(again[r][i], ref):
                    floor = max(floor, _rel(again[r][i], ref))
        rows.append({"module": name, "class": type(mod).__name__,
                     "leaf": next(mod.children(), None) is None,
                     "max_gap": gap, "unequal": sorted(set(unequal)),
                     "row_twice_gap": floor})
    by_class: Dict[str, dict] = {}
    for r in rows:
        c = by_class.setdefault(r["class"], {
            "modules": 0, "batched_unequal": 0, "max_gap": 0.0,
            "row_twice_unequal": 0, "max_row_twice_gap": 0.0})
        c["modules"] += 1
        c["batched_unequal"] += bool(r["unequal"])
        c["max_gap"] = max(c["max_gap"], r["max_gap"])
        c["row_twice_unequal"] += r["row_twice_gap"] > 0
        c["max_row_twice_gap"] = max(c["max_row_twice_gap"],
                                     r["row_twice_gap"])
    # leaf modules whose one row, taken twice, is the same bits, but
    # whose batched backward is not: the batched form's own rounding
    batched_only = sorted({r["class"] for r in rows if r["leaf"]
                           and r["unequal"] and not r["row_twice_gap"]})
    line = {"batch": b, "seed": seed, "modules": len(rows),
            "by_class": by_class,
            "leaf_classes_batched_differs": batched_only,
            "leaf_classes_nondeterministic": sorted({
                r["class"] for r in rows
                if r["leaf"] and r["row_twice_gap"]})}
    print(json.dumps({"operators": line}), flush=True)
    out["operators"].append({**line, "per_module": rows})


def _detached(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        return tuple(_detached(v) for v in x)
    if isinstance(x, list):
        return [_detached(v) for v in x]
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    return x


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--batches", type=int, nargs="+", default=[8, 32])
    parser.add_argument("--out", default="build/probe_demix_gap.json")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--image", type=int, default=192)
    parser.add_argument("--deterministic", action="store_true")
    args = parser.parse_args(argv)
    if args.deterministic:  # cuBLAS reads it when the context starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else args.device),
           "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version(), "image": args.image,
           "deterministic": args.deterministic, "readings": [],
           "operators": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        readings(args.seeds, args.batches, args.device, args.image, out)
        operators(max(args.batches), args.seeds[0], args.device, args.image,
                  out)
    out["nondeterministic_ops"] = sorted({
        str(w.message).split(" does not have a deterministic")[0]
        for w in caught if "deterministic implementation" in str(w.message)})
    print(json.dumps({"nondeterministic_ops": out["nondeterministic_ops"]}),
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
