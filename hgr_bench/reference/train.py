"""The training step, plain (reference train.py:58-107, libs/loss.py):
augment -> MultiTaskNet in train mode -> class_loss_weight · CE + the
joints MSE -> gradients -> AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay on every parameter).

In float32 one backward of the weighted sum gives the gradient that the
two task pullbacks add up to; the package under test takes the two
pullbacks apart because bf16 would drown the weighted class gradient.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from hgr_bench.reference import augment as A


def losses(logits, hmap, label, target, weight):
    """(CE, joints MSE): the mean cross-entropy, and per joint 0.5 ·
    mean over pixels of (w·(pred - gt))², averaged over joints and the
    batch."""
    ce = F.cross_entropy(logits.float(), label.long())
    pred = hmap.permute(0, 3, 1, 2).flatten(2)
    gt = target.flatten(2)
    w = weight[..., None]
    mse = 0.5 * ((pred * w - gt * w) ** 2).mean(-1).mean(-1).mean()
    return ce, mse


class AdamW:
    """torch's AdamW update written out."""

    def __init__(self, params, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - self.lr * self.wd)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


def follow(model, batches: List[Dict[str, torch.Tensor]],
           gen: torch.Generator, cfg: Dict, image_hw,
           keep_rows: float = 1.0) -> Dict[str, object]:
    """Take len(batches) steps of ``model`` (float32 parameters, train
    mode) from the draws of ``gen``. Returns the losses of each step, the
    first step's gradient and the parameters' change over all the steps,
    by ``named_parameters`` name. ``keep_rows`` < 1 takes the loss over
    that leading share of each batch only (a fault to plant)."""
    model.train()
    names, params = zip(*model.named_parameters())
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, cfg["lr"], cfg["weight_decay"])
    aug = cfg["augments"]
    out = {"loss": []}
    for batch in batches:
        b = batch["canvas"].shape[0]
        p = A.draw(gen, b, batch["sizes_hw"], aug)
        data = A.augment(batch, p, image_hw, cfg["sigma"])
        keep = max(1, int(round(b * keep_rows)))
        logits, hmap = model(data["image"][:keep])
        ce, mse = losses(logits, hmap, batch["label"][:keep],
                         data["target"][:keep], data["target_weight"][:keep])
        total = cfg["class_loss_weight"] * ce + mse
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        if "grad" not in out:
            out["grad"] = dict(zip(names, grads))
        out["loss"].append(float(total.detach()))
        opt.step(grads)
    out["change"] = {n: p.detach() - s for n, p, s in zip(names, params, start)}
    return out
