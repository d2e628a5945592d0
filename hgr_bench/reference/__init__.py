"""The benchmark's plain reference: frozen copies, in plain PyTorch, of
the architectures, the augment, the losses and the optimizer that the
cells run, independent of the package under test.

Nothing here imports the package under test, its plain versions or its
tests. The reference computes in float32 with TF32 off
(``Precision('float32')``); ``Precision('fp8')`` rounds every input and
weight of a convolution or dense layer to float8 e4m3 under a
per-tensor scale, the control of the comparison that decides
``correct`` (the configurations state bf16, and fp8 is the next
precision below it, the step an H100's tensor cores offer).
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("float32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3


class Precision:
    """Where the reference rounds: ``q`` is applied to each operand of a
    convolution or a dense product. ``float32`` leaves it alone; ``fp8``
    scales it so that its absolute maximum is e4m3's largest value, rounds
    it to e4m3 and scales it back, passing the gradient straight
    through."""

    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision {kind!r} not in {KINDS}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())


@contextlib.contextmanager
def exact_float32():
    """Matrix products and convolutions in float32 on the card (no TF32)
    within the block; the flags are restored after it, so the program's
    own settings hold outside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
