"""The launch counts of the port's CUDA kernels, by kernel name.

Each kernel's wrapper adds one to its ``launches`` attribute where it
launches the kernel. The counts live in the process that launched: the
ranks of a multi-rank run are processes of their own, and each writes
its counts to a file (``write``) that the parent reads back.
"""

from __future__ import annotations

import json
import os
from typing import Dict


def wrappers() -> Dict[str, object]:
    """Kernel name -> the wrapper that carries its count."""
    from hgr_tpu_torch.ops import bn_act
    from hgr_tpu_torch.ops.attention import (
        fused_attention_qkv,
        fused_attention_qkv_bwd,
        fused_attention_split,
        fused_attention_split_bwd,
    )
    from hgr_tpu_torch.ops.warp_fused import warp_twopass

    return {"attention_qkv_fwd": fused_attention_qkv,
            "attention_qkv_bwd": fused_attention_qkv_bwd,
            "attention_split_fwd": fused_attention_split,
            "attention_split_bwd": fused_attention_split_bwd,
            "warp_twopass": warp_twopass,
            "bn_act_reduce": bn_act.bn_act_reduce,
            "bn_act_elem": bn_act.bn_act_elem}


def counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def zero() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def write(path: str, **extra) -> None:
    """This process's counts (and ``extra`` entries) as JSON at ``path``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"launches": counts(), **extra}, f)
