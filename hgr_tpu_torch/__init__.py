"""PyTorch/CUDA port of ``hgr_tpu``: the gesture classifier served on an
NVIDIA H100.

The JAX package ``hgr_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``models/``, ``infer/``, ``serve/``, ``cli/``,
``utils/``) and keeps its public layouts (NHWC images, NHWC heatmaps), so
each module can be held against its counterpart. It imports neither JAX
nor ``hgr_tpu``.
"""
