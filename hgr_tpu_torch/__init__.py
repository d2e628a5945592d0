"""PyTorch/CUDA port of ``hgr_tpu``: the gesture classifier served and
trained on an NVIDIA H100.

The JAX package ``hgr_tpu`` stays the reference. This package mirrors its
layout (``ops/``, ``models/``, ``data/``, ``train/``, ``infer/``,
``serve/``, ``cli/``, ``tools/``, ``utils/``) and keeps its public layouts
(NHWC images, NHWC heatmaps, the staged uint8 canvas batch), so each
module can be held against its counterpart. It imports neither JAX nor
``hgr_tpu``.
"""
