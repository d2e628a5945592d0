"""The benchmark of hgr_tpu_torch on an NVIDIA H100 (``BENCHMARK.json``
at the repository root; ``README.md`` beside this file)."""
