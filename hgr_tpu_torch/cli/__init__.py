"""Command-line entry points (``python -m hgr_tpu_torch.cli.<name>``)."""
