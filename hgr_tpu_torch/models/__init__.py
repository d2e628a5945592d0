"""MultiTaskNet and its parts, in PyTorch."""

from hgr_tpu_torch.models.multitasknet import MultiTaskNet, heatmaps_to_nchw

__all__ = ["MultiTaskNet", "heatmaps_to_nchw"]
