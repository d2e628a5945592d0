"""Ops of the port: attention core (forward and backward CUDA kernels),
affine geometry, color jitter, warps (with the fused jitter + warp CUDA
kernel), heatmap targets and decode, losses, metrics, upsample,
positional embedding."""
