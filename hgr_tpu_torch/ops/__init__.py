"""Ops of the port: attention core (with its CUDA kernel), upsample,
heatmap decode, positional embedding."""
