"""Weight bridge and the CUDA kernel builder."""
