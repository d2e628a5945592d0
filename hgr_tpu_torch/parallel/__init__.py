"""Multi-rank training over torch.distributed (port of hgr_tpu/parallel):
data parallelism over a 'data' axis and tensor parallelism of the ViT
decoder over a 'model' axis, every rank one process."""
