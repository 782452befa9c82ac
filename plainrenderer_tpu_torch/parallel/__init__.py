"""Split-frame band rendering over torch.distributed (plainrenderer_tpu/parallel/)."""
