"""Render passes and their kernels (plainrenderer_tpu/ops)."""
