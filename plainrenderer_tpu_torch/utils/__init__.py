"""Math, color, tonemap, stencil and noise helpers (plainrenderer_tpu/utils)."""
