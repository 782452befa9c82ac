"""Camera conventions and frustum culling (plainrenderer_tpu/scene)."""
