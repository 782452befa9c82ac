"""Frame graph, carried state and scene registration (plainrenderer_tpu/render)."""
