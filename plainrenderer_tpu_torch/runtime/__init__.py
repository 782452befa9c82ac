"""Runtime: the app, its shell and the stats overlay (plainrenderer_tpu/runtime)."""
