"""Multi-device helpers (plainrenderer_tpu/parallel/); single device only."""
