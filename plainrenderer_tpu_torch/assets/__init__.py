"""Scene data types and the procedural atrium (plainrenderer_tpu/assets)."""
