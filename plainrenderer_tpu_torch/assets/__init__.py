"""Assets (plainrenderer_tpu/assets): the .plain format, DDS, image IO,
the glTF importer and pipeline, the procedural atrium, textures and the
mesh SDF bake."""
