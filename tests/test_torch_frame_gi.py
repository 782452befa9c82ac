"""Slice 3 of the port's whole frame against the JAX package: 3 frames of
the small textured atrium with sun shadows and SDF GI, held to
torch_frame_checks.py's rule and its GI history bounds."""

import torch

from torch_frame_checks import _check_three_frames

torch.set_num_threads(1)


def test_three_frames_gi_match_jax():
    """Slice 3: the textured atrium with sun shadows and SDF GI, the JAX
    scene and its SDF carried across by interop; the camera moves a little
    every frame, as on the bench path (_check_three_frames). The GI history
    after frame 3: f16 words within 2 ulp on >= 99% and within 16 ulp on
    >= 99.9%. Ulp-level differences upstream (raster depth, kernel B's
    normals within 1e-4, the sky LUT's cancellation-sensitive texels)
    redirect a few rays, and the 16-tap spatial filter spreads each over
    ~150 half-res pixels, so 2 ulp on 99.9% is not reached here; fed the
    JAX frame's GI inputs, the GI block reaches it
    (test_gi_block_on_jax_inputs_matches_jax_history)."""
    _check_three_frames(textured_shadowed=True, gi=True)
