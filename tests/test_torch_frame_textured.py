"""Slice 2 of the port's whole frame against the JAX package: 3 frames of
the small textured atrium with the default sun shadows at 256x256 maps
(fog, GI, TAA and bloom off), held to torch_frame_checks.py's rule."""

import torch

from torch_frame_checks import _check_three_frames

torch.set_num_threads(1)


def test_three_frames_textured_shadowed_match_jax():
    """Slice 2: the textured atrium (banner_count=0) with the default sun
    shadows at 256x256 maps (_check_three_frames)."""
    _check_three_frames(textured_shadowed=True)
