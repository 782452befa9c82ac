"""Point subsampling (plainrenderer_tpu/utils/stencil.py point_downsample).

The JAX package writes the subsample as a masked max-pool because XLA:TPU
turns fused strided slices into gathers; on the GPU it is a strided view.
"""

from __future__ import annotations

import torch


def point_downsample(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i*sy, j*sx] over the trailing 2 axes, with
    the VALID-window output size (h // sy, w // sx) of the JAX version."""
    if sy == 1 and sx == 1:
        return x
    h, w = x.shape[-2:]
    return x[..., ::sy, ::sx][..., :h // sy, :w // sx]
