"""Halo rows for the screen-space stencil passes
(plainrenderer_tpu/parallel/halo.py), single-device part.

On one device halo_extend edge-pads n rows above and below, the
clamp-to-edge behaviour the filters use at the frame border, so a filter
chain run on the extended planes and cropped equals the JAX package's.
Split-frame band mode, which ships real neighbour rows between devices,
is not in this port yet and raises.
"""

from __future__ import annotations

import torch

from ..utils.stencil import clamped_index


def halo_extend(x: torch.Tensor, n: int, n_devices: int = 1) -> torch.Tensor:
    """(..., H, W) -> (..., n+H+n, W): edge-replicated rows, n clamped to
    H (halo.py:34-36)."""
    if n_devices > 1:
        raise NotImplementedError(
            "split-frame band mode (cross-device halo exchange) is not in "
            "this slice of the port")
    h = x.shape[-2]
    n = min(n, h)
    return x.index_select(-2, clamped_index(h, -n, h + n, x.device))


def crop_halo(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of halo_extend on the row axis."""
    if n == 0:
        return x
    return x[..., n:-n, :]
