"""Halo rows for the screen-space stencil passes
(plainrenderer_tpu/parallel/halo.py).

halo_extend gives a band n extra rows above and below. On one device
(group None) they edge-replicate, the clamp-to-edge behaviour the
filters use at the frame border. In split-frame band mode an interior
border gets the neighbouring band's real rows and the frame's first and
last bands edge-replicate their outer border, so a filter chain run on
the extended planes and cropped equals the single-device chain away
from deep-stencil residuals. The JAX package ships the rows with one
ppermute each way; here one all_gather of every band's top and bottom n
rows carries them (gloo has send / recv on CPU tensors only, and at a
few bands the gather is as small), each band picking its neighbours'
slabs.
"""

from __future__ import annotations

import torch

from ..utils.stencil import clamped_index


def halo_extend(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """(..., H, W) -> (..., n+H+n, W), n clamped to H (halo.py:25-52):
    neighbour rows at interior band borders (group, a comm.BandGroup),
    edge-replicated rows at the frame's top and bottom."""
    h = x.shape[-2]
    n = min(n, h)
    pad = x.index_select(-2, clamped_index(h, -n, h + n, x.device))
    if group is None or group.size <= 1 or n == 0:
        return pad
    slabs = group.all_gather(torch.stack([x[..., :n, :], x[..., -n:, :]]))
    slabs = slabs.reshape((group.size, 2) + slabs.shape[1:])
    r = group.rank
    top = slabs[r - 1, 1] if r > 0 else pad[..., :n, :]
    bottom = slabs[r + 1, 0] if r < group.size - 1 else pad[..., -n:, :]
    return torch.cat([top, x, bottom], dim=-2)


def crop_halo(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of halo_extend on the row axis."""
    if n == 0:
        return x
    return x[..., n:-n, :]
