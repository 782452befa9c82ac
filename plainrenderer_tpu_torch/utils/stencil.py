"""Point subsampling and clamped stencil taps
(plainrenderer_tpu/utils/stencil.py).

The JAX package writes the subsample as a masked max-pool because XLA:TPU
turns fused strided slices into gathers; on the GPU it is a strided view.
EdgePadded keeps the JAX package's tap conventions; its edge padding is
an index_select of clamped rows and columns.
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


def clamped_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """arange(lo, hi) clamped into [0, n - 1] (clamp-to-edge indices)."""
    return torch.clamp(torch.arange(lo, hi, device=device), 0, n - 1)


def edge_pad(x: torch.Tensor, my: int, mx: int) -> torch.Tensor:
    """Edge-replicated padding of the trailing 2 axes (jnp.pad mode=edge)."""
    h, w = x.shape[-2:]
    rows = clamped_index(h, -my, h + my, x.device)
    cols = clamped_index(w, -mx, w + mx, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


class EdgePadded:
    """Edge-replicated padding of the trailing 2 axes + static shift taps.

    tap(dy, dx) returns out[y, x] = in_clamped[y - dy, x - dx] (positive dy
    moves content down); tap_fwd(dy, dx) = in_clamped[y + dy, x + dx]."""

    def __init__(self, x: torch.Tensor, margin_y: int, margin_x: int = None):
        self.my = int(margin_y)
        self.mx = int(margin_x if margin_x is not None else margin_y)
        self.h, self.w = x.shape[-2:]
        self.padded = edge_pad(x, self.my, self.mx)

    def tap(self, dy: int, dx: int) -> torch.Tensor:
        assert abs(dy) <= self.my and abs(dx) <= self.mx, (dy, dx, self.my,
                                                           self.mx)
        y0 = self.my - dy
        x0 = self.mx - dx
        return self.padded[..., y0:y0 + self.h, x0:x0 + self.w]

    def tap_fwd(self, dy: int, dx: int) -> torch.Tensor:
        return self.tap(-dy, -dx)
