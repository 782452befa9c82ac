"""Axis-aligned bounding boxes (plainrenderer_tpu/scene/aabb.py)."""

from __future__ import annotations

import torch


def aabb_corners(bb_min: torch.Tensor, bb_max: torch.Tensor) -> torch.Tensor:
    """AABB.cpp getAxisAlignedBoundingBoxPoints — the 8 corners, (..., 8, 3);
    corner i takes max where bit (2, 1, 0) of i is set (AABB.cpp order)."""
    i = torch.arange(8, device=bb_min.device)
    picks = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1],
                        dim=-1).to(torch.float32)
    lo = bb_min[..., None, :]
    hi = bb_max[..., None, :]
    return lo + (hi - lo) * picks
