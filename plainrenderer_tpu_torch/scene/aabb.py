"""Axis-aligned bounding boxes (plainrenderer_tpu/scene/aabb.py)."""

from __future__ import annotations

import numpy as np
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


def pad_sdf_bounding_box(bb_min, bb_max):
    """sdfUtilities.cpp:5-18 — pad by 7.5% of extent, min 0.5 m per side.

    The rule the SDF baker and the composite share, so baked volumes and
    their sampling agree. Host numpy in float32 (its callers are the asset
    pipeline and the scene composite)."""
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    extent = bb_max - bb_min
    padding = np.maximum(extent * np.float32(0.075), np.float32(0.5))
    return bb_min - padding, bb_max + padding
