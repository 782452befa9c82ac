"""Miscellaneous math helpers (plainrenderer_tpu/utils/mathutils.py)."""

from __future__ import annotations

import torch


def direction_to_vector(direction_deg: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:4-16 — (phi, theta) degrees -> unit vector, y up is
    -cos(theta) (the reference's sun direction convention)."""
    theta = torch.deg2rad(direction_deg[..., 1])
    phi = torch.deg2rad(direction_deg[..., 0])
    return torch.stack([
        torch.sin(theta) * torch.cos(phi),
        -torch.cos(theta),
        torch.sin(theta) * torch.sin(phi),
    ], dim=-1)
