"""Per-object frustum culling (plainrenderer_tpu/scene/frustum.py:133-187).

Culling runs in clip space against the frame's view-projection, as the
JAX package does, so it needs no frustum planes and no host round trip.
"""

from __future__ import annotations

import torch

from .aabb import aabb_corners


def visible_objects_clipspace(view_proj: torch.Tensor, bb_min: torch.Tensor,
                              bb_max: torch.Tensor,
                              cull_z: bool = True) -> torch.Tensor:
    """Conservative per-object culling: an AABB is culled iff all 8 corners
    are outside the same clip half-space (|x| > w, |y| > w, z < 0 or
    z > w, reverse-Z Vulkan conventions). bb_min/bb_max (N, 3) -> (N,) bool.
    cull_z=False drops the z test: shadow cascades render with depth
    clamping, so casters outside the fitted z range still matter.
    """
    corners = aabb_corners(bb_min, bb_max)  # (N, 8, 3)
    flat = corners.reshape(-1, 3)
    clip = flat @ view_proj[:3, :3].T + view_proj[:3, 3]
    w = flat @ view_proj[3, :3] + view_proj[3, 3]
    clip = clip.reshape(corners.shape[0], 8, 3)
    w = w.reshape(corners.shape[0], 8)
    out_l = torch.all(clip[..., 0] < -w, dim=1)
    out_r = torch.all(clip[..., 0] > w, dim=1)
    out_t = torch.all(clip[..., 1] < -w, dim=1)
    out_b = torch.all(clip[..., 1] > w, dim=1)
    outside = out_l | out_r | out_t | out_b
    if cull_z:
        out_n = torch.all(clip[..., 2] < 0.0, dim=1)
        out_f = torch.all(clip[..., 2] > w, dim=1)
        outside = outside | out_n | out_f
    return ~outside


def expand_object_mask(obj_mask: torch.Tensor, tri_starts: torch.Tensor,
                       t_count: int) -> torch.Tensor:
    """Per-object mask (O,) bool -> per-triangle mask (T,) bool.

    Triangles are object-contiguous, so the mask is a scatter of per-object
    deltas at each object's first triangle plus one int32 prefix sum
    (torch.cumsum widens to int64 unless told otherwise)."""
    vals = obj_mask.to(torch.int32)
    deltas = torch.diff(vals, prepend=vals.new_zeros(1))
    # JAX's mode="drop": out-of-range starts add nothing (masked, not
    # filtered, so no device-to-host sync)
    keep = tri_starts < t_count
    acc = torch.zeros((t_count,), dtype=torch.int32, device=obj_mask.device)
    acc.index_add_(0, tri_starts.clamp(max=t_count - 1).long(),
                   torch.where(keep, deltas, 0))
    return torch.cumsum(acc, 0, dtype=torch.int32) > 0
