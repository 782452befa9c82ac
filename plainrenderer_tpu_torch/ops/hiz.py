"""Hi-Z min/max depth pyramid (plainrenderer_tpu/ops/hiz.py,
depthHiZPyramid.comp).

The cascade fit reads only the lowest mip of the reference's pyramid
(lightMatrix.comp:83-85), i.e. the frame's min and max depth, so the
frame takes the two reductions directly (depth_min_max);
build_min_max_pyramid gives every level, a chain of 2x2 reductions.
"""

from __future__ import annotations

import torch


def build_min_max_pyramid(depth: torch.Tensor, max_mips: int = 11):
    """depth (H, W) reverse-Z -> [(min, max)] per mip, mip 0 at half the
    input's size, until a side is odd or below 2 (hiz.py:24). Sky texels
    (reverse-Z exactly 0) are left out of the min, as in depth_min_max."""
    levels = []
    cur_min = torch.where(depth == 0.0, 1.0, depth)
    cur_max = depth
    for _ in range(max_mips):
        h, w = cur_min.shape
        if h < 2 or w < 2 or h % 2 or w % 2:
            break
        cur_min = cur_min.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))
        cur_max = cur_max.reshape(h // 2, 2, w // 2, 2).amax(dim=(1, 3))
        levels.append((cur_min, cur_max))
    return levels


def depth_min_max(depth: torch.Tensor):
    """(min_depth, max_depth) 0-d tensors of a reverse-Z depth buffer.

    Sky texels (reverse-Z exactly 0) are left out of the min, as the
    reference's pyramid does (depthHiZPyramid.comp:66): one sky pixel would
    otherwise stretch the cascades to the far plane. An all-sky frame gives
    (1, 0)."""
    return (torch.where(depth == 0.0, 1.0, depth).amin(),
            depth.amax())
