"""Hi-Z depth bounds (plainrenderer_tpu/ops/hiz.py:52).

The cascade fit reads only the lowest mip of the reference's min/max
pyramid (lightMatrix.comp:83-85), i.e. the frame's min and max depth, so
the port takes the two reductions directly.
"""

from __future__ import annotations

import torch


def depth_min_max(depth: torch.Tensor):
    """(min_depth, max_depth) 0-d tensors of a reverse-Z depth buffer.

    Sky texels (reverse-Z exactly 0) are left out of the min, as the
    reference's pyramid does (depthHiZPyramid.comp:66): one sky pixel would
    otherwise stretch the cascades to the far plane. An all-sky frame gives
    (1, 0)."""
    return (torch.where(depth == 0.0, 1.0, depth).amin(),
            depth.amax())
