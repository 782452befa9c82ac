"""Carried per-frame state (plainrenderer_tpu/render/state.py).

Every FrameState field exists at the tile-padded sizes of the JAX
package (state.py:36-44). The GI history is written by the SDF GI pass,
the TAA history by the temporal filter, the fog history by the froxel
fog and taa_luminance by the TAA supersampling pre-pass.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as device_mod
from ..ops.raster import pad_resolution


@dataclasses.dataclass(frozen=True)
class FrameState:
    """All cross-frame tensors; render_frame returns a new FrameState."""

    frame_index: torch.Tensor  # () int32
    exposure: torch.Tensor  # () f32 (lightBuffer.previousFrameExposure)
    prev_color: torch.Tensor  # (3, H, W) previous frame HDR
    prev_depth: torch.Tensor  # (H, W) previous reverse-Z depth
    taa_history: torch.Tensor  # (H, W) int32 R11G11B10-packed TAA history
    taa_luminance: torch.Tensor  # (H, W) scene luminance history
    gi_history: torch.Tensor  # (3, Hg, Wg) int32 f16-pair-packed YSH+CoCg
    volumetric_history: torch.Tensor  # (4, D, Hv, Wv) froxel history
    prev_view_projection: torch.Tensor  # (4, 4)
    prev_jitter: torch.Tensor  # (2,)
    debug_counters: torch.Tensor  # (2,) i32 [main, shadow pair overflow]
    #   — must stay 0 (dropped pairs = missing geometry)


FROXEL_DEPTH = 64  # volumetric history depth (state.py:35 default)


def initial_state(width: int, height: int, gi_half_res: bool = True,
                  device="cuda") -> FrameState:
    """State buffers at the TILE-PADDED framebuffer size, on `device`; the
    GI history at half resolution unless gi_half_res is False
    (state.py:34-43)."""
    dev = device_mod.resolve(device)
    w, h = pad_resolution(width, height)
    if gi_half_res:
        gw, gh = pad_resolution(w // 2, h // 2)
    else:
        gh, gw = h, w
    vh, vw = max(h // 8, 1), max(w // 8, 1)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return FrameState(
        frame_index=torch.zeros((), **i32),
        exposure=torch.tensor(1e-4, **f32),
        prev_color=torch.zeros((3, h, w), **f32),
        prev_depth=torch.zeros((h, w), **f32),
        taa_history=torch.zeros((h, w), **i32),
        taa_luminance=torch.zeros((h, w), **f32),
        gi_history=torch.zeros((3, gh, gw), **i32),
        volumetric_history=torch.zeros((4, FROXEL_DEPTH, vh, vw), **f32),
        prev_view_projection=torch.eye(4, **f32),
        prev_jitter=torch.zeros((2,), **f32),
        debug_counters=torch.zeros((2,), **i32),
    )
