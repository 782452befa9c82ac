"""Tonemap pass and per-pixel material lookup (plainrenderer_tpu/ops/post.py).

material_lookup keeps the JAX function's own rule (post.py:54-66): a table
of at most 128 materials over a tile-aligned framebuffer goes through
kernel C (csrc/material.cu, replaces post.py:69 _material_kernel); any
other shape takes the unrolled select-sum, on every device, as the JAX
function does.
"""

from __future__ import annotations

import torch

from .. import native
from ..utils import color as colorlib
from ..utils import tonemap as tonemaplib
from .raster import TILE_H, TILE_W, _kernel_device, _require


def tonemap_pass(hdr: torch.Tensor, time: torch.Tensor,
                 row_offset: int = 0) -> torch.Tensor:
    """hdr (3, H, W) linear -> (H, W, 3) uint8 sRGB (tonemapping.comp):
    ACES fitted, sRGB encode, hash dither, round half to even, clip.
    row_offset: a split-frame band's first row in the frame, so the
    dither hash sees the frame's rows (post.py:22-36)."""
    c = tonemaplib.aces_fitted_planar(hdr)
    c = colorlib.linear_to_srgb(c)
    h, w = c.shape[-2:]
    px = torch.arange(w, dtype=torch.int32, device=c.device)[None, :]
    py = torch.arange(h, dtype=torch.int32, device=c.device)[:, None] \
        + row_offset
    px, py = torch.broadcast_tensors(px, py)
    c = c + colorlib.dither_noise_planar(px, py, time)
    u8 = torch.clamp(torch.round(c * 255.0), 0, 255).to(torch.uint8)
    return u8.permute(1, 2, 0)


def material_table_lanes(material_table: torch.Tensor) -> torch.Tensor:
    """(M, C) material table -> (C, 128) f32, zero-padded past M."""
    m, c = material_table.shape
    table = torch.zeros((c, 128), dtype=torch.float32,
                        device=material_table.device)
    table[:, :m] = material_table.T
    return table


def material_plain(table: torch.Tensor, ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: out[c] = table[c, clip(int(id), 0, 127)]
    where valid, else 0; (C, H, W)."""
    idx = torch.clamp(ids.to(torch.int32), 0, 127).long()
    return torch.where(valid[None], table[:, idx], 0.0)


def material_kernel(table: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Kernel C wrapper: table (C, 128) f32, ids (H, W) f32, valid (H, W)
    bool -> (C, H, W) f32."""
    dev = ids.device
    _require(table, "table", torch.float32, 2, dev)
    _require(ids, "ids", torch.float32, 2, dev)
    _require(valid, "valid", torch.bool, 2, dev)
    if table.shape[1] != 128 or valid.shape != ids.shape:
        raise ValueError(f"table {tuple(table.shape)} must be (C, 128) and "
                         f"valid {tuple(valid.shape)} match ids "
                         f"{tuple(ids.shape)}")
    if not _kernel_device(ids):
        return material_plain(table, ids, valid)
    c = table.shape[0]
    h, w = ids.shape
    out = torch.empty((c, h, w), dtype=torch.float32, device=dev)
    native.launch("material_launch", table, ids, valid, out, h * w, c)
    return out


def material_lookup(material_table: torch.Tensor, material_ids: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel material constants: material_table (M, C) f32,
    material_ids (H, W) f32, valid (H, W) bool -> (C, H, W)."""
    m, c = material_table.shape
    if m <= 128 and material_ids.shape[-2] % TILE_H == 0 \
            and material_ids.shape[-1] % TILE_W == 0:
        return material_kernel(material_table_lanes(material_table),
                               material_ids.to(torch.float32).contiguous(),
                               valid.contiguous())
    ids = material_ids.to(torch.int32)
    out = []
    for ci in range(c):
        acc = torch.zeros_like(material_ids, dtype=torch.float32)
        for mi in range(m):
            acc = torch.where(ids == mi, material_table[mi, ci], acc)
        out.append(torch.where(valid, acc, 0.0))
    return torch.stack(out)
