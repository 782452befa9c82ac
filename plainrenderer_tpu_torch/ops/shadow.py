"""Cascaded sun shadow maps: cascade fit, u16 packing, PCF resolve
(plainrenderer_tpu/ops/shadow.py).

  - compute_cascade_info: lightMatrix.comp — linear splits between the
    frame's depth bounds, an ortho fit per cascade around its sub-frustum
    in light space, the last cascade extended by the SDF influence radius
    and the fog distance; all device tensors, no host round trip;
  - pack_shadow_maps_u16: Depth16 quantisation, two y-adjacent texels per
    int32 word;
  - shadow_resolve: triangle.frag:89-120 calcShadow — the cascade per
    pixel by linear depth, a 12-tap spiral PCF rotated by blue noise.
    Kernel F (csrc/shadow.cu) for CUDA tensors, shadow_resolve_plain for
    CPU tensors. The JAX package fetches a 32x256-texel window of the map
    per tile and cascade, placed around the masked mean texel and clamped
    to the map, and clamps every tap into it; the port keeps that rule
    (taps outside the window read its edge) and sums the tile means in the
    fixed order of ops/texture.tile_sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native
from .raster import TILE_H, TILE_W, _kernel_device, _require
from .texture import from_thread_layout, tile_sum, to_thread_layout

MAX_CASCADES = 4  # sunShadowCascades.inc:4
SHADOW_SAMPLE_RADIUS = 0.03  # world-space, sunShadowCascades.inc:5
WINDOW_H = 32  # texel rows of a tile's map window
WINDOW_W = 256
ROW_F = 32  # per-cascade row: 16 matrix, 2 scale, 1 split, pad


def linearize_depth(depth, near, far):
    """linearDepth.inc:5-8 — reverse-Z [0,1] -> linear view distance."""
    return near * far / (far + (-depth + 1.0) * (near - far))


@functools.lru_cache(maxsize=8)
def _fit_constants(dev: torch.device) -> dict:
    """Small constant tensors of the cascade fit, copied to the device
    once (a copy inside the frame would wait for the device)."""
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "correction": torch.tensor(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -0.5, 0.5], [0, 0, 0, 1]],
            **f32),
        "up_y": torch.tensor([0.0, -1.0, 0.0], **f32),
        "up_z": torch.tensor([0.0, 0.0, -1.0], **f32),
        "split_idx": torch.arange(1, MAX_CASCADES + 1, **f32),
        "eye": torch.eye(4, **f32),
        "unit_w": torch.tensor([0.0, 0.0, 0.0, 1.0], **f32),
    }


def compute_cascade_info(depth_min, depth_max, camera_position,
                         camera_forward, camera_up, camera_right,
                         tan_fov_half: float, aspect: float, near: float,
                         far: float, sun_direction, cascade_count: int,
                         highest_cascade_extra_padding,
                         highest_cascade_min_far,
                         sample_radius: float = SHADOW_SAMPLE_RADIUS):
    """lightMatrix.comp main() (shadow.py:57): (matrices (4, 4, 4), splits
    (4,), light_space_scale (4, 2)), padded to MAX_CASCADES with identity
    matrices and unit scales."""
    k = _fit_constants(depth_min.device)
    depth_max_linear = linearize_depth(depth_min, near, far)
    depth_min_linear = linearize_depth(depth_max, near, far)

    # light view matrix (lightMatrix.comp:66-80)
    forward = -sun_direction
    up0 = torch.where(torch.abs(forward[1]) < 0.9999, k["up_y"], k["up_z"])
    right = torch.linalg.cross(forward, up0)
    up = torch.linalg.cross(right, forward)
    right = right / torch.clamp(torch.linalg.vector_norm(right), min=1e-9)
    up = up / torch.clamp(torch.linalg.vector_norm(up), min=1e-9)
    zero = torch.zeros_like(forward[:1])
    v = torch.stack([torch.cat([right, zero]), torch.cat([up, zero]),
                     torch.cat([forward, zero]), k["unit_w"]])

    # linear splits (lightMatrix.comp:54-56)
    splits = depth_min_linear + (
        (depth_max_linear - depth_min_linear) * k["split_idx"]
        / cascade_count)

    def frustum_points(near_d, far_d):
        """lightMatrix.comp:31-50."""
        pts = []
        for dist in (far_d, near_d):
            center = camera_position + camera_forward * dist
            hh = tan_fov_half * dist
            ww = hh * aspect
            for sy in (1.0, -1.0):
                for sx in (1.0, -1.0):
                    pts.append(center + camera_up * (hh * sy)
                               + camera_right * (ww * sx))
        return torch.stack(pts)  # (8, 3)

    matrices, scales = [], []
    for c in range(cascade_count):
        cmin = depth_min_linear if c == 0 else splits[c - 1]
        cmax = splits[c]
        if c == cascade_count - 1:
            cmin = near
            cmax = torch.maximum(depth_max_linear, highest_cascade_min_far)
        pts_ls = frustum_points(cmin, cmax) @ v[:3, :3].T
        min_p = pts_ls.amin(dim=0)
        max_p = pts_ls.amax(dim=0)
        if c == cascade_count - 1:
            min_p = min_p - highest_cascade_extra_padding
            max_p = max_p + highest_cascade_extra_padding
        min_p = min_p - sample_radius * 2
        max_p = max_p + sample_radius * 2
        scale = 2.0 / (max_p - min_p)
        offset = -0.5 * (max_p + min_p) * scale
        p = torch.diag(torch.cat([scale, k["unit_w"][3:]]))
        p = p + torch.cat([torch.zeros((4, 3), dtype=p.dtype,
                                       device=p.device),
                           torch.cat([offset, zero])[:, None]], dim=1)
        matrices.append(k["correction"] @ p @ v)
        scales.append(scale[:2])
    while len(matrices) < MAX_CASCADES:
        matrices.append(k["eye"])
        scales.append(torch.ones_like(k["up_y"][:2]))
    return (torch.stack(matrices[:MAX_CASCADES]), splits,
            torch.stack(scales[:MAX_CASCADES]))


def pack_shadow_maps_u16(shadow_maps: torch.Tensor) -> torch.Tensor:
    """(C, S, S) f32 reverse-Z -> (C, S/2, S) i32 of y-adjacent u16 texels
    (shadow.py:151): Depth16 quantisation, the reference's shadow-map
    format (RenderFrontend.cpp:1210)."""
    q = torch.round(torch.clamp(shadow_maps, 0.0, 1.0) * 65535.0).to(
        torch.int32)
    return q[..., 0::2, :] | (q[..., 1::2, :] << 16)


def cascade_rows(cascade_matrices, cascade_scales, splits) -> torch.Tensor:
    """(MAX_CASCADES, ROW_F) f32 per-cascade rows: matrix 0-15, light
    scale 16-17, split 18 (shadow.py:315-318)."""
    pad = torch.zeros((MAX_CASCADES, ROW_F - 19), dtype=torch.float32,
                      device=splits.device)
    return torch.cat([cascade_matrices.reshape(MAX_CASCADES, 16),
                      cascade_scales, splits[:, None], pad], dim=1)


def _spiral(taps: int) -> np.ndarray:
    """(2, taps) f32 cos / sin of the taps' spiral angles 2*pi*i/taps,
    taken in float64 and rounded, as the JAX package's constants."""
    ang = 2.0 * np.pi * np.arange(taps) / taps
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _spiral_table(taps: int, dev: torch.device) -> torch.Tensor:
    """_spiral on the device, copied once (a CPU tensor for the CPU)."""
    return torch.as_tensor(_spiral(taps), device=dev)


def shadow_resolve_plain(world_pos, linear_depth, noise, maps_packed, rows,
                         cascade_count: int, taps: int,
                         sample_radius: float, map_size: int, words=None):
    """Plain version of kernel F: (H, W) f32 shadow factor, the same
    arithmetic and tile-sum order as csrc/shadow.cu (shadow.py:167-295).
    words, a list, receives the flat index into maps_packed of the word
    that every tap inside the map reads (one int64 tensor per cascade and
    tap), for counting the distinct words."""
    _, h, w = world_pos.shape
    win_h, win_w = min(WINDOW_H, map_size), min(WINDOW_W, map_size)
    wx, wy, wz = to_thread_layout(world_pos)
    lin = to_thread_layout(linear_depth)
    nz = to_thread_layout(noise)
    valid = lin > 0.0
    cascade_idx = torch.zeros_like(lin, dtype=torch.int32)
    for c in range(cascade_count - 1):
        cascade_idx = cascade_idx + (lin >= rows[c, 18]).to(torch.int32)
    spiral = _spiral(taps)
    inv_taps = 1.0 / taps
    cn = torch.cos(nz * (2.0 * np.pi))
    sn = torch.sin(nz * (2.0 * np.pi))
    out = torch.ones_like(lin)
    for c in range(cascade_count):
        mask = valid & (cascade_idx == c)
        m = rows[c]
        lx = m[0] * wx + m[1] * wy + m[2] * wz + m[3]
        ly = m[4] * wx + m[5] * wy + m[6] * wz + m[7]
        lz = m[8] * wx + m[9] * wy + m[10] * wz + m[11]
        u = (lx * 0.5 + 0.5) * map_size
        v = (ly * 0.5 + 0.5) * map_size
        count = torch.clamp(mask.sum(dim=(-2, -1), dtype=torch.int32).to(
            torch.float32), min=1.0)
        mean_u = tile_sum(torch.where(mask, u, 0.0)) / count
        mean_v = tile_sum(torch.where(mask, v, 0.0)) / count
        bx = torch.clamp(torch.div(mean_u.to(torch.int32) - win_w // 4, 128,
                                   rounding_mode="floor") * 128,
                         0, map_size - win_w)
        byw = torch.clamp(torch.div(mean_v.to(torch.int32) - win_h // 2, 16,
                                    rounding_mode="floor") * 8,
                          0, (map_size - win_h) // 2)
        by = byw * 2
        bx_t, by_t, byw_t = (t[:, None, None] for t in (bx, by, byw))
        receiver = torch.clamp(lz, 0.0, 1.0)
        lu = u - bx_t.to(torch.float32)
        lv = v - by_t.to(torch.float32)
        off_u = sample_radius * m[16] * 0.5 * map_size
        off_v = sample_radius * m[17] * 0.5 * map_size
        acc = torch.zeros_like(lin)
        maps_c = maps_packed[c].reshape(-1)
        for i in range(taps):
            d = torch.sqrt((i + 0.5 * nz) * inv_taps)
            cb, sb = float(spiral[0, i]), float(spiral[1, i])
            du = (cn * cb - sn * sb) * d * off_u
            dv = (sn * cb + cn * sb) * d * off_v
            sx = torch.round(lu + du).to(torch.int32)
            sy = torch.round(lv + dv).to(torch.int32)
            sxc = torch.clamp(sx, 0, win_w - 1)
            syc = torch.clamp(sy, 0, win_h - 1)
            idx = ((byw_t + (syc >> 1)) * map_size + bx_t + sxc).long()
            word = maps_c[idx]
            half = (word >> ((syc & 1) * 16)) & 0xFFFF
            texel = half.to(torch.float32) * (1.0 / 65535.0)
            inside = ((sx >= -bx_t) & (sy >= -by_t)
                      & (sx < map_size - bx_t) & (sy < map_size - by_t))
            if words is not None:
                words.append((idx + c * maps_c.numel())[mask & inside])
            lit = torch.where(receiver >= texel, 1.0, 0.0)
            acc = acc + torch.where(inside, lit, 1.0)
        out = torch.where(mask, acc * inv_taps, out)
    return from_thread_layout(torch.where(valid, out, 1.0), h, w)


def shadow_resolve(world_pos, linear_depth, noise, shadow_maps,
                   cascade_matrices, cascade_scales, splits,
                   cascade_count: int, taps: int = 12,
                   sample_radius: float = SHADOW_SAMPLE_RADIUS):
    """Per-pixel sun shadow factor (H, W) in [0, 1] (shadow.py:299): the
    maps packed to u16 pairs and the per-cascade rows, then resolve_packed
    (kernel F).

    world_pos (3, H, W); linear_depth (H, W) (<= 0 marks sky, which gets
    1); noise (H, W) per-frame blue noise; shadow_maps (MAX_CASCADES, S, S)
    reverse-Z."""
    if shadow_maps.shape[-1] % 256:
        raise ValueError("u16-pair packing needs 256-texel rows")
    return resolve_packed(
        world_pos, linear_depth, noise,
        pack_shadow_maps_u16(shadow_maps).contiguous(),
        cascade_rows(cascade_matrices, cascade_scales, splits),
        cascade_count, taps, sample_radius)


def resolve_packed(world_pos, linear_depth, noise, maps_packed, rows,
                   cascade_count: int, taps: int = 12,
                   sample_radius: float = SHADOW_SAMPLE_RADIUS):
    """The PCF resolve on u16-packed maps (MAX_CASCADES, S/2, S) i32 and
    cascade rows (MAX_CASCADES, ROW_F) f32 (kernel F, csrc/shadow.cu,
    replaces shadow.py:167 _shadow_resolve_kernel)."""
    dev = world_pos.device
    _, h, w = world_pos.shape
    map_size = maps_packed.shape[-1]
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"({h}, {w}) is not a multiple of the 16x128 tile")
    if not 1 <= cascade_count <= MAX_CASCADES:
        raise ValueError(f"cascade_count {cascade_count} not in [1, 4]")
    for name, t, nd in (("world_pos", world_pos, 3),
                        ("linear_depth", linear_depth, 2),
                        ("noise", noise, 2), ("maps", maps_packed, 3),
                        ("rows", rows, 2)):
        _require(t, name, torch.int32 if name == "maps" else torch.float32,
                 nd, dev)
    if world_pos.shape[0] != 3 or linear_depth.shape != (h, w) \
            or noise.shape != (h, w) or map_size % 256 \
            or maps_packed.shape != (MAX_CASCADES, map_size // 2, map_size) \
            or rows.shape != (MAX_CASCADES, ROW_F):
        raise ValueError("world_pos (3, H, W), linear_depth / noise (H, W), "
                         "packed maps (4, S / 2, S), S a multiple of 256, "
                         "rows (4, 32)")
    if not _kernel_device(world_pos):
        return shadow_resolve_plain(world_pos, linear_depth, noise,
                                    maps_packed, rows, cascade_count, taps,
                                    sample_radius, map_size)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    # the 12-tap kernel takes the spiral by value, read from host memory
    native.launch("shadow_launch", world_pos, linear_depth, noise,
                  maps_packed, rows, _spiral_table(taps, dev),
                  _spiral_table(taps, torch.device("cpu")), out, h, w,
                  map_size, cascade_count, taps, float(sample_radius),
                  float(np.float32(1.0 / taps)))
    return out

