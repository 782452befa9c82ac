"""Motion vectors and the f16-pair history resample of the GI temporal
filter (plainrenderer_tpu/ops/taa.py, the GI part; the TAA resolve itself
is a later slice).

resample_packed_planes is kernel H (csrc/packed_planes.cu) for CUDA
tensors and packed_planes_plain for CPU tensors. Per 16x128 tile both
place a win_h x win_w window of the history (y anchored on the tile, x
around the tile's mean reprojected x, snapped to 128) and tap it
bilinearly; a pixel whose footprint leaves the window gets ok = 0, the
reference's offscreen-reprojection fallback (temporalFilter.comp:166-170).
The tile mean is summed in the kernels' fixed order (ops/texture.py
tile_sum), so the windows agree bit for bit. History words decode with
the in-kernel rule of the JAX package (_unpack_f16_pair_kernel), which
flushes f16 subnormals to zero, not with an f16 view.
"""

from __future__ import annotations

import torch

from .. import native
from .raster import TILE_H, TILE_W, _kernel_device, _require
from .texture import tile_sum, to_thread_layout

WIN_H = 32
WIN_W = 256


def compute_motion(prev_ndc, valid, cur_jitter, prev_jitter, width, height):
    """depthPrepass.frag:33-40 — motion in UV units; uv_last = uv + motion
    (taa.py:53). prev_ndc (2, H, W); jitters in NDC units."""
    _, h, w = prev_ndc.shape
    dev = prev_ndc.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / width \
        * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / height \
        * 2.0 - 1.0
    cur_x = xs[None, :].expand(h, w)
    cur_y = ys[:, None].expand(h, w)
    mx = (prev_ndc[0] + prev_jitter[0] - (cur_x + cur_jitter[0])) * 0.5
    my = (prev_ndc[1] + prev_jitter[1] - (cur_y + cur_jitter[1])) * 0.5
    return torch.where(valid[None], torch.stack([mx, my]), 0.0)


def pack_f16_pair(a, b):
    """Two f32 planes -> one int32 plane (f16 bits lo/hi) (taa.py:248)."""
    fa = a.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    fb = b.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    return fa | (fb << 16)


def unpack_f16_pair(packed):
    """int32 -> (a, b) f32 planes, exact f16 values (taa.py:255)."""
    lo = (packed & 0xFFFF).to(torch.int16).view(torch.float16)
    hi = ((packed >> 16) & 0xFFFF).to(torch.int16).view(torch.float16)
    return lo.to(torch.float32), hi.to(torch.float32)


def _decode_f16_flush(bits16):
    """The in-kernel f16 decode (taa.py:262-274): exponent rebias by
    integer math, subnormals flushed to zero."""
    em = bits16 & 0x7FFF
    mag = ((em << 13) + ((127 - 15) << 23)).view(torch.float32)
    val = torch.where(em >= 0x0400, mag, 0.0)
    return torch.where((bits16 & 0x8000) != 0, -val, val)


def unpack_f16_pair_flush(packed):
    """int32 -> (a, b) f32 planes by the in-kernel decode."""
    return _decode_f16_flush(packed & 0xFFFF), \
        _decode_f16_flush((packed >> 16) & 0xFFFF)


def _tile_to_pixels(v, nty, ntx):
    return v.reshape(nty, 1, ntx, 1).expand(nty, TILE_H, ntx, TILE_W) \
        .reshape(nty * TILE_H, ntx * TILE_W)


def packed_planes_plain(planes, coords):
    """Plain PyTorch version of kernel H (taa.py:277-323): (2P + 1, H, W)
    f32, channels 2p / 2p + 1 the bilinear resample of plane p's lo / hi
    halves, the last channel ok (1 / 0)."""
    n_planes, h, w = planes.shape
    nty, ntx = h // TILE_H, w // TILE_W
    win_h, win_w = min(WIN_H, h), min(WIN_W, w)
    dev = planes.device
    mean_x = tile_sum(to_thread_layout(coords[0])) \
        * (1.0 / (TILE_H * TILE_W))
    ty = torch.arange(nty, device=dev).repeat_interleave(ntx)
    by = torch.clamp(ty * TILE_H - (win_h - TILE_H) // 2, 0, h - win_h)
    bx = torch.clamp(torch.div(mean_x.to(torch.int32) - win_w // 2, 128,
                               rounding_mode="floor") * 128, 0, w - win_w)
    by = _tile_to_pixels(by, nty, ntx)
    bx = _tile_to_pixels(bx, nty, ntx)
    sx = coords[0] - bx.to(torch.float32)
    sy = coords[1] - by.to(torch.float32)
    in_window = ((sx >= 0.5) & (sx <= win_w - 1.5)
                 & (sy >= 0.5) & (sy <= win_h - 1.5))
    x0 = torch.clamp(torch.floor(sx - 0.5), 0, win_w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy - 0.5), 0, win_h - 2).to(torch.int64)
    fx = torch.clamp(sx - 0.5 - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(sy - 0.5 - y0.to(torch.float32), 0.0, 1.0)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    base = (by.to(torch.int64) + y0) * w + bx.to(torch.int64) + x0
    flat = planes.reshape(n_planes, -1)
    taps = [unpack_f16_pair_flush(flat[:, base + off])
            for off in (0, 1, w, w + 1)]
    out = []
    for half in (0, 1):
        (a00, a01, a10, a11) = (tp[half] for tp in taps)
        out.append(a00 * w00 + a01 * w01 + a10 * w10 + a11 * w11)
    chans = torch.stack([out[0], out[1]], dim=1).reshape(2 * n_planes, h, w)
    return torch.cat([chans, in_window.to(torch.float32)[None]])


def resample_packed_planes(planes_packed, motion, width, height):
    """Motion-offset bilinear resample of (P, H, W) int32 f16-pair planes
    (taa.py:327; kernel H, csrc/packed_planes.cu, replaces
    taa.py:277 _packed_planes_tap_kernel). Returns (channels (2P, H, W)
    f32, ok (H, W) bool)."""
    n_planes, h, w = planes_packed.shape
    dev = planes_packed.device
    _require(planes_packed, "planes_packed", torch.int32, 3, dev)
    if motion.shape != (2, h, w) or motion.dtype != torch.float32 \
            or motion.device != dev:
        raise ValueError(f"motion: want (2, {h}, {w}) f32 on {dev}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"({h}, {w}) is not a multiple of the 16x128 tile")
    out = packed_planes(planes_packed,
                        reprojected_coords(motion, width, height))
    return out[:2 * n_planes], out[2 * n_planes] > 0.5


def reprojected_coords(motion, width, height):
    """Absolute pixel coords (2, H, W) at uv + motion, motion in UV units
    of the logical width x height (taa.py:229-237)."""
    _, h, w = motion.shape
    dev = motion.device
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    return torch.stack([xs[None, :].expand(h, w) + motion[0] * width,
                        ys[:, None].expand(h, w) + motion[1] * height])


def packed_planes(planes, coords):
    """Kernel H on CUDA tensors, packed_planes_plain on CPU tensors:
    planes (P, H, W) i32, absolute pixel coords (2, H, W) f32 ->
    (2P + 1, H, W) f32."""
    n_planes, h, w = planes.shape
    if not _kernel_device(planes):
        return packed_planes_plain(planes, coords)
    out = torch.empty((2 * n_planes + 1, h, w), dtype=torch.float32,
                      device=planes.device)
    native.launch("packed_planes_launch", planes, coords.contiguous(), out,
                  n_planes, h, w)
    return out
