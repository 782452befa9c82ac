"""Temporal anti-aliasing, motion vectors, the packed history resamples
and the supersampling pre-pass (plainrenderer_tpu/ops/taa.py).

temporal_filter is temporalFilter.comp: a 3x3 neighbourhood with
jitter-aware resolve weights, motion dilation, AABB clipping of the
history, a contrast-adaptive blend and the reversible luma tonemap. All of
it is plain PyTorch on (3, H, W) planes except the history fetch.

Two kernels fetch history, both per 16x128 tile with a win_h x win_w
window (y anchored on the tile, x around the tile's mean reprojected x,
snapped to 128); a pixel whose footprint leaves the window gets ok = 0,
the reference's offscreen-reprojection fallback
(temporalFilter.comp:166-170). The tile mean is summed in the kernels'
fixed order (ops/texture.py tile_sum), so the windows agree bit for bit.

  - resample_history_taps is kernel I (csrc/history_taps.cu) for CUDA
    tensors and history_taps_plain for CPU tensors: K bilinear taps of the
    R11G11B10 TAA history at per-pixel coords, ok from tap 0 with a
    2.5-texel margin (the widest bicubic pattern);
  - resample_packed_planes is kernel H (csrc/packed_planes.cu) for CUDA
    tensors and packed_planes_plain for CPU tensors: the f16-pair GI
    history. Its words decode with the in-kernel rule of the JAX package
    (_unpack_f16_pair_kernel), which flushes f16 subnormals to zero.

temporal_supersampling (temporalSupersampling.comp) reaches both: I with
one tap on the previous frame's packed colour (history_resample) and H
with one plane, the (luminance, linear depth) f16 pair.
"""

from __future__ import annotations

import torch

from .. import native
from ..utils.color import luminance
from ..utils.stencil import EdgePadded
from .color_packing import pack_r11g11b10, unpack_r11g11b10
from .raster import TILE_H, TILE_W, _kernel_device, _require
from .shadow import linearize_depth
from .texture import tile_sum, to_thread_layout

WIN_H = 32
WIN_W = 256
MAX_TAPS = 16  # kernel I's most taps: tech 1's 4x4 Catmull-Rom footprint
MAX_PLANES = 3  # kernel H's most planes: the GI history's 6 f16 channels


def compute_motion(prev_ndc, valid, cur_jitter, prev_jitter, width, height):
    """depthPrepass.frag:33-40 — motion in UV units; uv_last = uv + motion
    (taa.py:53). prev_ndc (2, H, W); jitters in NDC units. The pixel NDC
    multiplies by the reciprocal of the size, as XLA divides by a
    constant, on every device."""
    _, h, w = prev_ndc.shape
    dev = prev_ndc.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / width) * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / height) * 2.0 - 1.0
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


def _tile_window(x_plane, h, w):
    """Per-pixel window origin (by, bx) of the kernels' tiles
    (taa.py:143-153): by tile-anchored, bx from the tile's mean of
    x_plane, floor-divided to 128 and clamped."""
    nty, ntx = h // TILE_H, w // TILE_W
    win_h, win_w = min(WIN_H, h), min(WIN_W, w)
    mean_x = tile_sum(to_thread_layout(x_plane)) \
        * (1.0 / (TILE_H * TILE_W))
    ty = torch.arange(nty, device=x_plane.device).repeat_interleave(ntx)
    by = torch.clamp(ty * TILE_H - (win_h - TILE_H) // 2, 0, h - win_h)
    bx = torch.clamp(torch.div(mean_x.to(torch.int32) - win_w // 2, 128,
                               rounding_mode="floor") * 128, 0, w - win_w)
    return _tile_to_pixels(by, nty, ntx), _tile_to_pixels(bx, nty, ntx)


def packed_planes_plain(planes, coords):
    """Plain PyTorch version of kernel H (taa.py:277-323): (2P + 1, H, W)
    f32, channels 2p / 2p + 1 the bilinear resample of plane p's lo / hi
    halves, the last channel ok (1 / 0)."""
    n_planes, h, w = planes.shape
    win_h, win_w = min(WIN_H, h), min(WIN_W, w)
    by, bx = _tile_window(coords[0], h, w)
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


def history_resample(history_packed, motion, width, height):
    """One bilinear fetch of packed R11G11B10 colour at uv + motion
    (taa.py:240): kernel I with K = 1. Returns ((3, H, W), ok)."""
    return resample_history_taps(
        history_packed, reprojected_coords(motion, width, height))


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
    (2P + 1, H, W) f32. The kernel takes 1 to MAX_PLANES planes."""
    n_planes, h, w = planes.shape
    if not _kernel_device(planes):
        return packed_planes_plain(planes, coords)
    if not 1 <= n_planes <= MAX_PLANES:
        raise ValueError(f"kernel H takes 1 to {MAX_PLANES} planes, got "
                         f"{n_planes}")
    out = torch.empty((2 * n_planes + 1, h, w), dtype=torch.float32,
                      device=planes.device)
    native.launch("packed_planes_launch", planes, coords.contiguous(), out,
                  n_planes, h, w)
    return out


# --------------------------------------------------------------------------
# kernel I: K bilinear taps of the R11G11B10 TAA history
# --------------------------------------------------------------------------

def history_taps_plain(history, coords):
    """Plain PyTorch version of kernel I (taa.py:134-187): history (H, W)
    int32 R11G11B10, absolute source-pixel coords (2K, H, W) f32 ->
    (3K + 1, H, W) f32, rgb per tap, then ok (1 / 0) from tap 0 with a
    2.5-texel margin. Each tap blends 4 decoded texels at floor(s - 0.5),
    clamped into the window, in the reference's expression order."""
    h, w = history.shape
    n_taps = coords.shape[0] // 2
    win_h, win_w = min(WIN_H, h), min(WIN_W, w)
    by, bx = _tile_window(coords[0], h, w)
    byf, bxf = by.to(torch.float32), bx.to(torch.float32)
    sx0, sy0 = coords[0] - bxf, coords[1] - byf
    margin = 2.5
    in_window = ((sx0 >= margin) & (sx0 <= win_w - margin)
                 & (sy0 >= margin) & (sy0 <= win_h - margin))
    flat = history.reshape(-1)
    origin = by.to(torch.int64) * w + bx.to(torch.int64)
    out = []
    for k in range(n_taps):
        sx = coords[2 * k] - bxf
        sy = coords[2 * k + 1] - byf
        x0 = torch.clamp(torch.floor(sx - 0.5), 0, win_w - 2)
        y0 = torch.clamp(torch.floor(sy - 0.5), 0, win_h - 2)
        fx = torch.clamp(sx - 0.5 - x0, 0.0, 1.0)
        fy = torch.clamp(sy - 0.5 - y0, 0.0, 1.0)
        base = origin + y0.to(torch.int64) * w + x0.to(torch.int64)
        c00, c01, c10, c11 = (unpack_r11g11b10(flat[base + off])
                              for off in (0, 1, w, w + 1))
        out.append(c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
                   + c10 * (1 - fx) * fy + c11 * fx * fy)
    return torch.cat(out + [in_window.to(torch.float32)[None]])


def history_taps(history, coords):
    """Kernel I on CUDA tensors, history_taps_plain on CPU tensors:
    history (H, W) i32, coords (2K, H, W) f32 -> (3K + 1, H, W) f32."""
    h, w = history.shape
    n_taps = coords.shape[0] // 2
    if not _kernel_device(history):
        return history_taps_plain(history, coords)
    out = torch.empty((3 * n_taps + 1, h, w), dtype=torch.float32,
                      device=history.device)
    native.launch("history_taps_launch", history, coords, out, n_taps, h, w)
    return out


def resample_history_taps(history_packed, coords):
    """K bilinear taps of the packed TAA history at per-pixel absolute
    coords (2K, H, W) (taa.py:190; kernel I, csrc/history_taps.cu,
    replaces taa.py:134 _history_tap_kernel). Returns (rgb (3K, H, W),
    ok (H, W) bool)."""
    h, w = history_packed.shape
    dev = history_packed.device
    _require(history_packed, "history_packed", torch.int32, 2, dev)
    _require(coords, "coords", torch.float32, 3, dev)
    n_taps = coords.shape[0] // 2
    if coords.shape != (2 * n_taps, h, w) or not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"coords: want (2K, {h}, {w}) with 1 <= K <= "
                         f"{MAX_TAPS}, got {tuple(coords.shape)}")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"({h}, {w}) is not a multiple of the 16x128 tile")
    out = history_taps(history_packed, coords)
    return out[:3 * n_taps], out[3 * n_taps] > 0.5


# --------------------------------------------------------------------------
# the supersampling pre-pass (temporalSupersampling.comp)
# --------------------------------------------------------------------------

def temporal_supersampling(color, prev_color_packed, prev_lum_depth_packed,
                           motion, depth, near, far, width, height,
                           camera_cut, *, use_tonemapping: bool = True):
    """The optional pre-pass that blends 50% of the reprojected last frame
    into the current one before the main filter (taa.py:375-436,
    TAA.cpp:85-137). Accepts a pixel when the 2x2-block luminance
    contrast difference is < 0.5, the closest-neighbourhood linear depth
    is within 1.0 of the last frame's, both fetches stay in their windows
    and the frame is no camera cut (camera_cut: a 0-d bool tensor, never
    read on the host). Returns (color', luminance of the input colour),
    the luminance for next frame's state."""
    cur_lum = luminance(color)
    motion_d = dilate_motion(motion, depth)
    last_rgb, in_window = history_resample(prev_color_packed, motion_d,
                                           width, height)
    ld, ok2 = resample_packed_planes(prev_lum_depth_packed[None], motion_d,
                                     width, height)
    last_lum, last_lin_depth = ld[0], ld[1]
    cur = _reversible_tonemap(color) if use_tonemapping else color
    last = _reversible_tonemap(last_rgb) if use_tonemapping else last_rgb

    def block(p):  # the 2x2 block (minAbsoluteDifference sums)
        e = EdgePadded(p, 1, 1)
        return [p, e.tap(0, -1), e.tap(-1, 0), e.tap(-1, -1)]

    cur_b, last_b = block(cur_lum), block(last_lum)
    last_max = torch.maximum(
        torch.maximum(torch.abs(last_b[0]), torch.abs(last_b[1])),
        torch.maximum(torch.abs(last_b[2]), torch.abs(last_b[3])))
    contrast = 0  # Python's sum: 0 + the four terms, in order
    for c in cur_b:
        contrast = contrast + (torch.abs(c) - last_max)
    pdep = EdgePadded(depth, 1, 1)
    closest = depth  # reverse-Z: the closest depth is the largest
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            closest = torch.maximum(closest, pdep.tap(dy, dx))
    depth_ok = torch.abs(linearize_depth(closest, near, far)
                         - last_lin_depth) < 1.0
    accept = (contrast < 0.5) & depth_ok & in_window & ok2 & ~camera_cut
    blend = torch.where(accept, 0.5, 0.0)
    out = cur + (last - cur) * blend[None]
    if use_tonemapping:
        out = _reversible_tonemap_inverse(out)
    return torch.where(torch.isnan(out), color, out), cur_lum


# --------------------------------------------------------------------------
# the temporal filter (temporalFilter.comp)
# --------------------------------------------------------------------------

def resolve_weights(jitter_px):
    """TAA.cpp:181-202 — 3x3 gaussian fit of Blackman-Harris around the
    jitter (2,) in pixels; (3, 3) indexed [y, x]."""
    xs = torch.arange(-1, 2, dtype=torch.float32, device=jitter_px.device)
    dx = jitter_px[0] - xs[None, :]
    dy = jitter_px[1] - xs[:, None]
    w = torch.exp(-2.29 * (dx * dx + dy * dy))
    return w / torch.sum(w)


def _neighborhood(color):
    """(C, H, W) -> 9 clamped shifts as [dy + 1][dx + 1] (taa.py:88)."""
    p = EdgePadded(color, 1, 1)
    return [[p.tap(-dy, -dx) for dx in (-1, 0, 1)] for dy in (-1, 0, 1)]


def _fast_recip(x):
    """1/x for x > 0 as rsqrt^2 + one Newton step (taa.py:94), mirrored so
    the port rounds where the JAX package does."""
    r = torch.rsqrt(x)
    r = r * r
    return r * (2.0 - x * r)


def _reversible_tonemap(c):
    """temporalReprojection.inc:37-40."""
    return c * _fast_recip(1.0 + luminance(c)[None])


def _reversible_tonemap_inverse(c):
    """temporalReprojection.inc:42-44."""
    return c * _fast_recip(torch.clamp_min(1.0 - luminance(c)[None], 1e-4))


def dilate_motion(motion, depth):
    """temporalReprojection.inc:70-87 — the motion of the closest (largest
    reverse-Z) depth in the 3x3 neighbourhood."""
    pd = EdgePadded(depth, 1, 1)
    pm = EdgePadded(motion, 1, 1)
    best_depth, best = depth, motion
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d = pd.tap(-dy, -dx)
            best = torch.where((d > best_depth)[None], pm.tap(-dy, -dx), best)
            best_depth = torch.maximum(best_depth, d)
    return best


def _cr_weights(f):
    """Catmull-Rom 1D weights of the 4-texel footprint at fraction f."""
    f2 = f * f
    f3 = f2 * f
    return (-0.5 * f3 + f2 - 0.5 * f, 1.5 * f3 - 2.5 * f2 + 1.0,
            -1.5 * f3 + 2.0 * f2 + 0.5 * f, 0.5 * f3 - 0.5 * f2)


def history_coords(motion, width, height, tech: int):
    """The history sampler's tap coords and weights (taa.py:459-527):
    (coords (2K, H, W), weights) per bicubicSampling.inc variant. tech 0
    bilinear (K = 1), 1 bicubic 16-tap, 2 9-tap, 3 5-tap cross, 4 the CoD
    1-tap at the combined position; weights is a list of (H, W) planes
    for techs 1-3, the 5 cross weights for tech 4 and None for tech 0."""
    base = reprojected_coords(motion, width, height)
    if tech == 0:
        return base, None
    bx, by = base[0], base[1]
    tx = torch.floor(bx - 0.5) + 0.5
    ty = torch.floor(by - 0.5) + 0.5
    w0x, w1x, w2x, w3x = _cr_weights(bx - tx)
    w0y, w1y, w2y, w3y = _cr_weights(by - ty)
    wbx, wby = w1x + w2x, w1y + w2y
    tox = tx + w2x / torch.clamp_min(wbx, 1e-6)
    toy = ty + w2y / torch.clamp_min(wby, 1e-6)
    if tech == 1:  # full 16-tap, on texel centres
        px, py = [tx - 1, tx, tx + 1, tx + 2], [ty - 1, ty, ty + 1, ty + 2]
        wx, wy = [w0x, w1x, w2x, w3x], [w0y, w1y, w2y, w3y]
    elif tech == 2:  # 9-tap, corner-combined bilinear positions
        px, py = [tx - 1, tox, tx + 2], [ty - 1, toy, ty + 2]
        wx, wy = [w0x, wbx, w3x], [w0y, wby, w3y]
    elif tech == 3:  # 5-tap cross, renormalised (Filmic SMAA p.90)
        pts = [(tox, ty - 1, wbx * w0y), (tx - 1, toy, w0x * wby),
               (tox, toy, wbx * wby), (tx + 2, toy, w3x * wby),
               (tox, ty + 2, wbx * w3y)]
        return (torch.cat([torch.stack([p, q]) for p, q, _ in pts]),
                [wk for _, _, wk in pts])
    else:  # tech 4: one tap at the combined position
        return (torch.stack([tox, toy]),
                [w0x * wby, wbx * w0y, wbx * wby, wbx * w3y, w3x * wby])
    n = len(px)
    coords = torch.cat([torch.stack([px[i], py[j]])
                        for j in range(n) for i in range(n)])
    return coords, [wx[i] * wy[j] for j in range(n) for i in range(n)]


def _sample_history(history_packed, motion, width, height, tech: int, nb):
    """bicubicSampling.inc — the 5 history samplers as sets of per-pixel
    bilinear taps of kernel I (taa.py:450): (hist (3, H, W), ok)."""
    coords, weights = history_coords(motion, width, height, tech)
    taps, ok = resample_history_taps(history_packed, coords)
    if tech == 0:
        return taps, ok
    if tech in (1, 2):
        hist = torch.zeros_like(taps[0:3])
        for k, wk in enumerate(weights):
            hist = hist + taps[3 * k:3 * k + 3] * wk[None]
        return hist, ok
    if tech == 3:
        hist = torch.zeros_like(taps[0:3])
        total = torch.zeros_like(taps[0])
        for k, wk in enumerate(weights):
            hist = hist + taps[3 * k:3 * k + 3] * wk[None]
            total = total + wk
        return hist / torch.clamp_min(total, 1e-6)[None], ok
    # tech 4: cross reconstruction from the current frame's neighbourhood
    # (bicubicSampling.inc:151-183)
    wl, wt, wc, wb, wr = weights
    center = nb[1][1]
    total = wl + wt + wc + wb + wr
    hist = ((taps + nb[1][0] - center) * wl[None]
            + (taps + nb[0][1] - center) * wt[None]
            + taps * wc[None]
            + (taps + nb[2][1] - center) * wb[None]
            + (taps + nb[1][2] - center) * wr[None]
            ) / torch.clamp_min(total, 1e-6)[None]
    return hist, ok


def temporal_filter(color, history_packed, motion, depth, jitter_px,
                    camera_cut, width, height, *, use_clipping: bool = True,
                    use_motion_dilation: bool = True,
                    use_tonemapping: bool = True,
                    history_sampling_tech: int = 4):
    """temporalFilter.comp main() (taa.py:544): (output (3, H, W), new
    history (H, W) int32 R11G11B10). camera_cut is a 0-d bool tensor."""
    if use_motion_dilation:
        motion = dilate_motion(motion, depth)
    nb = _neighborhood(_reversible_tonemap(color) if use_tonemapping
                       else color)
    center = nb[1][1]
    weights = resolve_weights(jitter_px)
    resolved = torch.zeros_like(center)
    for y in range(3):
        for x in range(3):
            # resolveColor indexes weights[x][y] (temporalFilter.comp:41-57)
            resolved = resolved + nb[y][x] * weights[x, y]
    nb_min, nb_max = center, center
    for y in range(3):
        for x in range(3):
            nb_min = torch.minimum(nb_min, nb[y][x])
            nb_max = torch.maximum(nb_max, nb[y][x])

    hist_raw, in_window = _sample_history(history_packed, motion, width,
                                          height, history_sampling_tech, nb)
    hist = _reversible_tonemap(hist_raw) if use_tonemapping else hist_raw
    hist_pre_clip = hist  # contrast change is measured unclipped
    if use_clipping:  # clipAABB (temporalReprojection.inc:8-30)
        c = 0.5 * (nb_max + nb_min)
        e = 0.5 * (nb_max - nb_min) + 1e-4
        to_t = hist - c
        max_comp = torch.amax(torch.abs(to_t * _fast_recip(e)), dim=0,
                              keepdim=True)
        hist = torch.where(
            max_comp < 1.0, hist,
            c + to_t * _fast_recip(torch.clamp_min(max_comp, 1e-6)))
    else:
        hist = torch.minimum(torch.maximum(hist, nb_min), nb_max)
    hist = torch.where(torch.isnan(hist), resolved, hist)

    def contrast(n):
        lc = luminance(n[1][1])
        total = torch.zeros_like(lc)
        for y in range(3):
            for x in range(3):
                if x != 1 or y != 1:
                    total = total + torch.abs(luminance(n[y][x]) - lc)
        return total

    contrast_change = torch.clamp(
        torch.abs(contrast(nb) - contrast(_neighborhood(hist_pre_clip))),
        0.0, 1.0)
    blend = 0.13 + (0.03 - 0.13) * contrast_change
    gaussian = ((nb[0][0] + nb[0][2] + nb[2][0] + nb[2][2]) * 0.0625
                + (nb[1][0] + nb[0][1] + nb[1][2] + nb[2][1]) * 0.125
                + nb[1][1] * 0.25)
    blend = torch.where(in_window, blend, 1.0)
    resolved = torch.where(in_window[None], resolved, gaussian)
    blend = torch.where(camera_cut, 1.0, blend)
    out = hist + (resolved - hist) * blend[None]
    if use_tonemapping:
        out = _reversible_tonemap_inverse(out)
    out = torch.clamp_min(out, 0.0)
    return out, pack_r11g11b10(out)
