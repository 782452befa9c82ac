"""Debug views (plainrenderer_tpu/ops/debugviz.py).

Three views the frame draws when their settings ask for them:
  - SDF visualisation modes 1-4 (sdf_debug.visualisation_mode,
    sdfDebugVisualisation.comp:104-133): a sphere trace of camera rays
    through the scene SDF at half resolution, replacing the final image:
      1 = lit SDF (albedo * (ambient 0.15 + sun * NoL)), sky on miss
      2 = the fraction of each 16x128 tile's rays that leave one 32^3 trace
          window around the tile's mean hit (red = the whole tile escapes)
      3 = hit normals * 0.5 + 0.5
      4 = raymarch steps / 128
  - the sun-cascade tint (shadows.debug_cascade_colors,
    sunShadowCascades.inc:23-31): red / green / blue / yellow by the
    pixel's cascade;
  - object AABB wireframes (draw_bounding_boxes, debug.vert +
    RenderFrontend.cpp:947-956): each box edge point-sampled, projected
    and scattered into the tonemapped image.

Plain PyTorch: debug tools, not the frame's hot path. Each keeps to
tensor ops on the device (no host synchronisation); the trace's 96 steps
are a Python loop of eager ops. The dense volumes come from the brick
pools through ops/sdfgi.unpack_sdf_volume and unpack_albedo_volume.
"""

from __future__ import annotations

import torch

from . import sky as sky_ops
from .raster import TILE_H, TILE_W
from .sdfgi import unpack_albedo_volume, unpack_sdf_volume

CASCADE_DEBUG_COLORS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        (0.0, 0.0, 1.0), (1.0, 1.0, 0.0))
# the 12 edges of a box as pairs of its corners (bit a of a corner index
# picks max over min on axis a)
_BOX_EDGES = ((0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
              (3, 7), (4, 5), (4, 6), (5, 7), (6, 7))


def _sample(volume, x, y, z):
    """Point-sample (D, H, W) at voxel coords (truncated, clamped); x, y,
    z any one shape (debugviz.py:54)."""
    d, h, w = volume.shape
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    zi = torch.clamp(z.to(torch.int32), 0, d - 1).long()
    return volume[zi, yi, xi]


def trace_primary(volume, origin_world, dirs, volume_origin, voxel: float,
                  steps: int = 96, t_max: float = 100.0) -> dict:
    """Sphere-trace camera rays through the dense SDF volume
    (debugviz.py:63). dirs (3, H, W) unit; returns t (world units), hit
    (bool), steps (f32), hit_voxel (3, H, W) voxel coords and normal
    (3, H, W)."""
    ox = (origin_world[0] - volume_origin[0]) / voxel
    oy = (origin_world[1] - volume_origin[1]) / voxel
    oz = (origin_world[2] - volume_origin[2]) / voxel
    shape = dirs.shape[1:]
    dev = dirs.device
    t = torch.zeros(shape, dtype=torch.float32, device=dev)
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    nsteps = torch.zeros(shape, dtype=torch.float32, device=dev)
    threshold = 0.43  # voxel units (SDF.inc:131 analog)
    t_max_vox = t_max / voxel
    for _ in range(steps):
        dist = _sample(volume, ox + dirs[0] * t, oy + dirs[1] * t,
                       oz + dirs[2] * t)
        hit = hit | ((dist < threshold) & (t > 0))
        alive = ~hit & (t < t_max_vox)
        t = torch.where(alive, t + torch.clamp_min(torch.abs(dist), 0.5), t)
        nsteps = nsteps + alive.to(torch.float32)
    hx, hy, hz = ox + dirs[0] * t, oy + dirs[1] * t, oz + dirs[2] * t
    eps = 1.0
    nx = _sample(volume, hx + eps, hy, hz) - _sample(volume, hx - eps, hy, hz)
    ny = _sample(volume, hx, hy + eps, hz) - _sample(volume, hx, hy - eps, hz)
    nz = _sample(volume, hx, hy, hz + eps) - _sample(volume, hx, hy, hz - eps)
    inv = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-12))
    return {"t": t * voxel, "hit": hit, "steps": nsteps,
            "hit_voxel": torch.stack([hx, hy, hz]),
            "normal": torch.stack([nx * inv, ny * inv, nz * inv])}


def _resize_nearest(color, height: int, width: int):
    """jax.image.resize(..., method="nearest") of (3, h, w): source index
    floor((i + 0.5) * in / out), here in exact integers."""
    _, h, w = color.shape
    dev = color.device
    rows = (2 * torch.arange(height, device=dev) + 1) * h // (2 * height)
    cols = (2 * torch.arange(width, device=dev) + 1) * w // (2 * width)
    return color.index_select(1, rows).index_select(2, cols)


def sdf_debug_image(mode: int, scene: dict, cam: dict, sky_lut,
                    transmission_lut, sun_dir, sun_color, sun_strength,
                    width: int, height: int, tan_fov_half: float,
                    aspect: float, quarter: int = 2, steps: int = 96):
    """(3, height, width) debug colour in [0, ~1] for SDF visualisation
    modes 1-4 (debugviz.py:109), traced at 1/quarter resolution."""
    dims = scene["sdf_grid"]
    volume = unpack_sdf_volume(scene["sdf_volume"], dims)
    albedo = unpack_albedo_volume(scene["sdf_albedo"], dims)
    voxel = scene["sdf_voxel_size"]
    h, w = height // quarter, width // quarter
    dirs = sky_ops.view_directions(w, h, cam["forward"], cam["up"],
                                   cam["right"], tan_fov_half, aspect)
    res = trace_primary(volume, cam["position"], dirs, scene["sdf_origin"],
                        voxel, steps=steps)
    hit = res["hit"]
    if mode == 3:
        color = torch.where(hit[None], res["normal"] * 0.5 + 0.5, 0.0)
    elif mode == 4:
        color = (res["steps"] / 128.0)[None].expand(3, h, w)
    elif mode == 2:
        th, tw = max(h // TILE_H, 1), max(w // TILE_W, 1)
        hv = res["hit_voxel"][:, :th * TILE_H, :tw * TILE_W]
        tiles = hv.reshape(3, th, TILE_H, tw, TILE_W)
        mask = hit[:th * TILE_H, :tw * TILE_W].reshape(
            th, TILE_H, tw, TILE_W).to(torch.float32)
        cnt = torch.clamp_min(mask.sum(dim=(1, 3)), 1.0)
        mean = (tiles * mask[None]).sum(dim=(2, 4)) / cnt[None]
        span = torch.abs(tiles - mean[:, :, None, :, None])
        escaped = (torch.amax(span, dim=0) > 16.0).to(torch.float32) * mask
        frac = escaped.sum(dim=(1, 3)) / cnt  # (th, tw)
        fimg = frac.repeat_interleave(TILE_H, 0).repeat_interleave(TILE_W, 1)
        fimg = torch.nn.functional.pad(
            fimg, (0, w - fimg.shape[1], 0, h - fimg.shape[0]))
        red = (fimg >= 1.0).to(torch.float32)
        color = torch.stack([torch.maximum(fimg, red), fimg * (1 - red),
                             fimg * (1 - red)])
    else:  # mode 1: lit SDF
        hv = res["hit_voxel"]
        alb = torch.stack([_sample(albedo[c], hv[0], hv[1], hv[2])
                           for c in range(3)])
        n = res["normal"]
        nol = torch.clamp(n[0] * sun_dir[0] + n[1] * sun_dir[1]
                          + n[2] * sun_dir[2], 0.0, 1.0)
        lit = alb * (0.15 + nol[None] * sun_strength
                     * sun_color.reshape(3, 1, 1))
        color = torch.where(hit[None], lit, 0.0)
    if mode != 2:  # sky on miss (mode 2 draws everywhere, as the reference)
        sky_col = sky_ops.apply_sky(
            torch.zeros((3, h, w), dtype=torch.float32, device=dirs.device),
            hit, sky_lut, transmission_lut, dirs, sun_dir, sun_strength)
        color = torch.where(hit[None], color, sky_col)
    return _resize_nearest(color, height, width)


def cascade_debug_tint(hdr, cascade_idx, cascade_count: int):
    """Tint the lit colour by cascade index (debugviz.py:179); -1 (no
    geometry) keeps half the colour."""
    channels = []
    for k in range(3):
        tint = torch.zeros_like(hdr[k])
        for c in range(cascade_count):
            tint = torch.where(cascade_idx == c, CASCADE_DEBUG_COLORS[c][k],
                               tint)
        channels.append(tint)
    return hdr * (0.5 + 0.5 * torch.stack(channels))


def aabb_line_overlay(image_u8, bb_min, bb_max, view_proj, width: int,
                      height: int, color=(255, 255, 0),
                      samples_per_edge: int = 256):
    """Draw object AABB wireframes over the tonemapped (H, W, 3) u8 image
    (debugviz.py:190): each box edge sampled at samples_per_edge points,
    projected by view_proj (4, 4) with XLA:CPU's dot rounding
    (utils/mathutils.fma_matmul), floored to pixels and scattered."""
    from ..utils.mathutils import fma_matmul

    dev = bb_min.device
    corners = torch.stack([
        torch.stack([bb_max[:, a] if (c >> a) & 1 else bb_min[:, a]
                     for a in range(3)], dim=-1)
        for c in range(8)], dim=1)  # (O, 8, 3)
    p0 = corners[:, [e[0] for e in _BOX_EDGES]].reshape(-1, 3)
    p1 = corners[:, [e[1] for e in _BOX_EDGES]].reshape(-1, 3)
    t = (torch.arange(samples_per_edge, dtype=torch.float32, device=dev)
         + 0.5) / samples_per_edge
    pts = (p0[:, None] + (p1 - p0)[:, None] * t[:, None]).reshape(-1, 3)
    clip = fma_matmul(pts, view_proj[:3, :3].T) + view_proj[:3, 3]
    w = fma_matmul(pts, view_proj[3, :3, None])[:, 0] + view_proj[3, 3]
    okw = w > 1e-6
    ndc = clip[:, :2] / torch.where(okw, w, 1.0)[:, None]
    px = ((ndc[:, 0] * 0.5 + 0.5) * width).to(torch.int32)
    py = ((ndc[:, 1] * 0.5 + 0.5) * height).to(torch.int32)
    ok = okw & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    # rejected points land on pixel (0, 0) and add nothing
    idx = torch.where(ok, py * width + px, 0).long()
    hits = torch.zeros(height * width, dtype=torch.int32, device=dev)
    hits.index_add_(0, idx, ok.to(torch.int32))
    col = torch.zeros_like(image_u8[0, 0])
    for k in range(3):
        col[k] = color[k]
    return torch.where(hits.reshape(height, width, 1) > 0, col, image_u8)
