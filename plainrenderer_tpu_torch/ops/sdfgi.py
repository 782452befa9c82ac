"""SDF-traced diffuse global illumination (plainrenderer_tpu/ops/sdfgi.py).

One cosine-sampled ray per (half-res) pixel from the G-buffer surface,
sphere traced through the composited scene SDF (ops/sdf_scene.py) with
Claybook planar-hit refinement; a hit takes meanAlbedo^2.2 * sun light
behind an SDF shadow march, a miss the low-res sky; the result is stored
as Y * SH_L1(dir) + CoCg (sdfDiffuseTrace.comp:141-209). Then the
normal/depth-guided resolve, the spatial -> temporal -> spatial filter
chain and the depth-aware upscale (filterIndirectDiffuse*.comp,
indirectLightUpscale.comp).

Data layout, as the JAX package's: the global SDF is a pool of 16^3-voxel
bricks of s8 distances, 4 per int32 word ((NB, 8, 128) i32), the albedo a
pool of rgb8 words ((NB, 32, 128) i32), plus a min-pooled whole-scene
coarse volume for rays that leave the fine window.

trace_gi is kernel G (csrc/sdfgi.cu) for CUDA tensors and trace_plain for
CPU tensors. The semantics that decide what a ray sees are the JAX
kernel's, kept exactly:

  - per 16x128 tile the masked mean surface point picks a 2x2x2-brick
    (32^3-voxel) window; the fine march samples only that window
    (clamped), hits count only inside it, and a ray whose fine hit is out
    of reach exits to the coarse march;
  - the tile means are summed in one fixed order (ops/texture.py
    tile_sum: 8 rows per thread in turn, then a halving tree over 256
    threads), so the kernel and the plain version pick the same windows.

The JAX kernel runs each loop while ANY ray of its tile is alive. A dead
ray never changes state and every live ray advances once per iteration,
so a per-ray loop with the same bound (steps, 8, 24, 6) gives the same
result: kernel G loops per ray.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..utils.stencil import EdgePadded, clamped_index
from .raster import TILE_H, TILE_W, _kernel_device, _require
from .texture import tile_sum, to_thread_layout

WINDOW = 32  # voxels per axis of the per-tile trace window (2x2x2 bricks)
BRICK = 16  # voxels per brick axis
_SDF_SCALE = 8.0  # stored = distance / voxel_size * 8 (1/8-voxel precision)
COARSE = 4  # MINIMUM fine voxels per coarse-fallback voxel axis

_INV_2SQRTPI = float(1.0 / (2.0 * np.sqrt(np.pi)))
_SQRT3 = float(np.sqrt(3.0))


def _const(value: float, dev: torch.device) -> torch.Tensor:
    """A 0-d f32 device tensor. Dividing by it is a true division on the
    card, where dividing by a Python number multiplies by its rounded
    reciprocal (the JAX package divides)."""
    return torch.full((), float(value), dtype=torch.float32, device=dev)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / _const(c, x.device)


# --------------------------------------------------------------------------
# data layout
# --------------------------------------------------------------------------

def quantize_sdf_volume(volume: torch.Tensor, voxel_size: float):
    """(D, H, W) f32 world distances (dims multiples of 16) -> brick-pooled
    (NB, 8, 128) int32 (sdfgi.py:50): 16^3-voxel bricks, s8 quantized,
    packed 4 per word along x. Brick (bz * NBY + by) * NBX + bx; in-brick
    word (lz * 16 + ly) * 4 + (lx >> 2)."""
    d, h, w = volume.shape
    assert d % BRICK == 0 and h % BRICK == 0 and w % BRICK == 0
    q = torch.clamp(torch.round(_div(volume, voxel_size) * _SDF_SCALE),
                    -127, 127)
    q = q.to(torch.int32) & 0xFF
    q = q.reshape(d, h, w // 4, 4)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    nbz, nby, nbx = d // BRICK, h // BRICK, w // BRICK
    b = words.reshape(nbz, BRICK, nby, BRICK, nbx, BRICK // 4)
    b = b.permute(0, 2, 4, 1, 3, 5)  # (nbz, nby, nbx, lz, ly, wx)
    return b.reshape(nbz * nby * nbx, 8, 128).contiguous()


def pack_albedo_volume(albedo: torch.Tensor):
    """(D, H, W, 3) f32 -> brick-pooled (NB, 32, 128) int32 rgb8, one word
    per voxel, in-brick word (lz * 16 + ly) * 16 + lx (sdfgi.py:72)."""
    d, h, w = albedo.shape[:3]
    assert d % BRICK == 0 and h % BRICK == 0 and w % BRICK == 0
    q = torch.clamp(torch.round(albedo * 255.0), 0, 255).to(torch.int32)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
    nbz, nby, nbx = d // BRICK, h // BRICK, w // BRICK
    b = words.reshape(nbz, BRICK, nby, BRICK, nbx, BRICK)
    b = b.permute(0, 2, 4, 1, 3, 5)
    return b.reshape(nbz * nby * nbx, 32, 128).contiguous()


def unpack_sdf_volume(bricks: torch.Tensor, dims) -> torch.Tensor:
    """Inverse of quantize_sdf_volume -> (D, H, W) voxel-unit distances
    (plainrenderer_tpu/ops/debugviz.py:30)."""
    d, h, w = (int(x) for x in dims)
    nbz, nby, nbx = d // BRICK, h // BRICK, w // BRICK
    b = bricks.reshape(nbz, nby, nbx, BRICK, BRICK, BRICK // 4)
    words = b.permute(0, 3, 1, 4, 2, 5).reshape(d, h, w // 4)
    vals = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    vals = torch.where(vals > 127, vals - 256, vals).to(torch.float32)
    return vals.reshape(d, h, w) / _SDF_SCALE


def unpack_albedo_volume(bricks: torch.Tensor, dims) -> torch.Tensor:
    """Inverse of pack_albedo_volume -> (3, D, H, W) f32
    (plainrenderer_tpu/ops/debugviz.py:43)."""
    d, h, w = (int(x) for x in dims)
    nbz, nby, nbx = d // BRICK, h // BRICK, w // BRICK
    b = bricks.reshape(nbz, nby, nbx, BRICK, BRICK, BRICK)
    words = b.permute(0, 3, 1, 4, 2, 5).reshape(d, h, w)
    return torch.stack([_div(((words >> (8 * c)) & 0xFF).to(torch.float32),
                             255.0) for c in range(3)])


def coarse_factor_for(dims_zyx: tuple) -> int:
    """The pooling factor that keeps the coarse volume at <= 8192 voxels
    (sdfgi.py:505)."""
    f = COARSE
    d, h, w = dims_zyx
    while (d // f) * (h // f) * (w // f) > 8192 and f < 16:
        f *= 2
    return f


def build_coarse_tables(sdf_packed, albedo_packed, dims_zyx: tuple):
    """Min-pooled whole-scene SDF + mean albedo for the coarse fallback
    march (sdfgi.py:518). Distances are MIN-pooled so the coarse march
    never oversteps geometry the fine grid knows about. Returns
    (coarse_sdf (Rs, 128) i32, coarse_alb (Ra, 128) i32, (cd, ch, cw),
    factor); x is padded to whole words with +max distance."""
    d, h, w = dims_zyx
    f = coarse_factor_for(dims_zyx)
    vol = unpack_sdf_volume(sdf_packed, (d, h, w))
    cd, ch, cw = d // f, h // f, w // f
    vol = vol[:cd * f, :ch * f, :cw * f].reshape(cd, f, ch, f, cw, f)
    coarse = vol.amin(dim=(1, 3, 5))
    q = torch.clamp(torch.round(coarse / f * _SDF_SCALE), -127, 127)
    q = q.to(torch.int32) & 0xFF
    pad_x = (-cw) % 4
    if pad_x:
        q = F.pad(q, (0, pad_x), value=127)
    cw_words = (cw + pad_x) // 4
    q = q.reshape(cd, ch, cw_words, 4)
    words = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
             | (q[..., 3] << 24)).reshape(-1)
    sdf_flat = F.pad(words, (0, (-words.shape[0]) % 128)).reshape(-1, 128)

    alb = unpack_albedo_volume(albedo_packed, (d, h, w))
    alb = alb[:, :cd * f, :ch * f, :cw * f].reshape(3, cd, f, ch, f, cw, f)
    # the mean of each f^3 block, summed one voxel after the other in
    # row-major order: the order of XLA's reduce, so the words are equal
    alb = alb.permute(0, 1, 3, 5, 2, 4, 6).reshape(3, cd, ch, cw, f ** 3)
    total = torch.zeros_like(alb[..., 0])
    for i in range(f ** 3):
        total = total + alb[..., i]
    alb_c = total / float(f ** 3)
    aq = torch.clamp(torch.round(alb_c * 255.0), 0, 255).to(torch.int32)
    awords = (aq[0] | (aq[1] << 8) | (aq[2] << 16)).reshape(-1)
    alb_flat = F.pad(awords, (0, (-awords.shape[0]) % 128)).reshape(-1, 128)
    return (sdf_flat.contiguous(), alb_flat.contiguous(), (cd, ch, cw), f)


# --------------------------------------------------------------------------
# the trace (kernel G and its plain version)
# --------------------------------------------------------------------------

def inverse_voxel(voxel_size: float) -> float:
    """The trace's 1 / voxel: rsqrt(v)^2 plus one Newton step, in float32
    (sdfgi.py:188-190), computed once on the host so that the kernel and
    the plain version multiply by the same number."""
    v = np.float32(voxel_size)
    r = np.float32(1.0) / np.sqrt(v)
    r = r * r
    return float(r * (np.float32(2.0) - v * r))


@functools.lru_cache(maxsize=16)
def _host_meta(voxel_size: float, influence: float, dev: torch.device):
    v = np.float32(voxel_size)
    influence_eff = np.minimum(np.float32(influence),
                               np.float32(WINDOW // 2 - 2) * v)
    vals = [float(v), inverse_voxel(voxel_size), float(influence_eff),
            float(np.float32(influence))]
    return torch.stack([_const(x, dev) for x in vals])


def trace_meta(volume_origin, voxel_size: float, influence: float,
               sun_direction, sun_color, sun_strength) -> torch.Tensor:
    """The 16 f32 scalars of one trace, on the device without a host copy:
    origin xyz, voxel, 1/voxel, fine influence (clamped to the window
    half-extent, sdfgi.py:587-589), full influence, sun direction xyz,
    sun color * strength rgb, 3 zeros."""
    dev = volume_origin.device
    sun_rgb = sun_color.to(torch.float32) * sun_strength.to(torch.float32)
    return torch.cat([volume_origin.to(torch.float32).reshape(3),
                      _host_meta(float(voxel_size), float(influence), dev),
                      sun_direction.to(torch.float32).reshape(3),
                      sun_rgb.reshape(3),
                      torch.zeros(3, dtype=torch.float32, device=dev)])


def _acos_approx(x):
    """Abramowitz-Stegun 4.4.45 polynomial acos (sdfgi.py:90)."""
    ax = torch.abs(x)
    r = torch.sqrt(torch.clamp_min(1.0 - ax, 0.0)) * (
        1.5707288 + ax * (-0.2121144 + ax * (0.0742610 - 0.0187293 * ax)))
    return torch.where(x < 0.0, np.pi - r, r)


def _atan2_approx(y, x):
    """Octant-folded A&S 4.4.49 polynomial atan2 (sdfgi.py:99)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    t = torch.minimum(ax, ay) / torch.clamp_min(torch.maximum(ax, ay), 1e-20)
    t2 = t * t
    a = t * (0.9998660 + t2 * (-0.3302995 + t2 * (
        0.1801410 + t2 * (-0.0851330 + t2 * 0.0208351))))
    a = torch.where(ay > ax, np.pi / 2 - a, a)
    a = torch.where(x < 0.0, np.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def _unpack_s8(word, byte):
    """Signed byte `byte` (a tensor 0..3) of each word, / 8 (sdfgi.py:85)."""
    v = (word >> (8 * byte)) & 0xFF
    return torch.where(v > 127, v - 256, v).to(torch.float32) / _SDF_SCALE


def _per_pixel(tile_vals: torch.Tensor, nty: int, ntx: int) -> torch.Tensor:
    """(nty * ntx,) per-tile values -> (H * W,) per-pixel, row-major."""
    t = tile_vals.reshape(nty, 1, ntx, 1)
    return t.expand(nty, TILE_H, ntx, TILE_W).reshape(-1)


def window_bricks(wpos, valid, meta, dims: tuple):
    """Per 16x128 tile, the base brick (bx0, by0, bz0) of its 2x2x2-brick
    trace window around the masked mean surface point (sdfgi.py:139-158),
    each (n_tiles,) int32. The means are summed in the kernels' fixed
    order."""
    ox, oy, oz, voxel = (meta[i] for i in range(4))
    count = torch.clamp_min(
        tile_sum(to_thread_layout(valid.to(torch.float32))), 1.0)
    masked = torch.where(valid[None], wpos, 0.0)
    out = []
    for plane, o, n in zip(masked, (ox, oy, oz), dims[::-1]):
        c = (tile_sum(to_thread_layout(plane)) / count - o) / voxel
        out.append(torch.clamp(torch.floor((c - 8.0) / BRICK)
                               .to(torch.int32), 0, max(n // BRICK - 2, 0)))
    return out


def trace_plain(wpos, normal, dirs, valid, sky_flat, sdf_packed, alb_packed,
                coarse_sdf, coarse_alb, meta, *, dims: tuple,
                coarse_dims: tuple, coarse_f: int, steps: int, strict: bool,
                use_coarse: bool, sky_h: int, sky_w: int, stats=None):
    """Plain PyTorch version of kernel G (sdfgi.py:112-499): (7, H, W) f32
    = Y*SH_L1 (4), CoCg (2), escaped (1). Every ray is marched by the same
    per-ray rules as the kernel, the loops vectorised over all rays with
    masks; a loop stops once no ray is live, which changes no result.

    stats, a dict, receives the loop counts this frame's rays need: fine /
    coarse march steps taken by live rays, fine / coarse shadow steps up
    to a ray's first occluder (after it the ray stays shadowed, so kernel
    G stops there)."""
    _, h, w = wpos.shape
    nty, ntx = h // TILE_H, w // TILE_W
    _, vh, vw = dims
    nby, nbx = vh // BRICK, vw // BRICK
    ox, oy, oz, voxel, inv_voxel, infl_eff, infl_far = (
        meta[i] for i in range(7))
    sdx, sdy, sdz, sun_r, sun_g, sun_b = (meta[7 + i] for i in range(6))
    i32 = torch.int32

    bx0, by0, bz0 = (_per_pixel(b, nty, ntx) for b in
                     window_bricks(wpos, valid, meta, dims))
    wx0 = (bx0 * BRICK).to(torch.float32)
    wy0 = (by0 * BRICK).to(torch.float32)
    wz0 = (bz0 * BRICK).to(torch.float32)
    sdf_words = sdf_packed.reshape(-1)
    alb_words = alb_packed.reshape(-1)

    def window_coords(px, py, pz, sel):
        """Clamped window voxel of world points (sel: the rays' indices);
        returns the pool brick and in-brick voxel, inside, excess."""
        gxr = (px - ox) * inv_voxel - wx0[sel]
        gyr = (py - oy) * inv_voxel - wy0[sel]
        gzr = (pz - oz) * inv_voxel - wz0[sel]
        gx = torch.clamp(gxr, 0.0, WINDOW - 1.0)
        gy = torch.clamp(gyr, 0.0, WINDOW - 1.0)
        gz = torch.clamp(gzr, 0.0, WINDOW - 1.0)
        ix, iy, iz = gx.to(i32), gy.to(i32), gz.to(i32)
        brick = (((bz0[sel] + (iz >> 4)) * nby + by0[sel] + (iy >> 4)) * nbx
                 + bx0[sel] + (ix >> 4))
        inside = ((gxr >= -0.5) & (gxr <= WINDOW - 0.5)
                  & (gyr >= -0.5) & (gyr <= WINDOW - 0.5)
                  & (gzr >= -0.5) & (gzr <= WINDOW - 0.5))
        excess = torch.maximum(torch.maximum(torch.abs(gxr - gx),
                                             torch.abs(gyr - gy)),
                               torch.abs(gzr - gz))
        return brick, ix & 15, iy & 15, iz & 15, inside, excess

    def sample_sdf(px, py, pz, sel):
        brick, lx, ly, lz, inside, excess = window_coords(px, py, pz, sel)
        flat = brick.long() * 1024 + ((lz * BRICK + ly) * 4 + (lx >> 2))
        v = _unpack_s8(sdf_words[flat], lx & 3)
        return v * voxel, inside, excess

    flat = lambda p: p.reshape(-1)  # noqa: E731
    valid_f = flat(valid)
    wx, wy, wz = (flat(p) for p in wpos)
    nx, ny, nz = (flat(p) for p in normal)
    dx, dy, dz = (flat(p) for p in dirs)

    # ray origin offset along the normal (sdfDiffuseTrace.comp:152)
    px = wx + nx * 0.2
    py = wy + ny * 0.2
    pz = wz + nz * 0.2
    threshold = voxel * 0.43
    t = torch.zeros_like(px)
    d_prev = torch.zeros_like(px)
    d_hit = torch.zeros_like(px)
    dprev_hit = torch.zeros_like(px)
    hit = torch.zeros_like(valid_f)
    exited = torch.zeros_like(valid_f)
    alive = valid_f.clone()
    fine_steps = 0
    # each iteration advances the live rays only (sel); a dead ray's state
    # is never read again except d_hit / dprev_hit, captured at its hit
    for _ in range(steps):
        sel = torch.nonzero(alive).reshape(-1)
        if sel.numel() == 0:
            break
        fine_steps += sel.numel()
        ts = t[sel]
        d, inside, excess = sample_sdf(px[sel] + dx[sel] * ts,
                                       py[sel] + dy[sel] * ts,
                                       pz[sel] + dz[sel] * ts, sel)
        new_hit = inside & (d < threshold)
        exit_now = ~inside & (ts + excess * voxel >= infl_eff)
        d_hit[sel] = torch.where(new_hit, d, d_hit[sel])
        dprev_hit[sel] = torch.where(new_hit, d_prev[sel], dprev_hit[sel])
        hit[sel] = hit[sel] | new_hit
        exited[sel] = exited[sel] | exit_now
        still = ~new_hit & ~exit_now & (ts < infl_eff)
        alive[sel] = still
        step_len = torch.maximum(torch.maximum(torch.abs(d), excess * voxel),
                                 voxel * 0.5)
        t[sel] = torch.where(still, ts + step_len, ts)
        d_prev[sel] = d

    # Claybook planar refinement (SDF.inc:160-168)
    refine = d_hit / torch.clamp_min(1.0 - (d_hit - dprev_hit), 1e-3)
    t_hit = t + torch.where(hit, refine, 0.0)
    if strict:
        hit = hit & (t_hit <= infl_eff)
    hx = px + dx * t_hit
    hy = py + dy * t_hit
    hz = pz + dz * t_hit
    escaped = valid_f & ~hit & ((t >= infl_eff - voxel * 0.25) | exited)

    # albedo at the hit (packed rgb8), hit rays only
    alb = [torch.zeros_like(px) for _ in range(3)]
    sel = torch.nonzero(hit).reshape(-1)
    if sel.numel():
        brick, alx, aly, alz, _, _ = window_coords(hx[sel], hy[sel],
                                                   hz[sel], sel)
        aw = alb_words[brick.long() * 4096
                       + ((alz * BRICK + aly) * BRICK + alx)]
        for k, s in enumerate((0, 8, 16)):
            alb[k][sel] = _div(((aw >> s) & 0xFF).to(torch.float32), 255.0)

    # sun visibility at the hit: 8-step SDF shadow march, hit rays only
    lit = torch.ones_like(px)
    sel = torch.nonzero(hit).reshape(-1)
    shadow_steps = 0
    if sel.numel():
        st = (voxel * 1.5).expand(sel.shape).clone()
        lit_s = torch.ones_like(st)
        for _ in range(8):
            if stats is not None:
                shadow_steps += int((lit_s != 0).sum())
            ds, _, _ = sample_sdf(hx[sel] + sdx * st, hy[sel] + sdy * st,
                                  hz[sel] + sdz * st, sel)
            lit_s = torch.where(ds < threshold * 0.8, 0.0, lit_s)
            st = st + torch.maximum(torch.abs(ds), voxel)
        lit[sel] = lit_s
    coarse_steps = 0
    coarse_shadow_steps = 0

    if use_coarse:
        # escaped rays continue in the whole-scene min-pooled volume up to
        # the FULL influence radius (sdfgi.py:341-439)
        cd, chh, cww = coarse_dims
        cww_words = (cww + 3) // 4
        voxel_c = voxel * float(coarse_f)
        inv_voxel_c = inv_voxel * (1.0 / float(coarse_f))
        csdf = coarse_sdf.reshape(-1)
        calb = coarse_alb.reshape(-1)

        def sample_coarse(qx, qy, qz):
            gx = torch.clamp((qx - ox) * inv_voxel_c, 0.0, cww - 1.0)
            gy = torch.clamp((qy - oy) * inv_voxel_c, 0.0, chh - 1.0)
            gz = torch.clamp((qz - oz) * inv_voxel_c, 0.0, cd - 1.0)
            ix, iy, iz = gx.to(i32), gy.to(i32), gz.to(i32)
            word = csdf[((iz * chh + iy) * cww_words + (ix >> 2)).long()]
            return (_unpack_s8(word, ix & 3) * voxel_c,
                    (iz * chh + iy) * cww + ix)

        thr_c = voxel_c * 0.6
        t2 = t.clone()
        hitc = torch.zeros_like(valid_f)
        alive2 = escaped.clone()
        for _ in range(24):
            sel = torch.nonzero(alive2).reshape(-1)
            if sel.numel() == 0:
                break
            coarse_steps += sel.numel()
            ts = t2[sel]
            dc, _ = sample_coarse(px[sel] + dx[sel] * ts,
                                  py[sel] + dy[sel] * ts,
                                  pz[sel] + dz[sel] * ts)
            new_hit = dc < thr_c
            hitc[sel] = hitc[sel] | new_hit
            still = ~new_hit & (ts < infl_far)
            alive2[sel] = still
            step = torch.maximum(torch.abs(dc) * 0.8, voxel_c * 0.5)
            t2[sel] = torch.where(still, ts + step, ts)
        hit_c = hitc & ~hit
        cx = px + dx * t2
        cy = py + dy * t2
        cz = pz + dz * t2
        sel = torch.nonzero(hitc).reshape(-1)
        if sel.numel():
            _, c_aidx = sample_coarse(cx[sel], cy[sel], cz[sel])
            caw = calb[c_aidx.long()]
            st = (voxel_c * 1.5).expand(sel.shape).clone()
            lit_c = torch.ones_like(st)
            for _ in range(6):
                if stats is not None:
                    coarse_shadow_steps += int((lit_c != 0).sum())
                ds, _ = sample_coarse(cx[sel] + sdx * st, cy[sel] + sdy * st,
                                      cz[sel] + sdz * st)
                lit_c = torch.where(ds < thr_c * 0.8, 0.0, lit_c)
                st = st + torch.maximum(torch.abs(ds), voxel_c)
            take = hit_c[sel]
            for k, s in enumerate((0, 8, 16)):
                a = _div(((caw >> s) & 0xFF).to(torch.float32), 255.0)
                alb[k][sel] = torch.where(take, a, alb[k][sel])
            lit[sel] = torch.where(take, lit_c, lit[sel])
        t_hit = torch.where(hit_c, t2, t_hit)
        hit = hit | hit_c

    # meanAlbedo^2.2 * sun (sdfDiffuseTrace.comp:178)
    hit_rgb = [torch.pow(a, 2.2) * s * lit
               for a, s in zip(alb, (sun_r, sun_g, sun_b))]

    # sky fallback from the low-res sky map (sampleSkyLut, sky.inc:85-93)
    theta = _acos_approx(torch.clamp(-dy, -1.0, 1.0))
    ylut = _div(theta, np.pi) * 2.0 - 1.0
    ylut = torch.sign(ylut) * torch.sqrt(torch.abs(ylut)) * 0.5 + 0.5
    phi = -_atan2_approx(dz, dx)
    xlut = _div(phi, 2.0 * np.pi) + 0.5
    sx = torch.clamp(xlut * sky_w, 0.0, sky_w - 1.0).to(i32)
    sy = torch.clamp(ylut * sky_h, 0.0, sky_h - 1.0).to(i32)
    sky = sky_flat[:, torch.where(valid_f, sy * sky_w + sx, 0).long()]

    self_hit = hit & (t_hit < 1e-4)
    r, g, b = (torch.where(self_hit, 0.0, torch.where(hit, c, sky[k]))
               for k, c in enumerate(hit_rgb))

    # YCoCg + SH_L1(L) projection (sdfDiffuseTrace.comp:205-209)
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    sh0 = torch.full_like(y, _INV_2SQRTPI)
    sh1 = -_SQRT3 * dy * _INV_2SQRTPI
    sh2 = _SQRT3 * dz * _INV_2SQRTPI
    sh3 = -_SQRT3 * dx * _INV_2SQRTPI
    norm = torch.rsqrt(sh0 * sh0 + sh1 * sh1 + sh2 * sh2 + sh3 * sh3 + 1e-20)
    out = torch.stack([y * sh0 * norm, y * sh1 * norm, y * sh2 * norm,
                       y * sh3 * norm, co, cg])
    out = torch.where(valid_f[None], out, 0.0)
    out = torch.cat([out, escaped.to(torch.float32)[None]])
    if stats is not None:
        stats.update(fine_steps=fine_steps, shadow_steps=shadow_steps,
                     coarse_steps=coarse_steps,
                     coarse_shadow_steps=coarse_shadow_steps,
                     rays=int(valid_f.sum()))
    return out.reshape(7, h, w)


def _trace_setup(world_pos, normal, ray_dirs, valid, sky_lowres, sdf_packed,
                 albedo_packed, volume_origin, voxel_size, volume_dims,
                 sun_direction, sun_color, sun_strength, steps, influence,
                 strict, dims_zyx, coarse_fallback, coarse_tables):
    """Check trace_gi's arguments and lay them out for kernel G and its
    plain version: (sky (3, sky_h * sky_w), coarse sdf, coarse albedo,
    meta, static keyword arguments of trace_plain)."""
    dev = world_pos.device
    _, h, w = world_pos.shape
    for name, t in (("world_pos", world_pos), ("normal", normal),
                    ("ray_dirs", ray_dirs)):
        _require(t, name, torch.float32, 3, dev)
        if t.shape != (3, h, w):
            raise ValueError(f"{name}: want (3, {h}, {w}), got "
                             f"{tuple(t.shape)}")
    _require(valid, "valid", torch.bool, 2, dev)
    _require(sdf_packed, "sdf_packed", torch.int32, 3, dev)
    _require(albedo_packed, "albedo_packed", torch.int32, 3, dev)
    if valid.shape != (h, w) or h % TILE_H or w % TILE_W:
        raise ValueError(f"valid (H, W) = ({h}, {w}) in whole 16x128 tiles")
    vd, vh, vw = (int(x) for x in volume_dims)
    if vd % BRICK or vh % BRICK or vw % BRICK or min(vd, vh, vw) < WINDOW:
        raise ValueError(f"volume dims {volume_dims}: whole bricks, at "
                         "least one 32^3 window")
    nb = (vd // BRICK) * (vh // BRICK) * (vw // BRICK)
    if sdf_packed.shape != (nb, 8, 128) or albedo_packed.shape != (nb, 32,
                                                                   128):
        raise ValueError("brick pools do not match the volume dims")
    sky_h, sky_w = sky_lowres.shape[1:]
    sky_flat = sky_lowres.reshape(3, sky_h * sky_w).to(torch.float32)
    use_coarse = coarse_fallback and dims_zyx is not None
    if use_coarse:
        coarse_sdf, coarse_alb, coarse_dims, coarse_f = (
            coarse_tables if coarse_tables is not None
            else build_coarse_tables(sdf_packed, albedo_packed, dims_zyx))
        if coarse_f != coarse_factor_for(tuple(dims_zyx)):
            raise ValueError("coarse tables built for other dims")
    else:
        coarse_sdf = coarse_alb = torch.zeros((1, 128), dtype=torch.int32,
                                              device=dev)
        coarse_dims, coarse_f = (1, 1, 1), COARSE
    meta = trace_meta(volume_origin, voxel_size, influence, sun_direction,
                      sun_color, sun_strength)
    kw = dict(dims=(vd, vh, vw), coarse_dims=tuple(coarse_dims),
              coarse_f=coarse_f, steps=int(steps), strict=bool(strict),
              use_coarse=bool(use_coarse), sky_h=sky_h, sky_w=sky_w)
    return (sky_flat.contiguous(), coarse_sdf.contiguous(),
            coarse_alb.contiguous(), meta, kw)


def trace_gi(world_pos, normal, ray_dirs, valid, sky_lowres, sdf_packed,
             albedo_packed, volume_origin, voxel_size: float,
             volume_dims: tuple, sun_direction, sun_color, sun_strength, *,
             steps: int = 32, influence: float = 8.0, strict: bool = False,
             dims_zyx: tuple | None = None, coarse_fallback: bool = True,
             coarse_tables=None, plain: bool = False, stats=None):
    """Trace one GI ray per pixel (sdfgi.py:562; kernel G, csrc/sdfgi.cu,
    replaces sdfgi.py:112 _trace_kernel).

    Image inputs at trace resolution: world_pos / normal / ray_dirs
    (3, H, W) f32, valid (H, W) bool; sky_lowres (3, sky_h, sky_w) f32;
    sdf_packed (NB, 8, 128) / albedo_packed (NB, 32, 128) i32 bricks of a
    volume of volume_dims (D, H, W) voxels at voxel_size (host float) from
    volume_origin (3,); sun direction / color (3,), strength (). With
    dims_zyx and coarse_fallback, rays that leave the fine window march on
    in the coarse tables (prebuilt, or built here). plain=True runs the
    plain version on any device, for holding kernel G to it; stats as for
    trace_plain. Returns (Y_SH (4, H, W), CoCg (2, H, W), escaped (H, W)
    f32 0/1)."""
    sky, c_sdf, c_alb, meta, kw = _trace_setup(
        world_pos, normal, ray_dirs, valid, sky_lowres, sdf_packed,
        albedo_packed, volume_origin, voxel_size, volume_dims,
        sun_direction, sun_color, sun_strength, steps, influence, strict,
        dims_zyx, coarse_fallback, coarse_tables)
    if plain or not _kernel_device(world_pos):
        out = trace_plain(world_pos, normal, ray_dirs, valid, sky,
                          sdf_packed, albedo_packed, c_sdf, c_alb, meta,
                          stats=stats, **kw)
    else:
        if sdf_packed.data_ptr() % 16:
            raise ValueError("sdf_packed must be 16-byte aligned (the "
                             "kernel stages bricks as int4)")
        _, h, w = world_pos.shape
        out = torch.empty((7, h, w), dtype=torch.float32,
                          device=world_pos.device)
        native.launch("sdfgi_trace_launch", world_pos, normal, ray_dirs,
                      valid, sky, sdf_packed, albedo_packed, c_sdf, c_alb,
                      meta, out, h, w, *kw["dims"], *kw["coarse_dims"],
                      kw["coarse_f"], kw["steps"], int(kw["strict"]),
                      int(kw["use_coarse"]), kw["sky_h"], kw["sky_w"])
    return out[0:4], out[4:6], out[6]


# --------------------------------------------------------------------------
# filters (plain PyTorch)
# --------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def neighborhood_resolve(y_sh, cocg, normal, lin_depth):
    """sdfDiffuseTrace.comp:66-116 — 3x3 normal/depth-guided gaussian over
    the per-ray results (sdfgi.py:689)."""
    pn = EdgePadded(normal, 1, 1)
    pd = EdgePadded(lin_depth, 1, 1)
    py = EdgePadded(y_sh, 1, 1)
    pc = EdgePadded(cocg, 1, 1)
    acc_y = y_sh
    acc_c = cocg
    total = torch.ones_like(lin_depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            non = _dot3(normal, pn.tap_fwd(dy, dx))
            ok = (non > 0.9) & (torch.abs(lin_depth - pd.tap_fwd(dy, dx))
                                < 0.5)
            wgt = (1.0 if dy == 0 else 0.5) * (1.0 if dx == 0 else 0.5)
            wm = torch.where(ok, wgt, 0.0)
            acc_y = acc_y + py.tap_fwd(dy, dx) * wm[None]
            acc_c = acc_c + pc.tap_fwd(dy, dx) * wm[None]
            total = total + wm
    return acc_y / total[None], acc_c / total[None]


_SPATIAL_TAPS = 16
_SPATIAL_ROTATIONS = 4  # per-frame spiral rotation sets
_SPATIAL_NOMINAL_R = 16.0  # outermost-tap radius in pixels
_GOLDEN_ANGLE = 2.39996323


def _spiral_offsets(seed: int, rotation: int):
    """Integer spiral tap offsets (dy, dx) (sdfgi.py:721)."""
    rot = rotation * (2.0 * math.pi / (_SPATIAL_ROTATIONS * _SPATIAL_TAPS))
    offs = []
    for i in range(_SPATIAL_TAPS):
        frac = (i + 0.5) / _SPATIAL_TAPS
        ang = i * _GOLDEN_ANGLE + seed * 1.7 + rot
        r = math.sqrt(frac) * _SPATIAL_NOMINAL_R
        dx = int(round(math.cos(ang) * r))
        dy = int(round(math.sin(ang) * r))
        if dx == 0 and dy == 0:
            dx = 1
        offs.append((dy, dx))
    return offs


def spatial_tap_table(seed: int, h: int, w: int) -> np.ndarray:
    """(4, 16, 3) f32: per rotation and tap (dy, dx, |offset|), the offsets
    clamped to the plane size (sdfgi.py:681) and the radius rounded to f32
    as the JAX package's static float is."""
    table = np.zeros((_SPATIAL_ROTATIONS, _SPATIAL_TAPS, 3), np.float32)
    for k in range(_SPATIAL_ROTATIONS):
        for i, (dy, dx) in enumerate(_spiral_offsets(seed, k)):
            dy = max(-(h - 1), min(h - 1, dy))
            dx = max(-(w - 1), min(w - 1, dx))
            table[k, i] = (dy, dx, float(np.hypot(dx, dy)))
    return table


@functools.lru_cache(maxsize=16)
def _tap_table(seed: int, h: int, w: int, dev: torch.device) -> torch.Tensor:
    """spatial_tap_table on the device, copied once per shape."""
    return torch.as_tensor(spatial_tap_table(seed, h, w), device=dev)


def spatial_filter(y_sh, cocg, normal, world_pos, lin_depth, frame_index,
                   radius_world: float, proj_scale: float, seed: int):
    """filterIndirectDiffuseSpatial.comp — tangent-plane-weighted disc blur
    with 16 spiral taps (sdfgi.py:742).

    The JAX package picks one of 4 rotations with lax.switch on
    frame_index % 4; here frame_index stays on the device: the rotation's
    row of a (4, 16, 3) tap table is picked with index_select, and each
    tap reads clamped row/column indices (clamp-to-edge, as EdgePadded).
    Accumulation order as the reference: taps in turn, then + y_sh, then
    / total."""
    h, w = lin_depth.shape
    dev = lin_depth.device
    # a tensor numerator: `number / tensor` multiplies by the reciprocal
    radius_px = torch.clamp(
        torch.full_like(lin_depth, radius_world * proj_scale)
        / torch.clamp_min(lin_depth, 0.5), 1.0, 24.0)
    row = torch.index_select(_tap_table(seed, h, w, dev), 0,
                             (frame_index % _SPATIAL_ROTATIONS).reshape(1)
                             .long())[0]
    offs = row[:, :2].long()
    rows = torch.clamp(torch.arange(h, device=dev)[None] + offs[:, 0:1], 0,
                       h - 1)
    cols = torch.clamp(torch.arange(w, device=dev)[None] + offs[:, 1:2], 0,
                       w - 1)
    planes = torch.cat([world_pos, y_sh, cocg])
    quarter = torch.full_like(radius_px, 0.25)
    acc_y = torch.zeros_like(y_sh)
    acc_c = torch.zeros_like(cocg)
    total = torch.zeros_like(radius_px)
    for i in range(_SPATIAL_TAPS):
        tap = planes.index_select(1, rows[i]).index_select(2, cols[i])
        dist_plane = torch.abs(_dot3(normal, tap[0:3] - world_pos))
        wt = torch.clamp(quarter / torch.clamp_min(dist_plane, 1e-4),
                         0.0, 1.0)
        wt = wt * wt
        # per-pixel radius: taps beyond radius_px fade to zero
        fade = torch.clamp(radius_px / row[i, 2], 0.0, 1.0)
        wt = wt * (fade * fade)
        acc_y = acc_y + tap[3:7] * wt[None]
        acc_c = acc_c + tap[7:9] * wt[None]
        total = total + wt
    acc_y = acc_y + y_sh
    acc_c = acc_c + cocg
    total = total + 1.0
    return acc_y / total[None], acc_c / total[None]


def temporal_filter_gi(y_sh, cocg, hist_y_sh, hist_cocg, ok, motion_mag_px,
                       camera_cut):
    """filterIndirectDiffuseTemporal.comp — EMA alpha 0.8 -> 0.6 with the
    motion-difference metric and the > 3 px fast-motion path
    (sdfgi.py:804). History arrives reprojected (ok = reprojection
    valid); camera_cut may be a 0-d device bool."""
    cur_len = torch.sqrt(y_sh[0] * y_sh[0] + y_sh[1] * y_sh[1]
                         + y_sh[2] * y_sh[2] + y_sh[3] * y_sh[3])
    hist_len = torch.sqrt(hist_y_sh[0] * hist_y_sh[0]
                          + hist_y_sh[1] * hist_y_sh[1]
                          + hist_y_sh[2] * hist_y_sh[2]
                          + hist_y_sh[3] * hist_y_sh[3])
    alpha_min = torch.clamp_min(0.6 - 0.3 * torch.abs(cur_len - hist_len),
                                0.0)
    alpha = torch.where(motion_mag_px > 3.0, alpha_min, 0.8)
    alpha = torch.where(ok, alpha, 0.0)
    alpha = torch.where(camera_cut, 0.0, alpha)
    out_y = y_sh + (hist_y_sh - y_sh) * alpha[None]
    out_c = cocg + (hist_cocg - cocg) * alpha[None]
    out_y = torch.where(torch.isnan(out_y), 0.0, out_y)
    out_c = torch.where(torch.isnan(out_c), 0.0, out_c)
    return out_y, out_c


def _shift(p, dy: int, dx: int):
    """out[y, x] = in_clamped[y + dy, x + dx] (sdfgi.py:672)."""
    h, w = p.shape[-2:]
    rows = clamped_index(h, dy, h + dy, p.device)
    cols = clamped_index(w, dx, w + dx, p.device)
    return p.index_select(-2, rows).index_select(-1, cols)


def _up2(p):
    return torch.repeat_interleave(torch.repeat_interleave(p, 2, dim=-2), 2,
                                   dim=-1)


def upscale_half_to_full(y_sh_half, cocg_half, depth_full, depth_half,
                         near, far):
    """indirectLightUpscale.comp — depth-aware 2x upscale: the nearest-depth
    half-res texel on edges, bilinear elsewhere (sdfgi.py:825).

    The bilinear path resizes the (padded) half-res planes to the full
    planes' size, as the JAX package's jax.image.resize does: where the
    padded half-res width is not half the full width, x is scaled by their
    ratio, not by 2 (a reference behaviour, kept)."""
    from .shadow import linearize_depth

    lin_full = linearize_depth(depth_full, near, far)
    lin_half = linearize_depth(depth_half, near, far)
    fh, fw = lin_full.shape
    cands = [(_shift(lin_half, dy, dx), _shift(y_sh_half, dy, dx),
              _shift(cocg_half, dy, dx)) for dy in (0, 1) for dx in (0, 1)]
    diffs = [torch.abs(_up2(c[0])[:fh, :fw] - lin_full) for c in cands]
    is_edge = torch.zeros_like(lin_full, dtype=torch.bool)
    for d in diffs:
        is_edge = is_edge | (d > 0.5)
    best = torch.argmin(torch.stack(diffs), dim=0)
    near_y = torch.zeros((4, fh, fw), dtype=torch.float32,
                         device=lin_full.device)
    near_c = torch.zeros((2, fh, fw), dtype=torch.float32,
                         device=lin_full.device)
    for i, (_, ys, cs) in enumerate(cands):
        sel = (best == i)[None]
        near_y = torch.where(sel, _up2(ys)[:, :fh, :fw], near_y)
        near_c = torch.where(sel, _up2(cs)[:, :fh, :fw], near_c)
    bil_y = F.interpolate(y_sh_half[None], size=(fh, fw), mode="bilinear",
                          align_corners=False)[0]
    bil_c = F.interpolate(cocg_half[None], size=(fh, fw), mode="bilinear",
                          align_corners=False)[0]
    return (torch.where(is_edge[None], near_y, bil_y),
            torch.where(is_edge[None], near_c, bil_c))
