"""Bloom: the CoD:AW mip-chain downsample / upsample and the lerp apply
(plainrenderer_tpu/ops/bloom.py; bloomDownsample.comp,
bloomUpsample.comp, applyBloom.comp, Bloom.cpp:56-144).

Every tap is a fixed-offset bilinear fetch at a multiple of half a texel,
so each pattern expands into integer-offset weights on the edge-clamped
source and is one weighted-sum stencil. The pyramid runs in bf16 as the
JAX package's, every product and sum rounded to bf16, as XLA on the CPU
rounds the JAX package's bf16 ops, with one exception found by
comparing the two: the last sum of the chain (mip 0's tent + previous
mip), which XLA keeps in f32 because the bloom is cast to f32 right
after it. The weights are sums of a few powers of two, exact in bf16, so
a tap's product is exact and only the sums round.

compute_bloom_banded is the split-frame band mode's bloom: each band's
mips 1-2 from an 8-row halo, mip 2 gathered whole, the coarse chain on
every band, the band's rows recomposed at the end.
"""

from __future__ import annotations

import math

import torch

from ..utils.stencil import EdgePadded, clamped_index, point_downsample


def _expand_taps(taps):
    """[((dy, dx), w)] with half-texel offsets -> {(sy, sx): weight} on
    integer offsets: bilinear at multiples of 0.5 is exact averaging, and
    duplicate offsets merge (bloom.py:19)."""
    def axis_samples(d):
        d = float(d)
        lo = math.floor(d)
        frac = d - lo
        if frac == 0.0:
            return [(lo, 1.0)]
        return [(lo, 1.0 - frac), (lo + 1, frac)]

    merged = {}
    for (dy, dx), weight in taps:
        for sy, wy in axis_samples(dy):
            for sx, wx in axis_samples(dx):
                merged[(sy, sx)] = merged.get((sy, sx), 0.0) + weight * wy * wx
    return merged


def _stencil(img, merged_taps, stride: int = 1):
    """Integer-offset weighted-sum taps on the edge-clamped bf16 image
    (correlation orientation, bloom.py:43) in the reference's order,
    optionally point-subsampled. Weights are rounded to bf16 as the
    reference casts them."""
    offs = list(merged_taps.items())
    my = min(max(abs(sy) for (sy, _), _ in offs), img.shape[-2] - 1)
    mx = min(max(abs(sx) for (_, sx), _ in offs), img.shape[-1] - 1)
    p = EdgePadded(img, my, mx)
    out = None
    for (sy, sx), wt in offs:
        w16 = float(torch.tensor(wt, dtype=torch.bfloat16))
        term = p.tap_fwd(max(min(sy, my), -my), max(min(sx, mx), -mx)) * w16
        out = term if out is None else out + term
    if stride != 1:
        out = point_downsample(out, stride, stride)
    return out


_DOWN_TAPS = _expand_taps([
    ((dy + 0.5, dx + 0.5), weight) for (dy, dx), weight in [
        ((0.0, 0.0), 0.125),
        ((0.5, 0.5), 0.125), ((0.5, -0.5), 0.125),
        ((-0.5, 0.5), 0.125), ((-0.5, -0.5), 0.125),
        ((0.0, 1.5), 0.0625), ((0.0, -1.5), 0.0625),
        ((1.5, 0.0), 0.0625), ((-1.5, 0.0), 0.0625),
        ((1.5, 1.5), 0.03125), ((1.5, -1.5), 0.03125),
        ((-1.5, 1.5), 0.03125), ((-1.5, -1.5), 0.03125)]])
_BOX_TAPS = _expand_taps([((0.5, 0.5), 0.25), ((0.5, -0.5), 0.25),
                          ((-0.5, 0.5), 0.25), ((-0.5, -0.5), 0.25)])


def downsample_13tap(src):
    """bloomDownsample.comp — half-resolution 13-tap downsample of
    (C, H, W): the destination texel's centre lies between 4 source
    texels, so the pattern runs at +0.5 on the source grid, strided."""
    return _stencil(src, _DOWN_TAPS, stride=2)


def tent9(src, blur_radius: float):
    """bloomUpsample.comp taps 1-9 — 9-tap tent blur at src's own
    resolution."""
    r = blur_radius
    return _stencil(src, _expand_taps([
        ((0.0, 0.0), 0.25),
        ((0.0, r), 0.125), ((0.0, -r), 0.125),
        ((r, 0.0), 0.125), ((-r, 0.0), 0.125),
        ((r, r), 0.0625), ((r, -r), 0.0625),
        ((-r, r), 0.0625), ((-r, -r), 0.0625)]))


def _box_upsample(src, out_h: int, out_w: int):
    """2x bilinear upsample at the quarter-texel target phases: nearest
    repeat, then a symmetric half-texel box."""
    up = src.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return _stencil(up[:, :out_h, :out_w], _BOX_TAPS)


def compute_bloom(color, strength: float, blur_radius: float,
                  mip_count: int):
    """Bloom.cpp:56-144 (bloom.py:189) — color (3, H, W) -> bloomed.

    Each upsample pass targets mip T from downscale mip T + 1 (9-tap tent)
    plus the previous upsampled mip (repeated box), all at full weight;
    mip 0 of the bloom texture has no direct full-resolution scene term."""
    mips = [color.to(torch.bfloat16)]
    for _ in range(mip_count - 1):
        if mips[-1].shape[-1] < 4 or mips[-1].shape[-2] < 4:
            break
        mips.append(downsample_13tap(mips[-1]))
    if len(mips) == 1:
        return color
    prev = None
    for target in range(len(mips) - 2, -1, -1):
        h, w = mips[target].shape[-2:]
        out = _box_upsample(tent9(mips[target + 1], blur_radius), h, w)
        if prev is not None:
            up = _box_upsample(prev, h, w)
            out = (out.float() + up.float() if target == 0 else out + up)
        prev = out
    bloom = prev.to(torch.float32)
    return color + (bloom - color) * strength


def compute_bloom_banded(color, strength: float, blur_radius: float,
                         mip_count: int, group, halo_extend_fn):
    """Split-frame bloom (bloom.py:123-186): color (3, hb, W) is one band
    of the frame, group a comm.BandGroup, halo_extend_fn(x, n) the band's
    halo exchange. Mips 1 and 2 run on the band from an 8-row halo (every
    band row of mip 2 then equals the frame's), the bands' mip 2 rows are
    gathered into the frame's mip 2, mips 3+ and the upsample chain down
    to mip 1 run on every band, and the band's final rows are recomposed
    from its halo'd mip 1 and its rows of the frame's upsampled mip 1
    (edge-padded by one row at the frame's top and bottom, as the
    stencils clamp). Under the JAX package's conditions (one band, at most
    two mips, a band height not a multiple of 16, blur_radius past the
    fixed halo's reach) it is compute_bloom on the band."""
    hb, w = color.shape[-2:]
    if group.size <= 1 or mip_count <= 2 or hb % 16 != 0 \
            or blur_radius > 2.5:
        return compute_bloom(color, strength, blur_radius, mip_count)
    ext = halo_extend_fn(color, 8).to(torch.bfloat16)  # (3, hb + 16, w)
    m1e = downsample_13tap(ext)  # mip-1 rows [-4, hb / 2 + 4)
    m2e = downsample_13tap(m1e)  # mip-2 rows [-2, hb / 4 + 2)
    m2_full = group.all_gather(m2e[:, 2:-2].contiguous(), 1)
    mips_full = [m2_full]
    for _ in range(mip_count - 3):
        if mips_full[-1].shape[-1] < 4 or mips_full[-1].shape[-2] < 4:
            break
        mips_full.append(downsample_13tap(mips_full[-1]))
    prev = None  # the upsample chain down to mip 2's resolution
    for t in range(len(mips_full) - 2, -1, -1):
        h2, w2 = mips_full[t].shape[-2:]
        out = _box_upsample(tent9(mips_full[t + 1], blur_radius), h2, w2)
        if prev is not None:
            out = out + _box_upsample(prev, h2, w2)
        prev = out
    h1, w1 = m2_full.shape[-2] * 2, m2_full.shape[-1] * 2
    u1_full = _box_upsample(tent9(m2_full, blur_radius), h1, w1)
    if prev is not None:
        u1_full = u1_full + _box_upsample(prev, h1, w1)

    def box_up_crop(src):
        """2x upsample of band rows carrying a 1-row halo -> the band."""
        return _box_upsample(src, src.shape[-2] * 2, w)[:, 2:-2]

    hb1 = hb // 2
    r0 = group.rank * hb1  # the band's first mip-1 row, before the pad
    u1_band = u1_full.index_select(-2, clamped_index(
        u1_full.shape[-2], r0 - 1, r0 + hb1 + 1, u1_full.device))
    t1_band = tent9(m1e, blur_radius)[:, 3:-3]  # mip-1 rows [-1, hb1 + 1)
    # the last sum in f32, as compute_bloom's mip-0 sum
    bloom = box_up_crop(t1_band).float() + box_up_crop(u1_band).float()
    return color + (bloom - color) * strength
