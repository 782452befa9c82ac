"""Color conversions and hash noise (plainrenderer_tpu/utils/color.py;
colorConversion.inc, luminance.inc, noise.inc, dither.inc).

Colour arrays are channel-last (..., 3) as the JAX package's, framebuffers
channel-planar (C, H, W) (the *_planar helpers). The shaders' uint32
hashes run on int64 tensors holding the uint32 value, masked back to 32
bits after every product and shift, or on int32 whose products wrap the
same low 32 bits; their float conversions are of the uint32 value.
"""

from __future__ import annotations

import torch

# Hoskins hash32 multipliers (noise.inc:16-26) as the int32 with the same
# low 32 bits: int32 products wrap exactly like the shader's uint32 ones
_UI0 = 1597334673
_UI1 = 3812015801 - (1 << 32)
_UI2 = 2798796415 - (1 << 32)
_UIF = 1.0 / 4294967295.0
LUMA_WEIGHTS = (0.21, 0.72, 0.07)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """colorConversion.inc:4-13 — piecewise sRGB OETF."""
    lo = c * 12.92
    hi = torch.pow(torch.abs(c), 1.0 / 2.4) * 1.055 - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """luminance.inc:5-7 — dot(color, (0.21, 0.72, 0.07)) over the
    channels of (3, ...) planes, summed in channel order; the weights are
    Python scalars, so no constant is copied to the device."""
    return (rgb[0] * LUMA_WEIGHTS[0] + rgb[1] * LUMA_WEIGHTS[1]
            + rgb[2] * LUMA_WEIGHTS[2])


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """colorConversion.inc:15-24 — piecewise sRGB EOTF."""
    lo = c / 12.92
    hi = torch.pow(torch.abs(c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.004045, lo, hi)


def linear_to_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """colorConversion.inc:26-31 — RGB -> (Y, Co, Cg), channel-last."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    return torch.stack([y, co, cg], dim=-1)


def ycocg_to_linear(ycocg: torch.Tensor) -> torch.Tensor:
    """colorConversion.inc:33-38 — (Y, Co, Cg) -> RGB, channel-last."""
    y, co, cg = ycocg[..., 0], ycocg[..., 1], ycocg[..., 2]
    r = y + co - cg
    g = y + cg
    b = y - co - cg
    return torch.stack([r, g, b], dim=-1)


def interleaved_gradient_noise(uv: torch.Tensor) -> torch.Tensor:
    """noise.inc:5-8 — CoD:AW interleaved gradient noise; uv (..., 2)."""
    d = uv[..., 0] * 0.06711056 + uv[..., 1] * 0.00583715
    return torch.remainder(62.9829189 * torch.remainder(d, 1.0), 1.0)


_U32 = 0xFFFFFFFF


def hash32(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """noise.inc:16-26 — Hoskins hash32: integer coords -> 3 floats in
    [0, 1], (..., 3)."""
    return torch.stack(_hash32_planar(qx, qy), dim=-1)


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """noise.inc:39-47 — Wang hash of a uint32 (int64 in and out)."""
    s = seed.to(torch.int64) & _U32
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _U32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _U32
    return s ^ (s >> 15)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """noise.inc:30-36 — one xorshift32 step (int64 in and out)."""
    s = state.to(torch.int64) & _U32
    s = s ^ ((s << 13) & _U32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _U32)


def rand_from_state(state: torch.Tensor):
    """noise.inc:50-54 — xorshift, then a float in [0, 1]: (value, new
    state). uintBitsToFloat(0x2f800004) is 2^-32 (1 + 2^-21)."""
    s = xorshift32(state)
    return torch.clamp(s.to(torch.float32) * 2.3283067e-10, 0.0, 1.0), s


def dither_rgb8(color: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                time: torch.Tensor) -> torch.Tensor:
    """dither.inc:6-12 — +-1 LSB dither before the RGBA8 quantise: color
    (..., 3), px / py integer pixel coords broadcast against color[..., 0],
    time the frame time."""
    t = time.to(torch.float32)
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    n0 = hash32((pxf * t).to(torch.int32), (pyf * t).to(torch.int32))
    n1 = hash32(((pxf + 165.0) * t).to(torch.int32),
                ((pyf + 1292.0) * t).to(torch.int32))
    return color + (n0 + n1 - 1.0) / 255.0


def _as_uint32_float(h: torch.Tensor) -> torch.Tensor:
    """float32 of the uint32 whose bits are the int32 h (RNE, like
    uint32 -> f32 conversion)."""
    return (h.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def _hash32_planar(qx: torch.Tensor, qy: torch.Tensor):
    """hash32 with the 3 output channels as separate planes."""
    x = qx.to(torch.int32)
    y = qy.to(torch.int32)
    h = (x * _UI0) ^ (y * _UI1) ^ (x * _UI2)
    return (_as_uint32_float(h * _UI0) * _UIF,
            _as_uint32_float(h * _UI1) * _UIF,
            _as_uint32_float(h * _UI2) * _UIF)


def dither_noise_planar(px: torch.Tensor, py: torch.Tensor,
                        time: torch.Tensor) -> torch.Tensor:
    """dither.inc:6-12 noise term as (3, H, W) planes."""
    t = time.to(torch.float32)
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    n0 = _hash32_planar((pxf * t).to(torch.int32), (pyf * t).to(torch.int32))
    n1 = _hash32_planar(((pxf + 165.0) * t).to(torch.int32),
                        ((pyf + 1292.0) * t).to(torch.int32))
    return torch.stack([(a + b - 1.0) / 255.0 for a, b in zip(n0, n1)])
