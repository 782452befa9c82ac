"""Color conversions and hash noise (plainrenderer_tpu/utils/color.py).

Only what the ported passes use: the sRGB encode, the YCoCg transforms of
the GI encode/decode (channel-last, as the JAX package's), luminance and
the planar dither noise of the tonemap pass. Framebuffers are channel-planar
(C, H, W).
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
