"""R11G11B10 float packing (plainrenderer_tpu/ops/color_packing.py).

The TAA history is stored as R11G11B10_uFloat, the reference's format for
HDR color targets (TAA.cpp:28): one int32 per texel. Encoding truncates
the f32 bit pattern into a 5-bit exponent window shared with f16 and 6 / 6
/ 5 mantissa bits, rounding to nearest by adding half an ulp first. Values
clamp to [0, 64512] (so +inf packs as 64512), NaN and -inf pack as 0, and
values below the smallest step flush to 0. Bit-identical to the JAX
package's.
"""

from __future__ import annotations

import torch


def _to_unsigned_float(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    # jnp.clip then NaN -> 0; the select also makes -0.0 the +0.0 that
    # jnp.clip returns (torch.clamp keeps the sign of a zero)
    x = torch.clamp_max(x.to(torch.float32), 64512.0)
    x = torch.where(x > 0.0, x, 0.0)
    bits = x.view(torch.int32)
    shifted = bits - ((127 - 15) << 23) + (1 << (22 - mantissa_bits))
    shifted = torch.clamp_min(shifted, 0)  # flush small values to zero
    return (shifted >> (23 - mantissa_bits)) & ((1 << (5 + mantissa_bits)) - 1)


def _from_unsigned_float(u: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    u = u.to(torch.int32) & ((1 << (5 + mantissa_bits)) - 1)
    val = ((u << (23 - mantissa_bits)) + ((127 - 15) << 23)).view(
        torch.float32)
    return torch.where(u == 0, 0.0, val)


def pack_r11g11b10(rgb: torch.Tensor) -> torch.Tensor:
    """rgb (3, ...) f32 -> (...,) int32 packed."""
    r = _to_unsigned_float(rgb[0], 6)
    g = _to_unsigned_float(rgb[1], 6)
    b = _to_unsigned_float(rgb[2], 5)
    return r | (g << 11) | (b << 22)


def unpack_r11g11b10(packed: torch.Tensor) -> torch.Tensor:
    """(...,) int32 -> (3, ...) f32."""
    packed = packed.to(torch.int32)
    return torch.stack([_from_unsigned_float(packed & 0x7FF, 6),
                        _from_unsigned_float((packed >> 11) & 0x7FF, 6),
                        _from_unsigned_float((packed >> 22) & 0x3FF, 5)])
