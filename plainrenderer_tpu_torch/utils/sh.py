"""Spherical harmonics L1 basis of the SDF-GI encode/decode
(plainrenderer_tpu/utils/sh.py; SphericalHarmonics.inc:4-15).

The GI trace stores irradiance as Y * SH_L1(dir) (sdfDiffuseTrace.comp:
196-205); the forward pass reconstructs irradiance and a dominant
direction for indirect specular (triangle.frag:295-321). Channel-last,
as the JAX package's.
"""

from __future__ import annotations

import torch

_SQRT_PI = 1.7724538509055159  # sqrt(pi)
_SQRT3 = 1.7320508075688772


def direction_to_sh_l1(v: torch.Tensor) -> torch.Tensor:
    """SphericalHarmonics.inc:5-11 — normalized (c0, -y, z, -x) L1 vector.

    v is (..., 3) unit direction; returns (..., 4)."""
    c0 = torch.full(v.shape[:-1], 1.0 / (2.0 * _SQRT_PI), dtype=v.dtype,
                    device=v.device)
    c1 = -_SQRT3 * v[..., 1] / (2.0 * _SQRT_PI)
    c2 = _SQRT3 * v[..., 2] / (2.0 * _SQRT_PI)
    c3 = -_SQRT3 * v[..., 0] / (2.0 * _SQRT_PI)
    sh = torch.stack([c0, c1, c2, c3], dim=-1)
    norm = torch.sqrt(torch.sum(sh * sh, dim=-1, keepdim=True))
    return sh / torch.clamp_min(norm, 1e-20)


def dominant_direction_from_sh_l1(c: torch.Tensor) -> torch.Tensor:
    """SphericalHarmonics.inc:13-15 — (-c3, -c1, c2)."""
    return torch.stack([-c[..., 3], -c[..., 1], c[..., 2]], dim=-1)
