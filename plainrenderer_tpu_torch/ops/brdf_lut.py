"""Fitted split-sum BRDF terms (plainrenderer_tpu/ops/brdf_lut.py:126-170).

The frame shades with polynomials fitted to the exact brdfLut.comp bake
(env_brdf_fit.py) instead of sampling a LUT; the bake itself is not part
of the frame and is not ported.
"""

from __future__ import annotations

import torch

from . import env_brdf_fit


def _poly6(coef, u, v):
    """Total-degree-6 bivariate polynomial sum c[i,j] u^i v^j (i+j <= 6),
    nested Horner in the JAX package's order."""
    res = None
    for i in range(6, -1, -1):
        acc = float(coef[i, 6 - i])
        for j in range(6 - i - 1, -1, -1):
            acc = acc * v + float(coef[i, j])
        res = acc if res is None else res * u + acc
    return res


def env_brdf_fitted(roughness: torch.Tensor, nov: torch.Tensor):
    """Split-sum terms (fc_k "bias", k "energy"), brdf_lut.py:139: fitted
    in the cliff-aligned coordinate s = NoV / (r + NoV)."""
    s = nov / (roughness + nov + 1e-6)
    bias = torch.clamp(_poly6(env_brdf_fit.BIAS_SV, s, nov), 0.0, 1.0)
    k = torch.clamp(_poly6(env_brdf_fit.K_RS, roughness, s), 1e-4, 1.0)
    return bias, k


_Z_COEFS = (env_brdf_fit.Z_RN_0, env_brdf_fit.Z_RN_1,
            env_brdf_fit.Z_RN_2, env_brdf_fit.Z_RN_3)


def diffuse_integral_fitted(roughness: torch.Tensor, nov: torch.Tensor,
                            diffuse_brdf: int) -> torch.Tensor:
    """Diffuse split-sum integral (the LUT z channel) per diffuse mode,
    brdf_lut.py:161."""
    z = _poly6(_Z_COEFS[diffuse_brdf], roughness, nov)
    return torch.clamp(z, 0.0, 1.0)
