"""The BRDF lookup table: the Monte Carlo bake, its bilinear sample, and
the split-sum polynomials the frame shades with
(plainrenderer_tpu/ops/brdf_lut.py).

bake_brdf_lut is brdfLut.comp: 1024-sample GGX importance-sampled
specular split-sum terms (x = Fc * k, y = k) and the integrated diffuse
BRDF with in/out Fresnel (z), over a (roughness, NoV) grid. The frame
shades with polynomials fitted to this bake (env_brdf_fit.py) instead of
sampling it; the bake is what the fit is checked against. The JAX
package evaluates all texels x samples as one expression; at the default
512^2 texels x 1024 samples that is 3.2 GB per (N^2, S, 3) f32 tensor, so
the port bakes whole NoV rows in chunks whose sample tensors stay under
CHUNK_BYTES and reduces each chunk before the next.
"""

from __future__ import annotations

import math

import torch

from .. import device as device_mod
from ..utils import sampling
from . import brdf, env_brdf_fit

DEFAULT_LUT_SIZE = 512
DEFAULT_SAMPLES = 1024
CHUNK_BYTES = 1 << 28  # one (rows x size, S, 3) f32 tensor of a chunk


def _bake_rows(r, nov, xi, diffuse_brdf: int):
    """brdfLut.comp on texels (T, 1) of roughness r and NoV nov with the
    sample sequence xi (1, S, 2): (3, T) in the JAX expression's order."""
    zeros = torch.zeros_like(nov)
    v = torch.cat([torch.sqrt(torch.clamp_min(1.0 - nov * nov, 0.0)), zeros,
                   nov], dim=-1)[:, None, :]  # (T, 1, 3)
    n = torch.tensor([0.0, 0.0, 1.0], device=r.device)
    # specular term (brdfLut.comp:38-57)
    h = sampling.importance_sample_ggx(xi, r, n)  # (T, S, 3)
    voh_raw = torch.sum(v * h, dim=-1)
    l_dir = 2.0 * voh_raw[..., None] * h - v
    voh = torch.clamp_min(voh_raw, 0.0)
    noh = torch.clamp_min(h[..., 2], 0.0)
    nol = torch.clamp_min(l_dir[..., 2], 0.0)
    del h, l_dir
    vis = brdf.visibility_smith_ggx_height_correlated(nov, nol, r)
    k = vis * voh * nol / torch.clamp_min(noh, 1e-8)
    k = torch.where(nol > 0.0, k, 0.0)
    fc = torch.pow(1.0 - voh, 5.0)
    lut_x = torch.mean(fc * k, dim=1) * 4.0
    lut_y = torch.mean(k, dim=1) * 4.0
    del vis, k, fc, voh, noh, nol
    # diffuse term (brdfLut.comp:59-96)
    ld = sampling.importance_sample_cosine(xi, n).expand(nov.shape[0], -1, -1)
    hd = v + ld
    hd = hd / torch.clamp_min(
        torch.linalg.vector_norm(hd, dim=-1, keepdim=True), 1e-12)
    voh_d = torch.clamp(torch.sum(v * hd, dim=-1), 0.0, 1.0)
    nol_d = torch.clamp_min(ld[..., 2], 0.0)
    noh_d = torch.clamp_min(hd[..., 2], 0.0)
    f0d = 0.04
    fresnel_in_out = (1.0 - brdf.f_schlick(f0d, 1.0, nov)) * (
        1.0 - brdf.f_schlick(f0d, 1.0, nol_d))
    if diffuse_brdf == 0:
        term = torch.full_like(nol_d, 1.0 / math.pi)
    elif diffuse_brdf == 1:
        term = brdf.disney_diffuse(1.0, nol_d, voh_d, nov, r)
    elif diffuse_brdf == 2:
        term = brdf.cod_wwii_diffuse(1.0, nol_d, voh_d, nov, noh_d, r)
    else:
        lov = torch.clamp(torch.sum(ld * v, dim=-1), 0.0, 1.0)
        term = brdf.titanfall2_diffuse_single(nol_d, lov, nov, noh_d, r)
    lut_z = torch.mean(term * fresnel_in_out, dim=1)
    return torch.stack([lut_x, lut_y, lut_z])


def bake_brdf_lut(size: int = DEFAULT_LUT_SIZE,
                  samples: int = DEFAULT_SAMPLES, diffuse_brdf: int = 0,
                  device="cuda"):
    """brdfLut.comp (brdf_lut.py:28): (3, size, size) f32 [Fc * k, k,
    diffuse integral] indexed [., NoV row, roughness column], for
    diffuse_brdf 0 Lambert, 1 Disney, 2 CoD WWII, 3 Titanfall 2 (single
    scatter). Baked in chunks of NoV rows, each chunk's (rows x size, S,
    3) f32 sample tensors at most CHUNK_BYTES (at least one row)."""
    if diffuse_brdf not in (0, 1, 2, 3):
        raise ValueError(f"diffuse_brdf must be 0-3, got {diffuse_brdf}")
    dev = device_mod.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    cols = torch.arange(size, **f32)
    r = torch.clamp_min(cols / torch.full_like(cols, float(size)), 1e-4)
    nov = torch.clamp_min(cols, 0.1) / torch.full_like(cols, float(size))
    xi = sampling.hammersley_2d_shader(
        torch.arange(samples, device=dev), samples)[None]  # (1, S, 2)
    rows = max(1, CHUNK_BYTES // (size * samples * 3 * 4))
    out = torch.empty((3, size, size), **f32)
    for y0 in range(0, size, rows):
        y1 = min(size, y0 + rows)
        r_t = r[None, :].expand(y1 - y0, size).reshape(-1, 1)
        nov_t = nov[y0:y1, None].expand(y1 - y0, size).reshape(-1, 1)
        out[:, y0:y1] = _bake_rows(r_t, nov_t, xi, diffuse_brdf) \
            .reshape(3, y1 - y0, size)
    return out


def sample_brdf_lut(lut: torch.Tensor, roughness: torch.Tensor,
                    nov: torch.Tensor) -> torch.Tensor:
    """Bilinear LUT sample at (roughness, NoV) -> (3, ...) (brdf_lut.py:95),
    a parity helper: the frame shades with the fitted polynomials."""
    n = lut.shape[1]
    shape = roughness.shape
    rr = torch.clamp(roughness.reshape(-1) * n - 0.5, 0.0, n - 1.0)
    vv = torch.clamp(nov.reshape(-1) * n - 0.5, 0.0, n - 1.0)
    x0 = torch.floor(rr).to(torch.int64)
    y0 = torch.floor(vv).to(torch.int64)
    fx = rr - x0
    fy = vv - y0
    x1 = torch.clamp_max(x0 + 1, n - 1)
    y1 = torch.clamp_max(y0 + 1, n - 1)
    out = (lut[:, y0, x0] * (1 - fx) * (1 - fy)
           + lut[:, y0, x1] * fx * (1 - fy)
           + lut[:, y1, x0] * (1 - fx) * fy + lut[:, y1, x1] * fx * fy)
    return out.reshape((3,) + tuple(shape))


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


def env_brdf_approx(roughness: torch.Tensor, nov: torch.Tensor):
    """Karis's analytic split-sum approximation ("Physically Based Material
    on Mobile"), (fc_k, k) as the LUT's x / y channels (brdf_lut.py:173):
    the published baseline the fitted polynomials are measured against, not
    the shading path."""
    x = 1.0 - roughness
    y = nov
    b1, b2, b3, b4, b5 = -0.1688, 1.895, 0.9903, -4.853, 8.404
    b6 = -5.069
    bias = torch.clamp(torch.minimum(
        b1 * x + b2 * x * x, b3 + b4 * y + b5 * y * y + b6 * y * y * y),
        0.0, 1.0)
    d0, d1, d2, d3 = 0.6045, 1.699, -0.5228, -3.603
    d4, d5, d6 = 1.404, 0.1939, 2.661
    delta = torch.clamp(d0 + d1 * x + d2 * y + d3 * x * x + d4 * x * y
                        + d5 * y * y + d6 * x * x * x, 0.0, 1.0)
    scale = delta - bias
    # LUT channels: x = Fc * k (bias), y = k (scale + bias)
    return bias, torch.clamp(scale + bias, 1e-4, 1.0)
