"""BRDF terms for the forward PBR pass (plainrenderer_tpu/ops/brdf.py).

Parity: brdf.inc (GGX NDF, Smith visibility, Schlick Fresnel, Disney /
CoD-WWII / Titanfall-2 diffuse models). Scalar math over tensors of any
shape; dot products are pre-clamped by the caller.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def d_ggx(noh, r):
    """brdf.inc:4-8 — GGX normal distribution (Lagarde's stable form)."""
    a = noh * r
    k = r / (1.0 - noh * noh + a * a)
    return k * k * (1.0 / PI)


def visibility_smith_ggx_height_correlated(nov, nol, r):
    """brdf.inc:18-26 — height-correlated Smith visibility."""
    r2 = r * r
    v1 = nol * torch.sqrt(nov * nov * (1.0 - r2) + r2)
    v2 = nov * torch.sqrt(nol * nol * (1.0 - r2) + r2)
    return 0.5 / torch.clamp_min(v1 + v2, 1e-7)


def f_schlick(f0, f90, voh):
    """brdf.inc:33-35 — Schlick Fresnel; f0/f90 broadcast against voh."""
    return f0 + (f90 - f0) * torch.pow(1.0 - voh, 5.0)


def ggx_single_scattering(r, f0, noh, nov, voh, nol):
    """brdf.inc:76-81 — D * Vis * F (f90 = 1)."""
    d = d_ggx(noh, r)
    vis = visibility_smith_ggx_height_correlated(nov, nol, r)
    f = f_schlick(f0, torch.ones_like(f0), voh)
    return d * vis * f


def lambert_diffuse(diffuse_color):
    """triangle.frag diffuse option 0 — albedo / pi."""
    return diffuse_color / PI


def disney_diffuse(diffuse_color, nol, voh, nov, r):
    """brdf.inc:38-46 — Disney diffuse with Frostbite energy conservation."""
    energy_bias = 0.5 * r
    energy_factor = 1.0 + r * (1.0 / 1.51 - 1.0)
    f90_biased = energy_bias + 2.0 * voh * voh * r
    fl = 1.0 + (f90_biased - 1.0) * torch.pow(1.0 - nol, 5.0)
    fv = 1.0 + (f90_biased - 1.0) * torch.pow(1.0 - nov, 5.0)
    return diffuse_color / PI * fl * fv * energy_factor


def cod_wwii_diffuse(diffuse_color, nol, voh, nov, noh, r):
    """brdf.inc:49-60 — Call of Duty WWII diffuse fit."""
    f0_diffuse = voh + torch.pow(1.0 - voh, 5.0)
    f1 = (1.0 - 0.75 * torch.pow(1.0 - nol, 5.0)) * (
        1.0 - 0.75 * torch.pow(1.0 - nov, 5.0))
    g = torch.log2(torch.clamp_min(
        2.0 / torch.clamp_min(r * r, 1e-6) - 1.0, 1e-6)) / 18.0
    t = torch.clamp(2.2 * g - 0.5, 0.0, 1.0)
    fd = f0_diffuse + (f1 - f0_diffuse) * t
    fb = ((34.5 * g * g - 59.0 * g + 24.5) * voh
          * torch.pow(2.0, -torch.clamp_min(73.2 * g - 21.2, 8.9)
                      * torch.sqrt(noh)))
    return diffuse_color / PI * (fd + fb)


def titanfall2_diffuse_single(nol, lov, nov, noh, r):
    """brdf.inc:62-69 — Titanfall 2 (GDC'17 Hammon) single-scatter term."""
    facing = 0.5 + 0.5 * lov
    rough = facing * (0.9 - 0.4 * facing) * (0.5 + noh) / torch.clamp_min(
        noh, 0.03)
    smooth = (1.05 * (1.0 - torch.pow(1.0 - nol, 5.0))
              * (1.0 - torch.pow(1.0 - nov, 5.0)))
    return 1.0 / PI * (smooth + (rough - smooth) * r)


def titanfall2_diffuse(diffuse_color, nol, lov, nov, noh, r):
    """brdf.inc:71-74 — single + albedo-weighted multi-scatter term."""
    single = titanfall2_diffuse_single(nol, lov, nov, noh, r)
    multi = 0.1159 * r
    return diffuse_color * (single + diffuse_color * multi)
