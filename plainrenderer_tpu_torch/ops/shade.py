"""Forward PBR shading over planar framebuffers (plainrenderer_tpu/ops/shade.py).

Pure per-pixel math on (..., H, W) planes (triangle.frag:146-321): normal
mapping through the interpolated TBN, roughness remap, the four diffuse
BRDFs with in/out Fresnel, GGX single scatter + multiscatter, the sun
term, and indirect light: the SDF GI's SH-L1 irradiance (diffuse and a
dominant-direction specular lobe), or the constant ambient without GI.
"""

from __future__ import annotations

import math

import torch

from ..config import ShadingConfig
from ..utils import sh
from ..utils.color import ycocg_to_linear
from ..utils.mathutils import fma
from . import brdf
from .brdf_lut import diffuse_integral_fitted, env_brdf_fitted

PI = math.pi


def reflected_energy_average(roughness):
    """triangle.frag:121-129 — fitted average reflected energy E_avg(r)."""
    smoothness = 1.0 - torch.sqrt(roughness)
    r = -0.0761947 - 0.383026 * smoothness
    r = 1.04997 + smoothness * r
    r = 0.409255 + smoothness * r
    return torch.clamp_max(r, 0.999)


def specular_multiscatter_lobe(mode: int, r, nol, f0, single_lobe,
                               lut_y_outgoing, lut_y_incoming):
    """triangle.frag:146-175 — the four selectable multiscatter modes."""
    energy_outgoing = lut_y_outgoing
    fresnel_avg = f0 + (1.0 - f0) / 21.0
    if mode == 0:
        energy_avg = reflected_energy_average(r)
        unscaled = (1.0 - lut_y_incoming) * (1.0 - energy_outgoing) / (
            3.1415 * (1.0 - energy_avg))
        scaling = (fresnel_avg * fresnel_avg * energy_avg) / (
            1.0 - fresnel_avg * (1.0 - energy_avg))
        return unscaled * scaling
    if mode == 1:
        lobe = (1.0 - energy_outgoing) / PI
        scaling = (fresnel_avg * fresnel_avg * energy_outgoing) / (
            1.0 - fresnel_avg * (1.0 - energy_outgoing))
        return lobe * scaling
    if mode == 2:
        return f0 * (1.0 / torch.clamp_min(energy_outgoing, 1e-4) - 1.0) \
            * single_lobe
    return torch.zeros_like(single_lobe)


def geometric_aa_roughness(normal, r, kappa=0.18, pixel_variance=0.5):
    """GeometricAA.inc:4-21 — Kaplanyan specular AA from one-pixel normal
    differences; normal is (3, H, W)."""
    n_u = torch.diff(normal, dim=2, append=normal[:, :, -1:])
    n_v = torch.diff(normal, dim=1, append=normal[:, -1:, :])
    variance = pixel_variance ** 2 * (
        torch.sum(n_u * n_u, dim=0) + torch.sum(n_v * n_v, dim=0))
    kernel_r2 = torch.clamp_max(2.0 * variance, kappa)
    return torch.clamp(torch.sqrt(r * r + kernel_r2), 0.0, 1.0)


def _dot(a, b):
    return torch.sum(a * b, dim=0)


def _normalize(v):
    return v / torch.clamp_min(
        torch.sqrt(torch.sum(v * v, dim=0, keepdim=True)), 1e-12)


def shade_forward(*, config: ShadingConfig, world_pos, geo_normal, tangent,
                  bitangent, valid, albedo_srgb_linear, normal_ts, specular,
                  sun_direction, sun_color, sun_strength_exposed, sun_shadow,
                  camera_position, indirect_y_sh=None, indirect_cocg=None):
    """Linear HDR color (3, H, W), 0 where not valid (shade.py:110).

    indirect_y_sh (4, H, W) / indirect_cocg (2, H, W): the GI's Y
    irradiance as SH-L1 and its chroma (triangle.frag:289-321); without
    them (or with indirect_lighting_tech 1) the constant ambient of
    triangle.frag:322-333."""
    metalic = specular[2]
    r = specular[1]
    r = torch.clamp_min(r * r, 0.0045)
    diffuse_color = (1.0 - metalic)[None] * albedo_srgb_linear

    nz = torch.sqrt(torch.clamp_min(
        1.0 - normal_ts[0] * normal_ts[0] - normal_ts[1] * normal_ts[1], 0.0))
    n = (tangent * normal_ts[0][None] + bitangent * normal_ts[1][None]
         + geo_normal * nz[None])
    n_len = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    # degenerate-TBN fallback to the geometric normal (triangle.frag:198-200)
    n = torch.where(n_len > 1e-6, n / torch.clamp_min(n_len, 1e-12),
                    geo_normal)

    l = sun_direction.to(torch.float32).reshape(3, 1, 1)
    v = _normalize(camera_position.reshape(3, 1, 1) - world_pos)
    h = _normalize(v + l)

    if config.use_geometric_aa:
        r = geometric_aa_roughness(n, r)

    noh = torch.clamp_min(_dot(n, h), 0.0)
    nol = torch.clamp(_dot(n, l), 0.0, 1.0)
    voh = torch.abs(_dot(v, h))
    lov = torch.clamp_min(_dot(l, v), 0.0)
    nov = torch.clamp_min(torch.abs(_dot(n, v)), 1e-4)

    f0 = 0.04 + (albedo_srgb_linear - 0.04) * metalic[None]
    sun_radiance = (nol * sun_shadow)[None] * sun_color.reshape(3, 1, 1)

    lut_x, lut_y = env_brdf_fitted(r, nov)
    _, lut_y_in = env_brdf_fitted(r, nol)
    diffuse_integral = diffuse_integral_fitted(r, nov, config.diffuse_brdf)[None]
    if config.diffuse_brdf == 3:
        multi_integral = (0.1159 * r * (2.0 * PI)
                          * (1.0 - brdf.f_schlick(0.04, 1.0, nov)) * 0.94291)
        diffuse_integral = torch.clamp_max(
            diffuse_integral + diffuse_color * multi_integral[None], 1.0)

    if config.diffuse_brdf == 0:
        diffuse = brdf.lambert_diffuse(diffuse_color)
    elif config.diffuse_brdf == 1:
        diffuse = brdf.disney_diffuse(diffuse_color, nol, voh, nov, r)
    elif config.diffuse_brdf == 2:
        diffuse = brdf.cod_wwii_diffuse(diffuse_color, nol, voh, nov, noh, r)
    else:
        diffuse = brdf.titanfall2_diffuse(diffuse_color, nol, lov, nov, noh,
                                          r)
    diffuse_direct = diffuse * sun_radiance
    diffuse_direct = diffuse_direct * (
        (1.0 - brdf.f_schlick(f0, 1.0, nov[None]))
        * (1.0 - brdf.f_schlick(f0, 1.0, nol[None])))

    single = brdf.ggx_single_scattering(r, f0, noh, nov, voh, nol)
    multi = specular_multiscatter_lobe(
        config.direct_multiscatter_brdf, r, nol, f0, single, lut_y, lut_y_in)
    specular_direct = sun_radiance * (single + multi)

    if config.indirect_lighting_tech == 0 and indirect_y_sh is not None:
        lighting_indirect = _sh_indirect(
            config, n, v, r, f0, nov, diffuse_color, diffuse_integral,
            indirect_y_sh, indirect_cocg)
    else:
        ambient = 0.003 * sun_strength_exposed
        single_amb = lut_x + (lut_y - lut_x) * f0
        lighting_indirect = (ambient * diffuse_color * diffuse_integral
                             + single_amb * ambient)

    color = (diffuse_direct + specular_direct) * sun_strength_exposed \
        + lighting_indirect
    return torch.where(valid[None], color, 0.0)


def _sh_indirect(config, n, v, r, f0, nov, diffuse_color, diffuse_integral,
                 indirect_y_sh, indirect_cocg):
    """triangle.frag:289-321 — SH-L1 irradiance diffuse plus a specular
    lobe toward the SH's dominant direction (shade.py:204-230)."""
    sh_n = sh.direction_to_sh_l1(torch.movedim(n, 0, -1))
    irr_y = torch.clamp_min(
        torch.sum(torch.movedim(indirect_y_sh, 0, -1) * sh_n, dim=-1), 0.0)
    irradiance = torch.movedim(ycocg_to_linear(torch.stack(
        [irr_y, indirect_cocg[0], indirect_cocg[1]], dim=-1)), -1, 0)
    irradiance = torch.clamp_min(irradiance, 0.0)
    diffuse_indirect = irradiance * diffuse_color * diffuse_integral

    dom = torch.movedim(sh.dominant_direction_from_sh_l1(
        torch.movedim(indirect_y_sh, 0, -1)), -1, 0)
    dom_len = torch.clamp(torch.sqrt(torch.sum(dom * dom, dim=0)), 0.01, 1.0)
    r_ind = 1.0 + (r - 1.0) * torch.sqrt(dom_len)
    l_ind = dom / torch.clamp_min(dom_len[None], 1e-9)
    h_ind = _normalize(l_ind + v)
    noh_i = torch.clamp_min(_dot(n, h_ind), 0.0)
    nol_i = torch.clamp_min(_dot(n, l_ind), 0.0)
    voh_i = torch.clamp_min(_dot(v, h_ind), 0.0)
    single_i = brdf.ggx_single_scattering(r_ind, f0, noh_i, nov, voh_i,
                                          nol_i)
    _, lut_yi = env_brdf_fitted(r_ind, nov)
    _, lut_yi_in = env_brdf_fitted(r_ind, nol_i)
    multi_i = specular_multiscatter_lobe(
        config.direct_multiscatter_brdf if config.use_indirect_multiscatter
        else 3, r_ind, nol_i, f0, single_i, lut_yi, lut_yi_in)
    radiance_ind = torch.movedim(ycocg_to_linear(torch.stack(
        [torch.clamp_min(indirect_y_sh[0], 0.0), indirect_cocg[0],
         indirect_cocg[1]], dim=-1)), -1, 0)
    radiance_ind = torch.clamp_min(radiance_ind, 0.0)
    return diffuse_indirect + (single_i + multi_i) * radiance_ind


def reconstruct_world_position(depth, inv_view_proj, width, height):
    """Reverse-Z depth + pixel NDC -> world position (3, H, W) (shade.py:249).

    Each row m . (x, y, z, 1) is rounded as XLA:CPU contracts the JAX
    expression m0 x + m1 y + m2 z + m3 at the golden frame's size,
    fma(m2, z, fma(m0, x, m1 y)) + m3 (its contraction differs at some
    other sizes), the same on every device. Under a static camera the
    frame's motion vectors are the rounding noise of this reprojection,
    and their sign decides the history windows' edge tests at pixel
    centres (kernels H and I): rounding as the reference does keeps those
    decisions the reference's."""
    h, w = depth.shape
    dev = depth.device
    # XLA divides by a constant as a multiply by its reciprocal
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / width) * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / height) * 2.0 - 1.0
    ndc = (xs[None, :].expand(h, w), ys[:, None].expand(h, w),
           torch.clamp_min(depth, 1e-9))
    m = inv_view_proj

    def row(r):
        return fma(m[r, 2], ndc[2], fma(m[r, 0], ndc[0],
                                        m[r, 1] * ndc[1])) + m[r, 3]

    wdiv = row(3)
    return torch.stack([row(r) for r in range(3)]) \
        / torch.where(torch.abs(wdiv) > 1e-12, wdiv, 1.0)[None]
