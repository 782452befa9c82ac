"""Froxel volumetric lighting (plainrenderer_tpu/ops/volumetrics.py,
single-device: the split-frame halo_fn branches are not in the port).

A froxel grid of screen/8 x screen/8 x 64 slices with an exponential
depth distribution (k = 3, volumetricFroxelLighting.inc:22-41), every
volume channel-planar (C, D, Hf, Wf):

  - material_volume: density = base + noise * (gradient noise - 0.5) at
    worldPos * 0.5 + wind offset (froxelVolumeMaterial.comp); the noise is
    the JAX package's analytic hash-gradient noise, its uint32 hash done
    in int64 masked to 32 bits, bit-identical;
  - light_scattering: the sun shadow of a 4x coarser grid, trilinearly
    upsampled, times a Henyey-Greenstein phase plus a constant ambient
    (froxelLightScattering.comp);
  - temporal_reprojection: an EMA (alpha 0.95) with the history fetched
    trilinearly at the coarse points' previous-frustum positions
    (volumeLightingReprojection.comp);
  - integrate_froxels: front-to-back integration, a cumsum along the
    slices (volumetricLightingIntegration.comp);
  - apply_froxel_fog: the per-pixel lookup at quarter resolution with a
    noise-jittered slice, bilinearly upsampled (triangle.frag:131-144).

The trilinear / bilinear resizes are jax.image.resize's separable
triangle weights (ops/sky._resize_weights). Divisions the JAX package
makes by a constant are true divisions here too (sdfgi._div): on the card
dividing by a Python number multiplies by its rounded reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.stencil import point_downsample
from .sdfgi import _div
from .sky import _resize_weights, resize_bilinear

K_EXP = 3.0  # volumetricFroxelLighting.inc:22
# jnp.exp(K_EXP) - 1.0, both in f32
_EXPK_M1 = float(np.exp(np.float32(K_EXP)) - np.float32(1.0))
_HALF_SQRT3 = float(np.sqrt(np.float32(3.0)) / np.float32(2.0))
_U32 = 0xFFFFFFFF


def froxel_uv_to_depth(uv_z, max_distance):
    """volumetricFroxelLighting.inc:25-33."""
    return _div(torch.exp(K_EXP * uv_z) - 1.0, _EXPK_M1) * max_distance


def depth_to_froxel_uvz(depth, max_distance):
    """volumetricFroxelLighting.inc:35-41."""
    linear = _div(depth, max_distance)
    return _div(torch.log(linear * _EXPK_M1 + 1.0), K_EXP)


def _hash3(ix, iy, iz):
    """The JAX package's wang-hash-style uint32 hash of int32 cell coords
    (volumetrics.py:53), as int64 values in [0, 2^32)."""
    def u32(v):
        return v.to(torch.int64) & _U32

    s = ((u32(ix) * 73856093) & _U32) ^ ((u32(iy) * 19349663) & _U32) \
        ^ ((u32(iz) * 83492791) & _U32)
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _U32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _U32
    return s ^ (s >> 15)


def analytic_perlin_3d_planar(px, py, pz):
    """Gradient noise in [0, 1] at world positions given as three planes
    (volumetrics.py:66), in the reference's operation order."""
    ix = torch.floor(px).to(torch.int32)
    iy = torch.floor(py).to(torch.int32)
    iz = torch.floor(pz).to(torch.int32)
    fx = px - ix.to(torch.float32)
    fy = py - iy.to(torch.float32)
    fz = pz - iz.to(torch.float32)

    def fade(f):
        return f * f * f * (f * (f * 6.0 - 15.0) + 10.0)

    wx, wy, wz = fade(fx), fade(fy), fade(fz)

    def grad_dot(ox, oy, oz):
        h = _hash3(ix + ox, iy + oy, iz + oz)
        gx = _div((h & 0x3FF).to(torch.float32), 511.5) - 1.0
        gy = _div(((h >> 10) & 0x3FF).to(torch.float32), 511.5) - 1.0
        gz = _div(((h >> 20) & 0x3FF).to(torch.float32), 511.5) - 1.0
        inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-6)
        return (gx * (fx - ox) + gy * (fy - oy) + gz * (fz - oz)) * inv

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(grad_dot(0, 0, 0), grad_dot(1, 0, 0), wx)
    c10 = lerp(grad_dot(0, 1, 0), grad_dot(1, 1, 0), wx)
    c01 = lerp(grad_dot(0, 0, 1), grad_dot(1, 0, 1), wx)
    c11 = lerp(grad_dot(0, 1, 1), grad_dot(1, 1, 1), wx)
    n = lerp(lerp(c00, c10, wy), lerp(c01, c11, wy), wz)
    return torch.clamp(_div(n, _HALF_SQRT3) * 0.5 + 0.5, 0.0, 1.0)


def froxel_world_positions(res_xyz, cam, tan_fov_half, aspect,
                           max_distance, sample_offset=0.5):
    """Froxel centres in world space, (3, D, Hf, Wf)
    (froxelVolumeMaterial.comp:24-30): the view ray through the froxel's
    NDC, unnormalised so dot(ray, forward) == 1, times the slice depth."""
    wf, hf, d = res_xyz
    dev = cam["position"].device
    ar = dict(dtype=torch.float32, device=dev)
    xs = _div(torch.arange(wf, **ar) + sample_offset, wf) * 2.0 - 1.0
    ys = _div(torch.arange(hf, **ar) + sample_offset, hf) * 2.0 - 1.0
    depth = froxel_uv_to_depth(_div(torch.arange(d, **ar) + sample_offset, d),
                               max_distance)
    f, u, r = cam["forward"], cam["up"], cam["right"]
    ndc_x = xs[None, :].expand(hf, wf)
    ndc_y = ys[:, None].expand(hf, wf)
    # -y: the projection's row mapping (sky.view_directions)
    return torch.stack([
        cam["position"][c]
        + (f[c] + tan_fov_half * aspect * ndc_x * r[c]
           - tan_fov_half * ndc_y * u[c])[None] * depth[:, None, None]
        for c in range(3)])


def material_volume(world_pos, settings, wind_offset):
    """froxelVolumeMaterial.comp — (4, D, Hf, Wf): scatter rgb +
    absorption, the density noise evaluated per froxel (the frame's
    noise_stride=1)."""
    noise = analytic_perlin_3d_planar(world_pos[0] * 0.5 + wind_offset[0],
                                      world_pos[1] * 0.5 + wind_offset[1],
                                      world_pos[2] * 0.5 + wind_offset[2])
    density = settings.base_density + settings.noise_density * (noise - 0.5)
    density = torch.clamp_min(density, 0.0)
    scatter = settings.scattering_coefficient * density
    absorption = settings.absorption_coefficient * density
    return torch.stack([scatter, scatter, scatter, absorption])


def _resize_coarse(x, fine_shape):
    """jax.image.resize(x, lead + fine_shape, "trilinear"): the separable
    triangle weights along each of the last three axes."""
    out = x
    for axis, n_out in zip((-3, -2, -1), fine_shape):
        n_in = out.shape[axis]
        if n_in != n_out:
            wts = _resize_weights(n_in, n_out, x.device)
            out = torch.movedim(torch.tensordot(
                torch.movedim(out, axis, -1), wts, dims=1), -1, axis)
    return out


def light_scattering(material, world_pos, shadow_coarse, cam, sun_dir,
                     sun_color, sun_strength, phase_g, ambient=0.02):
    """froxelLightScattering.comp — per-froxel inscattering rgb and the
    transmittance coefficient, (4, D, Hf, Wf); shadow_coarse (Dc, Hc, Wc)
    is trilinearly upsampled (volumetrics.py:188)."""
    _, d, hf, wf = material.shape
    shadow = _resize_coarse(shadow_coarse, (d, hf, wf))
    vx = world_pos[0] - cam["position"][0]
    vy = world_pos[1] - cam["position"][1]
    vz = world_pos[2] - cam["position"][2]
    inv_len = torch.rsqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz,
                                          1e-18))
    vol = -(vx * sun_dir[0] + vy * sun_dir[1] + vz * sun_dir[2]) * inv_len
    denom = 4.0 * math.pi * torch.pow(
        1.0 + phase_g ** 2 - 2.0 * phase_g * vol, 1.5)
    phase = torch.full_like(denom, 1.0 - phase_g ** 2) / denom
    sun_base = shadow * sun_strength * phase
    scatter = material[0]  # the rgb scatter channels are identical
    inscatter = torch.stack([(sun_base * sun_color[c] + ambient) * scatter
                             for c in range(3)])
    # transmittance coefficient = luminance of the (gray) extinction
    trans = (0.21 + 0.72 + 0.07) * (scatter + material[3])
    return torch.cat([inscatter, trans[None]])


def temporal_reprojection(current, history, world_pos_coarse, prev_view_proj,
                          prev_cam_pos, prev_cam_forward, max_distance,
                          camera_cut):
    """volumeLightingReprojection.comp — EMA alpha 0.95 with the history
    fetched trilinearly at the coarse points' previous-frustum froxel
    coords, upsampled to the full grid (volumetrics.py:239).
    current / history (4, D, Hf, Wf); world_pos_coarse (3, Dc, Hc, Wc);
    camera_cut a 0-d bool tensor."""
    _, d, hf, wf = current.shape
    _, dc, hc, wc = world_pos_coarse.shape
    p = world_pos_coarse.reshape(3, -1).T
    clip = p @ prev_view_proj[:3, :3].T + prev_view_proj[:3, 3]
    w = p @ prev_view_proj[3, :3] + prev_view_proj[3, 3]
    ndc = clip[:, :2] / torch.where(torch.abs(w[:, None]) > 1e-9,
                                    w[:, None], 1.0)
    to_p = p - prev_cam_pos
    dist = torch.sqrt(torch.sum(to_p * to_p, dim=-1))
    vh = to_p / torch.clamp_min(dist[:, None], 1e-9)
    hist_depth = dist * torch.sum(vh * prev_cam_forward, dim=-1)
    uvw = torch.stack([
        ndc[:, 0] * 0.5 + 0.5, ndc[:, 1] * 0.5 + 0.5,
        depth_to_froxel_uvz(torch.clamp_min(hist_depth, 1e-4),
                            max_distance)], dim=-1)
    ok = torch.all((uvw >= 0.0) & (uvw <= 1.0), dim=-1) & (w > 0)

    def axis_coords(c, n):
        c = torch.clamp(c - 0.5, 0.0, n - 1.0)
        i0 = torch.floor(c).to(torch.int64)
        return i0, torch.clamp_max(i0 + 1, n - 1), c - i0.to(torch.float32)

    x0, x1, fx = axis_coords(uvw[:, 0] * wf, wf)
    y0, y1, fy = axis_coords(uvw[:, 1] * hf, hf)
    z0, z1, fz = axis_coords(uvw[:, 2] * d, d)
    histf = history.reshape(4, -1)

    def g(z, y, x):
        return histf[:, (z * hf + y) * wf + x]

    c00 = g(z0, y0, x0) * (1 - fx) + g(z0, y0, x1) * fx
    c01 = g(z0, y1, x0) * (1 - fx) + g(z0, y1, x1) * fx
    c10 = g(z1, y0, x0) * (1 - fx) + g(z1, y0, x1) * fx
    c11 = g(z1, y1, x0) * (1 - fx) + g(z1, y1, x1) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    hist = torch.where(ok[None], c0 + (c1 - c0) * fz, 0.0)
    alpha_c = torch.where(ok, 0.95, 0.0).reshape(dc, hc, wc)
    alpha = _resize_coarse(alpha_c, (d, hf, wf))
    hist_full = _resize_coarse(hist.reshape(4, dc, hc, wc), (d, hf, wf))
    alpha = torch.where(camera_cut, 0.0, alpha)
    out = current + (hist_full - current) * alpha[None]
    return torch.where(torch.isnan(out), current, out)


def integrate_froxels(scattering, max_distance):
    """volumetricLightingIntegration.comp — front-to-back accumulation:
    (4, D, Hf, Wf) -> rgb accumulated inscattering, a = transmittance to
    the slice's end."""
    d = scattering.shape[1]
    zs = _div(torch.arange(d + 1, dtype=torch.float32,
                           device=scattering.device), d)
    depths = froxel_uv_to_depth(zs, max_distance)
    seg_len = (depths[1:] - depths[:-1]).reshape(d, 1, 1)
    sigma = scattering[3]
    od = sigma * seg_len
    od_cum = torch.cumsum(od, dim=0)
    trans_before = torch.exp(-(od_cum - od))
    clamped = torch.clamp_min(sigma, 1e-5)
    inv_sigma = torch.full_like(clamped, 1.0) / clamped
    decay = 1.0 - torch.exp(-od)
    acc = torch.stack([
        torch.cumsum(scattering[c] * decay * inv_sigma * trans_before, dim=0)
        for c in range(3)])
    return torch.cat([acc, torch.exp(-od_cum)[None]])


def apply_froxel_fog(color, pixel_depth, integrated, max_distance, noise,
                     quarter: int = 4):
    """Per-pixel fog (triangle.frag:131-144): color * T + inscatter, the
    froxel lookup at 1/quarter resolution with the slice jittered by noise
    (H, W) in [0, 1), bilinearly upsampled."""
    _, h, w = color.shape
    _, d, hf, wf = integrated.shape
    q = quarter
    depth_q = point_downsample(pixel_depth, q, q)
    noise_q = point_downsample(noise, q, q)
    hq, wq = depth_q.shape
    uvz = depth_to_froxel_uvz(torch.clamp_min(depth_q, 1e-4), max_distance)
    z_idx = torch.clamp(((uvz + (noise_q - 0.5) * 0.013) * d).to(torch.int32),
                        0, d - 1).long()
    dev = color.device
    fx = torch.clamp(torch.arange(wq, device=dev) * q // (w // wf), 0, wf - 1)
    fy = torch.clamp(torch.arange(hq, device=dev) * q // (h // hf), 0, hf - 1)
    fog_q = integrated[:, z_idx, fy[:, None], fx[None, :]]
    fog = resize_bilinear(fog_q, h, w)
    return color * fog[3][None] + fog[0:3]
