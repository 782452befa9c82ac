"""Physically based sky (Hillaire 2020) (plainrenderer_tpu/ops/sky.py).

The transmission and multiscatter LUT bakes, the per-frame sky LUT, the
sun colour towards the sun, per-pixel view directions and the sky
composite with the analytic sun disc. Same math and evaluation strategy as
the JAX package (direct quadrature of sun transmittance, sky LUT sampled on
a 1/8-resolution grid and bilinearly upsampled), except that its gather-free
one-hot matmul lookup becomes a plain indexed bilinear lookup.
"""

from __future__ import annotations

import math

import torch

from .. import device as device_mod
from ..config import AtmosphereSettings
from ..utils.stencil import point_downsample

TRANSMISSION_LUT_SIZE = (128, 128)  # Sky.cpp:5
MULTISCATTER_LUT_SIZE = (32, 32)
SKY_LUT_SIZE = (100, 200)  # (height=y, width=x)
SUN_DIAMETER_DEG = 0.535  # Sky.cpp:243
SKY_COARSE = 8  # screen subsampling of the sky LUT lookup (sky.py:432)


def _f32(values, device):
    """A small f32 constant vector built with fills (no host-to-device
    copy, which would wait for the device in the middle of a frame)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _coefficients(height, s: AtmosphereSettings):
    """sky.inc:12-42 — per-height (scatter_rayleigh (...,3), scatter_mie
    (...,1), extinction (...,3))."""
    rayleigh = torch.exp(-height / 8.0)[..., None]
    mie = torch.exp(-height / 1.2)[..., None]
    ozone = torch.clamp_min(1.0 - torch.abs(height - 25.0) / 15.0,
                            0.0)[..., None]
    sr = _f32(s.scattering_rayleigh_ground, height.device)
    oz = _f32(s.ozone_extinction, height.device)
    scatter_r = rayleigh * sr
    scatter_m = mie * s.scattering_mie_ground
    extinction = rayleigh * sr + mie * s.extinction_mie_ground + ozone * oz
    return scatter_r, scatter_m, extinction


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _ray_earth_intersection(p, d, s: AtmosphereSettings):
    """sky.inc:60-82 — (distance to earth or atmosphere top, hit_earth)."""
    l = -p
    t_ca = torch.sum(l * d, dim=-1)
    d2 = torch.clamp_min(torch.sum(l * l, dim=-1) - t_ca * t_ca, 0.0)
    er = s.earth_radius
    under = er * er - d2
    t_hc_earth = torch.sqrt(torch.clamp_min(under, 0.0))
    t_earth = t_ca - t_hc_earth
    hit_earth = (under >= 0.0) & (t_earth >= 0.0)
    r = er + s.atmosphere_height
    t_hc_atm = torch.sqrt(torch.clamp_min(r * r - d2, 0.0))
    t_atm = t_ca + torch.abs(t_hc_atm)
    return torch.where(hit_earth, t_earth, t_atm), hit_earth


def _phase_rayleigh(vol):
    """volumeShading.inc:14-16."""
    return 3.0 / (16.0 * math.pi) * (1.0 + vol * vol)


def _phase_cornette_shanks(vol, g):
    """volumeShading.inc:18-22."""
    nom = 3.0 / (8.0 * math.pi) * (1.0 - g * g) * (1.0 + vol * vol)
    den = (2.0 + g * g) * torch.pow(1.0 + g * g - 2.0 * g * vol, 1.5)
    return nom / den


def integrate_inscattering(inscattering, extinction, length):
    """volumeShading.inc:25-28 — analytic per-segment integration."""
    return (inscattering - inscattering * torch.exp(-extinction * length)) / (
        torch.clamp_min(extinction, 1e-5))


def _sun_transmittance(pos, sun_dir, s: AtmosphereSettings,
                       samples: int = 16):
    """Transmittance from pos (..., 3) towards the sun by quadrature."""
    sun_dir = torch.broadcast_to(sun_dir.to(torch.float32), pos.shape)
    dist, hit_earth = _ray_earth_intersection(pos, sun_dir, s)
    step = dist / samples
    ts = torch.arange(samples, dtype=torch.float32, device=pos.device) + 0.5
    sample_pos = pos[..., None, :] + (
        sun_dir[..., None, :] * (ts[:, None] * step[..., None, None]))
    height = torch.clamp_min(_norm(sample_pos) - s.earth_radius, 0.0)
    _, _, extinction = _coefficients(height, s)
    optical_depth = torch.sum(extinction * step[..., None, None], dim=-2)
    trans = torch.exp(-optical_depth)
    return torch.where(hit_earth[..., None], 0.0, trans)


def bake_transmission_lut(settings: AtmosphereSettings, device="cuda"):
    """skyTransmissionLut.comp — (3, 128, 128) transmittance LUT, 40-sample
    march per texel."""
    device = device_mod.resolve(device)
    samples = 40
    h_count, w_count = TRANSMISSION_LUT_SIZE
    s = settings
    x = torch.arange(w_count, dtype=torch.float32, device=device) / (w_count - 1)
    y = torch.arange(h_count, dtype=torch.float32, device=device) / (h_count - 1)
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    height = xg * s.atmosphere_height
    updot = torch.clamp_min(yg * 2.0 - 1.0, -0.999)
    v = torch.stack([torch.zeros_like(updot), -updot,
                     torch.sqrt(torch.clamp_min(1.0 - updot * updot, 0.0))],
                    dim=-1)
    p = torch.stack([torch.zeros_like(height), -(height + s.earth_radius),
                     torch.zeros_like(height)], dim=-1)
    dist, hit_earth = _ray_earth_intersection(p - 0.01, v, s)
    path = torch.clamp_min(dist, 0.01)
    step = path / samples
    ts = torch.arange(samples, dtype=torch.float32, device=device) + 0.5
    sample_pos = p[..., None, :] + v[..., None, :] * (
        ts[:, None] * step[..., None, None])
    hgt = torch.clamp_min(_norm(sample_pos) - s.earth_radius, 0.0)
    _, _, extinction = _coefficients(hgt, s)
    od = torch.sum(extinction * step[..., None, None], dim=-2)
    trans = torch.where(hit_earth[..., None], 0.0, torch.exp(-od))
    return trans.permute(2, 0, 1).contiguous()


def bake_multiscatter_lut(settings: AtmosphereSettings, device="cuda"):
    """skyMultiscatterLut.comp — 2nd-order scattering factor (3, 32, 32):
    8x8 directions x 20 steps, earth albedo 0.3, isotropic phase,
    F_ms = 1/(1-f_ms)."""
    device = device_mod.resolve(device)
    s = settings
    h_count, w_count = MULTISCATTER_LUT_SIZE
    x = torch.arange(w_count, dtype=torch.float32, device=device) / w_count
    y = torch.arange(h_count, dtype=torch.float32, device=device) / h_count
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    height = xg * s.atmosphere_height
    updot = yg * 2.0 - 1.0
    sun_l = torch.stack([torch.zeros_like(updot), -updot,
                         torch.sqrt(torch.clamp_min(1.0 - updot * updot, 0.0))],
                        dim=-1)
    p = torch.stack([torch.zeros_like(height), -(height + s.earth_radius),
                     torch.zeros_like(height)], dim=-1)

    n_sqrt = 8
    inner = 20
    iso_phase = 1.0 / (4.0 * math.pi)
    li = torch.arange(n_sqrt, dtype=torch.float32, device=device)
    theta = math.pi * li / n_sqrt
    phi = 2.0 * math.pi * li / n_sqrt
    tt, _ = torch.meshgrid(theta, phi, indexing="ij")
    sin_t = torch.sin(tt)
    cos_t = torch.cos(tt)
    # skyMultiscatterLut.comp:49's direction set, sinTheta^2 z included
    dirs = torch.stack([sin_t * cos_t, -cos_t, sin_t * sin_t],
                       dim=-1).reshape(-1, 3)
    sin_weights = sin_t.reshape(-1)
    ground = torch.broadcast_to(_f32([0.0, -s.earth_radius, 0.0], device),
                                p.shape)
    t_to_ground = _sun_transmittance(ground, sun_l, s, samples=12)

    l2nd = torch.zeros_like(p)
    fms = torch.zeros_like(p)
    for idx in range(n_sqrt * n_sqrt):
        v = dirs[idx]
        sinw = sin_weights[idx]
        dist, hit_earth = _ray_earth_intersection(
            p, torch.broadcast_to(v, p.shape), s)
        step = dist / inner
        hit_pos = p + dist[..., None] * v
        earth_n = hit_pos / torch.clamp_min(_norm(hit_pos)[..., None], 1e-6)
        earth_nol = torch.clamp(torch.sum(earth_n * sun_l, dim=-1), 0.0, 1.0)
        earth_lit = 0.3 / math.pi * t_to_ground * earth_nol[..., None]
        direct = torch.where(hit_earth[..., None], earth_lit, 0.0)

        transmission = torch.ones_like(p)
        inscattered = torch.zeros_like(p)
        l_f = torch.zeros_like(p)
        for i in range(inner):
            pos = p + v * ((i + 1.0) * step[..., None])
            hgt = torch.clamp_min(_norm(pos) - s.earth_radius, 0.0)
            scat_r, scat_m, ext = _coefficients(hgt, s)
            scat = scat_r + scat_m
            t_sun = _sun_transmittance(pos, sun_l, s, samples=8)
            ci = integrate_inscattering(scat, ext, step[..., None])
            l_f = l_f + ci * transmission
            inscattered = inscattered + ci * t_sun * iso_phase * transmission
            transmission = transmission * torch.exp(-ext * step[..., None])
        l2nd = l2nd + (direct * transmission + inscattered) * sinw
        fms = fms + l_f * sinw
    inv = 1.0 / (n_sqrt * n_sqrt)
    fms = fms * inv
    l2nd = l2nd * inv
    multi = l2nd / torch.clamp_min(1.0 - fms, 1e-4)
    return multi.permute(2, 0, 1).contiguous()


def _to_sky_lut_uv(v):
    """sky.inc:85-93 toSkyLut — direction (..., 3) -> uv (..., 2)."""
    theta = torch.arccos(torch.clamp(-v[..., 1], -1.0, 1.0))
    y = theta / math.pi
    y_low = y * 2.0 - 1.0
    y = torch.sign(y_low) * torch.sqrt(torch.abs(y_low)) * 0.5 + 0.5
    phi = -torch.atan2(v[..., 2], v[..., 0])
    return torch.stack([phi / (2.0 * math.pi) + 0.5, y], dim=-1)


def _from_sky_lut_uv(uv):
    """sky.inc:95-103 fromSkyLut — uv (..., 2) -> direction (..., 3)."""
    theta = (1.0 - uv[..., 1]) - 0.5
    theta = torch.sign(theta) * theta * theta * 2.0 * math.pi + math.pi * 0.5
    phi = (-uv[..., 0] + 0.5) * 2.0 * math.pi
    return torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                        torch.sin(theta) * torch.sin(phi)], dim=-1)


def bilinear_lookup(lut, u, v):
    """Bilinear lookup of lut (3, H, W) at u, v in [0, 1] (any shape) ->
    (..., 3), with the weights of the JAX package's hat-function matmul
    (sky.py:274 bilinear_lookup_matmul)."""
    _, h, w = lut.shape
    up = torch.clamp(u * (w - 1), 0.0, w - 1.0)
    vp = torch.clamp(v * (h - 1), 0.0, h - 1.0)
    x0 = torch.floor(up)
    y0 = torch.floor(vp)
    wx0, wx1 = 1.0 - (up - x0), 1.0 - ((x0 + 1.0) - up)
    wy0, wy1 = 1.0 - (vp - y0), 1.0 - ((y0 + 1.0) - vp)
    xi0 = x0.long()
    yi0 = y0.long()
    xi1 = torch.clamp_max(xi0 + 1, w - 1)
    yi1 = torch.clamp_max(yi0 + 1, h - 1)
    # a corner past the grid edge has weight 0 (the hat has no node there)
    wx1 = torch.where(xi0 + 1 <= w - 1, wx1, 0.0)
    wy1 = torch.where(yi0 + 1 <= h - 1, wy1, 0.0)
    row0 = lut[:, yi0, xi0] * wx0 + lut[:, yi0, xi1] * wx1
    row1 = lut[:, yi1, xi0] * wx0 + lut[:, yi1, xi1] * wx1
    return (row0 * wy0 + row1 * wy1).permute(*range(1, u.dim() + 1), 0)


def bake_sky_lut(sun_direction, sun_strength_exposed, multiscatter_lut,
                 settings: AtmosphereSettings):
    """skyLut.comp — per-frame sky radiance LUT (3, 100, 200): 30-step
    single-scatter march with Rayleigh + Cornette-Shanks phases, analytic
    earth shadow, plus the multiscatter LUT term; vectorized over
    (texel, step)."""
    s = settings
    dev = multiscatter_lut.device
    samples = 30
    h_count, w_count = SKY_LUT_SIZE
    x = torch.arange(w_count, dtype=torch.float32, device=dev) / w_count
    y = torch.arange(h_count, dtype=torch.float32, device=dev) / h_count
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    v = _from_sky_lut_uv(torch.stack([xg, yg], dim=-1))  # (H, W, 3)

    bias = 0.002
    p0 = _f32([0.0, -s.earth_radius - bias, 0.0], dev)
    p = torch.broadcast_to(p0, v.shape)
    dist, _ = _ray_earth_intersection(p, v, s)
    step = dist / samples

    sun_l = sun_direction.to(torch.float32)
    vol = torch.sum(v * sun_l, dim=-1)
    ph_r = _phase_rayleigh(vol)[..., None, None]
    ph_m = _phase_cornette_shanks(vol, s.mie_scattering_exponent)[..., None,
                                                                   None]

    ts = torch.arange(1, samples + 1, dtype=torch.float32, device=dev)
    pos = p[..., None, :] + v[..., None, :] * (
        ts[None, None, :, None] * step[..., None, None])
    pos_len = _norm(pos)
    height = torch.clamp_min(pos_len - s.earth_radius, 0.0)
    up = pos / torch.clamp_min(pos_len[..., None], 1e-6)

    transmission = _sun_transmittance(pos, sun_l, s, samples=10)
    # analytic earth-shadow ray (skyLut.comp:25-35)
    lp = -pos
    t_ca = torch.sum(lp * sun_l, dim=-1)
    d2 = torch.sum(lp * lp, dim=-1) - t_ca * t_ca
    under = s.earth_radius ** 2 - d2
    t_earth = t_ca - torch.sqrt(torch.clamp_min(under, 0.0))
    lit = torch.where((under >= 0) & (t_earth > 0), 0.0, 1.0)[..., None]
    incoming = sun_strength_exposed * transmission * lit

    scat_r, scat_m, ext = _coefficients(height, s)
    step_e = step[..., None, None]
    od = ext * step_e
    od_before = torch.cumsum(od, dim=-2) - od
    absorption = torch.exp(-od_before)

    inscatter = scat_r * incoming * ph_r + scat_m * incoming * ph_m
    integral = integrate_inscattering(inscatter, ext, step_e)

    up_dot_l = torch.sum(up * sun_l, dim=-1)
    ms = bilinear_lookup(
        multiscatter_lut,
        torch.clamp(height / s.atmosphere_height, 0.0, 1.0),
        torch.clamp(up_dot_l * 0.5 + 0.5, 0.0, 1.0))
    # the reference multiplies the multiscatter term by the SUN
    # transmittance, not the view-path absorption (skyLut.comp:96)
    color = torch.sum(
        integral * absorption
        + ms * incoming * (scat_r + scat_m) * step_e * transmission, dim=-2)
    return color.permute(2, 0, 1).contiguous()


def sample_transmission_towards_sun(transmission_lut, sun_direction):
    """preExposeLights.comp:88-89 — transmission at ground level towards the
    sun: lutUV = (0, -sunDir.y * 0.5 + 0.5)."""
    h = transmission_lut.shape[1]
    uy = torch.clamp(-sun_direction[1] * 0.5 + 0.5, 0.0, 1.0) * (h - 1)
    y0 = torch.floor(uy)
    f = uy - y0
    y0i = y0.long().reshape(1)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    # index_select keeps the device index on the device (indexing with a
    # 0-d tensor reads it back to the host)
    column = transmission_lut[:, :, 0]
    return torch.index_select(column, 1, y0i)[:, 0] * (1 - f) \
        + torch.index_select(column, 1, y1i)[:, 0] * f


def view_directions(width, height, cam_forward, cam_up, cam_right,
                    tan_fov_half, aspect):
    """screenToWorld.inc:4-9 — per-pixel ray directions (camera -> scene),
    channel-planar (3, H, W): forward + tan*(aspect*x*right - y*up)."""
    dev = cam_forward.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / height * 2.0 - 1.0
    ndc_x = xs[None, :].expand(height, width)
    ndc_y = ys[:, None].expand(height, width)
    f, u, r = cam_forward, cam_up, cam_right
    d = torch.stack([
        f[c] + tan_fov_half * aspect * ndc_x * r[c]
        - tan_fov_half * ndc_y * u[c]
        for c in range(3)])
    return d * torch.rsqrt(torch.sum(d * d, dim=0, keepdim=True))


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in, out) triangle-kernel weights of jax.image.resize (linear, no
    translation), with its normalisation and out-of-range zeroing."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)  # antialias: widen when shrinking
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.0 * inv_scale - 0.5)
    grid = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - grid[:, None]) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * 1.1920929e-07,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int):
    """jax.image.resize(img (C, h, w), (C, out_h, out_w), 'bilinear')."""
    _, h, w = img.shape
    out = img
    if h != out_h:
        out = torch.einsum("chw,hH->cHw", out,
                           _resize_weights(h, out_h, img.device))
    if w != out_w:
        out = torch.einsum("chw,wW->chW", out,
                           _resize_weights(w, out_w, img.device))
    return out


def apply_sky(color, depth_valid, sky_lut, transmission_lut, view_dirs_full,
              sun_direction, sun_strength_exposed):
    """Composite sky radiance + sun disc into sky pixels (sky.py:431).

    The sky LUT is sampled at 1/SKY_COARSE resolution and bilinearly
    upsampled; the limb-darkened sun disc is analytic at full resolution
    (sunSprite.frag)."""
    _, h, w = color.shape
    dirs_coarse = point_downsample(view_dirs_full, SKY_COARSE,
                                   SKY_COARSE).permute(1, 2, 0)
    uv = _to_sky_lut_uv(dirs_coarse)
    # wrap-pad the LUT in x: u = 1 lands on the seam copy
    lut_wrapped = torch.cat([sky_lut, sky_lut[:, :, :1]], dim=2)
    sky_coarse = bilinear_lookup(
        lut_wrapped, torch.remainder(uv[..., 0], 1.0),
        torch.clamp(uv[..., 1], 0.005, 0.995))
    sky_full = resize_bilinear(sky_coarse.permute(2, 0, 1), h, w)

    sun_l = sun_direction.to(torch.float32)
    cos_to_sun = (view_dirs_full[0] * sun_l[0] + view_dirs_full[1] * sun_l[1]
                  + view_dirs_full[2] * sun_l[2])
    sun_radius = math.radians(SUN_DIAMETER_DEG) * 0.5
    angle = torch.arccos(torch.clamp(cos_to_sun, -1.0, 1.0))
    dist2 = torch.clamp((angle / sun_radius) ** 2, 0.0, 1.0)
    in_disc = (angle < sun_radius) & (view_dirs_full[1] < 0.35)
    sun_color = sample_transmission_towards_sun(transmission_lut, sun_l)
    mu = torch.sqrt(torch.clamp_min(1.0 - dist2, 0.0))
    limb_coeff = (0.482, 0.511, 0.643)  # sunSprite.frag:23-31
    alpha = (1.0 - dist2) ** 2
    mu_safe = torch.clamp_min(mu, 1e-6)
    sun_contrib = torch.stack([
        torch.pow(mu_safe, limb_coeff[c]) * sun_color[c]
        * sun_strength_exposed * alpha for c in range(3)])
    sky_full = sky_full + torch.where(in_disc[None], sun_contrib, 0.0)
    return torch.where(depth_valid[None], color, sky_full)
