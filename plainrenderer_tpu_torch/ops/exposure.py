"""Histogram auto exposure (plainrenderer_tpu/ops/exposure.py).

A 128-bin log-luminance histogram of the previous frame's colour
(un-exposed by the previous exposure), then preExposeLights.comp: mean of
the [50%, 95%] percentile band, scene EV100 with the CoD:AW offset curve,
adaption-speed-clamped exposure. The JAX package counts bins with a sort
and binary searches (no scatters on the TPU); here one bincount gives the
same exact counts.
"""

from __future__ import annotations

import torch

from ..utils.stencil import point_downsample

N_BINS = 128  # RenderFrontend.cpp:46
MIN_LUMINANCE = 0.001  # RenderFrontend.cpp:1066
MAX_LUMINANCE = 200000.0  # RenderFrontend.cpp:1067
DOWNSAMPLE = 4  # histogram input stride per axis (exposure.py:32)


def _log_f32(x: float, device) -> torch.Tensor:
    """log of the float32 x, in float32 (as jnp.log of a Python float);
    built with a fill, not a host-to-device copy."""
    return torch.log(torch.full((), x, dtype=torch.float32, device=device))


def compute_histogram(color, previous_exposure):
    """color (3, H, W) -> (N_BINS,) f32 counts of every DOWNSAMPLE-th pixel
    per axis, rescaled by DOWNSAMPLE^2 so percentages match the
    full-resolution histogram."""
    lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
    lum = point_downsample(lum, DOWNSAMPLE, DOWNSAMPLE)
    lum = lum / torch.clamp_min(previous_exposure, 1e-9)
    log_min = _log_f32(MIN_LUMINANCE, color.device)
    log_max = _log_f32(MAX_LUMINANCE, color.device)
    t = torch.clamp((torch.log(torch.clamp_min(lum, 1e-12)) - log_min)
                    / (log_max - log_min), 0.0, 1.0)
    bins = (t * (N_BINS - 1)).to(torch.int64).reshape(-1)
    # scatter-add, not bincount: bincount sizes its output from bins.max()
    # and so waits for the device
    counts = torch.zeros(N_BINS, dtype=torch.int32, device=color.device)
    counts.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    return counts.to(torch.float32) * float(DOWNSAMPLE * DOWNSAMPLE)


def _offset_from_scene_ev(scene_ev100):
    """preExposeLights.comp:27-38 — CoD:AW scene-EV offset curve."""
    dark_exp, light_exp = 2.84, 12.81
    light_offset, dark_offset = 1.47, -3.17
    t = torch.clamp((scene_ev100 - dark_exp) / (light_exp - dark_offset),
                    0.0, 1.0)
    return dark_offset + (light_offset - dark_offset) * t


def pre_expose_lights(histogram, previous_exposure, sun_strength,
                      exposure_offset, adaption_speed_ev_per_sec, delta_time,
                      pixel_count, camera_cut=False):
    """preExposeLights.comp:40-89 — (exposure, sun_strength_exposed).
    camera_cut (bool tensor) snaps to the target exposure."""
    dev = histogram.device
    log_min = _log_f32(MIN_LUMINANCE, dev)
    log_max = _log_f32(MAX_LUMINANCE, dev)
    cum = torch.cumsum(histogram, dim=0)
    pct = cum / pixel_count
    in_band = (pct < 0.95) & (pct >= 0.5)
    bin_values = torch.exp(
        log_min + (log_max - log_min)
        * torch.arange(N_BINS, dtype=torch.float32, device=dev)
        / (N_BINS - 1.0))
    counted = torch.sum(torch.where(in_band, histogram, 0.0))
    mean = torch.sum(torch.where(in_band, histogram * bin_values, 0.0)) / (
        torch.clamp_min(counted, 1.0))

    scene_ev100 = torch.log2(torch.clamp_min(mean * 100.0 / 12.5, 1e-9))
    offset = _offset_from_scene_ev(scene_ev100) + exposure_offset
    target_ev100 = torch.clamp_min(scene_ev100 - offset, 10.0)
    previous_ev100 = torch.log2(
        1.0 / (torch.clamp_min(previous_exposure, 1e-6) * 1.2))
    ev_delta = target_ev100 - previous_ev100
    ev_max_change = torch.as_tensor(
        adaption_speed_ev_per_sec * delta_time, dtype=torch.float32,
        device=dev)
    ev_change = torch.sign(ev_delta) * torch.minimum(
        torch.abs(ev_delta), torch.abs(ev_max_change))
    current_ev100 = torch.where(torch.as_tensor(camera_cut, device=dev),
                                target_ev100, previous_ev100 + ev_change)
    exposure = 1.0 / (torch.pow(2.0, current_ev100) * 1.2)
    return exposure, sun_strength * exposure

