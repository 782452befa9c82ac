"""User-facing render settings, copied field for field from the JAX package.

Parity: plainrenderer_tpu/config.py, plus ShadingConfig
(plainrenderer_tpu/ops/shade.py:34) and AtmosphereSettings
(plainrenderer_tpu/ops/sky.py:40), which the JAX package defines beside
their users. The copies live here because the port imports nothing of the
JAX package; tests/test_torch_config.py holds the fields and defaults
equal.

All dataclasses are frozen, so a settings object is hashable and can key
caches exactly as it keys jit specializations on the JAX side.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """RenderFrontend.h:32-38 — the main-pass shading switches."""

    diffuse_brdf: int = 2  # 0 lambert, 1 disney, 2 CoD-WWII (default), 3 titanfall2
    direct_multiscatter_brdf: int = 0  # 0 McAuley, 1 simplified, 2 scaled-GGX, 3 none
    use_indirect_multiscatter: bool = True
    use_geometric_aa: bool = True
    indirect_lighting_tech: int = 0  # 0 SDF-traced, 1 constant ambient
    # material texture filter: 0 bilinear within the tile mip, 1 per-pixel
    # trilinear across two mips, 2 trilinear + 3-tap anisotropic
    texture_filter: int = 0
    # window the tile's second material too (texture slice)
    texture_two_mat: bool = True


@dataclasses.dataclass(frozen=True)
class AtmosphereSettings:
    """Techniques/Sky.h:6-15 (everything in km)."""

    scattering_rayleigh_ground: tuple = (0.0058, 0.0135, 0.0331)
    earth_radius: float = 6371.0
    atmosphere_height: float = 100.0
    ozone_extinction: tuple = (0.000650, 0.001881, 0.000085)
    scattering_mie_ground: float = 0.006
    extinction_mie_factor: float = 1.11
    mie_scattering_exponent: float = 0.76

    @property
    def extinction_mie_ground(self):
        return self.extinction_mie_factor * self.scattering_mie_ground


@dataclasses.dataclass(frozen=True)
class TAASettings:
    """TAA.h:8-17."""

    enabled: bool = True
    use_separate_supersampling: bool = False
    use_clipping: bool = True
    use_motion_vector_dilation: bool = True
    history_sampling_tech: int = 4  # 0 bilinear, 1..4 bicubic 16/9/5/1-tap
    supersample_use_tonemapping: bool = True
    filter_use_tonemapping: bool = True
    use_mip_bias: bool = True


@dataclasses.dataclass(frozen=True)
class SDFTraceSettings:
    """SDFGI.h:17-29."""

    enabled: bool = True
    half_resolution: bool = True
    strict_influence_radius_cutoff: bool = False  # SDFGI.h:21
    influence_radius: float = 3.0
    trace_steps: int = 128  # reference trace loop length (SDF.inc:144)
    coarse_fallback: bool = True


@dataclasses.dataclass(frozen=True)
class VolumetricsSettings:
    """Volumetrics.h:5-18 (incl. wind)."""

    enabled: bool = True
    max_distance: float = 30.0
    base_density: float = 0.005
    noise_density: float = 0.01
    ambient: float = 0.02  # froxelLightScattering.comp:57 constantAmbient
    scattering_coefficient: float = 1.0
    absorption_coefficient: float = 0.1
    phase_g: float = 0.2
    wind_speed: float = 0.5
    wind_direction_deg: float = 45.0


@dataclasses.dataclass(frozen=True)
class BloomSettings:
    """Bloom.h:5-9."""

    enabled: bool = True
    strength: float = 0.02
    blur_radius: float = 1.5
    mip_count: int = 6


@dataclasses.dataclass(frozen=True)
class SDFDebugSettings:
    """SDFGI.h:9-15 — SDF debug visualisation (0 none, 1 lit SDF, 2 trace
    window occupancy, 3 normals, 4 raymarch steps)."""

    visualisation_mode: int = 0


@dataclasses.dataclass(frozen=True)
class ShadowSettings:
    """Cascaded sun shadows (RenderFrontend shadow constants + lightMatrix)."""

    cascade_count: int = 3  # ShadingConfig default (RenderFrontend.h:37)
    resolution: int = 2048  # reference shadowMapRes (RenderFrontend.cpp:40)
    pcf_taps: int = 12  # triangle.frag:110
    sample_radius: float = 0.03  # world-space, sunShadowCascades.inc:5
    debug_cascade_colors: bool = False  # sunShadowCascades.inc:23-31 tint


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Top-level bundle; hashable."""

    width: int = 1920
    height: int = 1080
    shading: ShadingConfig = ShadingConfig()
    taa: TAASettings = TAASettings()
    sdf_trace: SDFTraceSettings = SDFTraceSettings()
    sdf_debug: SDFDebugSettings = SDFDebugSettings()
    volumetrics: VolumetricsSettings = VolumetricsSettings()
    bloom: BloomSettings = BloomSettings()
    shadows: ShadowSettings = ShadowSettings()
    atmosphere: AtmosphereSettings = AtmosphereSettings()
    # GlobalShaderInfo scalar knobs (ResourceDescriptions.h:174-201)
    sun_illuminance: float = 128000.0
    exposure_offset: float = 1.0
    exposure_adaption_speed: float = 2.0
    sun_direction_angles: tuple = (0.0, 45.0)  # (phi, theta) deg
    # debug AABB wireframes (debug.vert + RenderFrontend.cpp:947-956)
    draw_bounding_boxes: bool = False
    # raster pair-budget multiplier (see render/frame.py main_view_setup)
    pair_budget_scale: float = 1.0
