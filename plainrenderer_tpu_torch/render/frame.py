"""The per-frame pass graph (plainrenderer_tpu/render/frame.py).

This slice renders the opaque main view: exposure histogram -> exposure
-> sky LUT -> frustum cull -> geometry setup -> binning (kernel A) ->
G-buffer raster (kernel B) -> material lookup (kernel C) -> forward shade
-> sky composite -> tonemap. Every setting outside it (shadows, SDF GI,
TAA, bloom, fog, textures, alpha masks, dynamic objects, split-frame
bands, debug views) raises NotImplementedError instead of silently
skipping its pass. render_frame runs eagerly and never synchronises with
the host: every per-frame value stays a device tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import device as device_mod
from ..config import RenderSettings
from ..ops import exposure as exposure_ops
from ..ops import post, raster, shade, sky
from ..scene.frustum import expand_object_mask, visible_objects_clipspace
from ..utils import mathutils, noise as noise_mod
from .state import FrameState

FOV_DEG = 35.0  # CameraIntrinsic defaults (Camera.h:11-16)
NEAR_PLANE = 0.1
FAR_PLANE = 300.0


def camera_arrays(position, forward, right, up, device="cuda") -> dict:
    """Dynamic camera inputs as a dict of f32 tensors on `device`."""
    dev = device_mod.resolve(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in (("position", position), ("forward", forward),
                         ("right", right), ("up", up))}


def _view_matrix(cam: dict) -> torch.Tensor:
    rot = torch.stack([cam["right"], cam["up"], -cam["forward"]], dim=0)
    trans = -rot @ cam["position"]
    m = torch.eye(4, dtype=torch.float32, device=rot.device)
    m[:3, :3] = rot
    m[:3, 3] = trans
    return m


def _projection(settings: RenderSettings) -> np.ndarray:
    """Camera.cpp:14-27 — GL perspective + Vulkan reverse-Z correction
    (numpy f32, as the JAX package builds it)."""
    aspect = settings.width / settings.height
    tan_half = math.tan(math.radians(FOV_DEG) * 0.5)
    near, far = NEAR_PLANE, FAR_PLANE
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = 1.0 / (aspect * tan_half)
    p[1, 1] = 1.0 / tan_half
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    correction = np.asarray(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -0.5, 0.5], [0, 0, 0, 1]],
        np.float32)
    return correction @ p


def main_bin_sub(ph: int) -> int:
    """Raster-bin height (in 16px rows) for the main view: 32px when the
    padded height allows (frame.py:156)."""
    return 2 if ph % (raster.TILE_H * 2) == 0 else 1


def check_slice(scene: dict, cam: dict, settings: RenderSettings) -> None:
    """Raise NotImplementedError for anything this slice does not render."""
    unported = [
        (settings.shadows.cascade_count > 0,
         "sun shadows (shadows.cascade_count > 0)"),
        (settings.sdf_trace.enabled, "SDF GI (sdf_trace.enabled)"),
        (settings.taa.enabled, "TAA (taa.enabled)"),
        (settings.bloom.enabled, "bloom (bloom.enabled)"),
        ("tex_word0" in scene, "material textures (scene 'tex_word0')"),
        ("alpha_masks" in scene, "alpha-tested geometry (scene 'alpha_masks')"),
        ("object_transforms" in scene,
         "dynamic objects (scene 'object_transforms')"),
        ("ndc_y_scale" in cam, "split-frame band mode (cam 'ndc_y_scale')"),
        (cam["position"].dim() == 2, "camera-path mode (render_flight)"),
        (settings.draw_bounding_boxes, "draw_bounding_boxes"),
        (settings.sdf_debug.visualisation_mode != 0,
         "SDF debug views (sdf_debug.visualisation_mode != 0)"),
    ]
    missing = [name for bad, name in unported if bad]
    if missing:
        raise NotImplementedError(
            "not in this slice of the port: " + ", ".join(missing))


@dataclasses.dataclass
class MainView:
    """The main view's raster inputs for one frame."""

    view_proj: torch.Tensor  # (4, 4)
    setup: raster.TriangleSetup
    n_tiles_y: int  # bins of sub * 16 rows
    n_tiles_x: int
    sub: int
    pair_budget: int


def main_view_setup(scene: dict, cam: dict,
                    settings: RenderSettings) -> MainView:
    """Camera matrices, frustum cull and geometry setup of the main view
    (frame.py:342-420), with its bin grid and pair budget (:450)."""
    width, height = settings.width, settings.height
    pw, ph = raster.pad_resolution(width, height)
    m_sub = main_bin_sub(ph)
    nty, ntx = ph // (raster.TILE_H * m_sub), pw // raster.TILE_W
    view = _view_matrix(cam)
    view_proj = _frame_constants(settings, view.device)["projection"] @ view
    t_count = scene["corners"].shape[0]
    obj_visible = visible_objects_clipspace(
        view_proj, scene["object_bb_min"], scene["object_bb_max"])
    tri_visible = expand_object_mask(obj_visible, scene["tri_starts"],
                                     t_count)
    setup = raster.geometry_setup(
        scene["corners"], scene["corner_uvs"], scene["corner_normals"],
        scene["corner_tangents"], scene["corner_bitangents"],
        scene["tri_material"], tri_visible, view_proj, pw, ph, cull="back",
        near_w=NEAR_PLANE, bin_rows=m_sub)
    # budget sized to the culled stream (frame.py:426-451): ~2x headroom
    # over measured occupancy; overflow lands in debug_counters
    budget = int((t_count // 4 + 8 * nty * m_sub * ntx)
                 * settings.pair_budget_scale)
    return MainView(view_proj=view_proj, setup=setup, n_tiles_y=nty,
                    n_tiles_x=ntx, sub=m_sub, pair_budget=budget)


def _fill(values, dev: torch.device) -> torch.Tensor:
    """f32 constants made with fill kernels: a host-to-device copy would
    wait for the device in the middle of a frame."""
    v = np.asarray(values, np.float32)
    flat = [torch.full((), float(x), dtype=torch.float32, device=dev)
            for x in v.reshape(-1)]
    return torch.stack(flat).reshape(v.shape)


@functools.lru_cache(maxsize=8)
def _frame_constants(settings: RenderSettings, dev: torch.device) -> dict:
    """Per-settings device constants, made once and reused every frame."""
    return {
        "sun_dir": mathutils.direction_to_vector(
            _fill(settings.sun_direction_angles, dev)),
        "sun_illuminance": _fill(settings.sun_illuminance, dev),
        "exposure_offset": _fill(settings.exposure_offset, dev),
        "adaption_speed": _fill(settings.exposure_adaption_speed, dev),
        "projection": _fill(_projection(settings), dev),
    }


def _mark(timer, name: str) -> None:
    if timer is not None:
        timer.mark(name)


def raster_main_view(mv: MainView, timer=None):
    """Binning (kernel A) + G-buffer raster (kernel B) of the main view:
    (pairs, pair_edges, pair_attrs, depth, vis, gbuf). order_rows +
    row_skip: y-sorted bin segments let the raster skip sub-blocks outside
    each pair's row extent (frame.py:421-460)."""
    pairs = raster.build_pairs(mv.setup, mv.n_tiles_y, mv.n_tiles_x,
                               pair_budget=mv.pair_budget, bin_rows=mv.sub,
                               order_rows=True)
    pair_edges, pair_attrs = raster.gather_pair_setups(
        mv.setup, pairs, row_extents=True)
    _mark(timer, "gbuffer")
    depth, vis, gbuf = raster.rasterize_gbuffer(
        pair_edges, pair_attrs, pairs, mv.n_tiles_y, mv.n_tiles_x,
        sub=mv.sub, row_skip=True)
    return pairs, pair_edges, pair_attrs, depth, vis, gbuf


def render_frame(state: FrameState, scene: dict, cam: dict, luts: dict,
                 delta_time, settings: RenderSettings, device="cuda",
                 timer=None):
    """One frame: (image_u8 (H, W, 3), FrameState').

    All inputs must lie on `device`. timer (utils.timing.PassTimer) records
    a CUDA event at each pass boundary; None records nothing."""
    dev = device_mod.resolve(device)
    if state.prev_color.device.type != dev.type:
        raise ValueError(f"state lies on {state.prev_color.device}, "
                         f"render_frame was asked for {dev}")
    check_slice(scene, cam, settings)
    f32 = dict(dtype=torch.float32, device=dev)
    width, height = settings.width, settings.height
    pw, ph = raster.pad_resolution(width, height)
    consts = _frame_constants(settings, state.prev_color.device)
    sun_dir = consts["sun_dir"]
    if not isinstance(delta_time, torch.Tensor):
        delta_time = torch.full((), float(delta_time), **f32)

    # --- exposure from the previous frame's color ---
    _mark(timer, "exposure")
    histogram = exposure_ops.compute_histogram(state.prev_color,
                                               state.exposure)
    new_exposure, sun_strength_exposed = exposure_ops.pre_expose_lights(
        histogram, state.exposure,
        consts["sun_illuminance"], consts["exposure_offset"],
        consts["adaption_speed"], delta_time.to(torch.float32),
        float(width * height),
        # frame 0 sees a black history and frame 1 the first real one:
        # snap exposure for both
        camera_cut=state.frame_index <= 1)
    sun_color = sky.sample_transmission_towards_sun(luts["transmission"],
                                                    sun_dir)

    # --- sky LUT ---
    _mark(timer, "sky")
    sky_lut = sky.bake_sky_lut(sun_dir, sun_strength_exposed,
                               luts["multiscatter"],
                               settings=settings.atmosphere)

    # --- cull + setup + binning (kernel A) + G-buffer raster (kernel B) ---
    _mark(timer, "binning")
    mv = main_view_setup(scene, cam, settings)
    pairs, _, _, depth, vis, gbuf = raster_main_view(mv, timer)
    valid = vis >= 0

    # --- material constants (kernel C) ---
    _mark(timer, "material")
    mat_packed = gbuf[raster._CH_MAT]
    mat_id = torch.floor(mat_packed * 0.5)
    material = post.material_lookup(scene["material_table"], mat_id, valid)

    # --- forward shade ---
    _mark(timer, "shade")
    inv_vp = torch.linalg.inv_ex(mv.view_proj).inverse
    world_pos = shade.reconstruct_world_position(depth, inv_vp, pw, ph)
    # raster packs mat * 2 + (handedness < 0); B = handedness * cross(N, T)
    handedness = 1.0 - 2.0 * (mat_packed - 2.0 * mat_id)
    geo_n = gbuf[raster._CH_N:raster._CH_N + 3]
    geo_t = gbuf[raster._CH_T:raster._CH_T + 3]
    geo_b = torch.linalg.cross(geo_n, geo_t, dim=0) * handedness[None]
    geo_b = geo_b * torch.rsqrt(torch.clamp_min(
        torch.sum(geo_b * geo_b, dim=0, keepdim=True), 1e-20))
    albedo = material[0:3]
    rough_metal = torch.stack(
        [torch.ones_like(material[3]), material[3], material[4]], dim=0)
    hdr = shade.shade_forward(
        config=settings.shading, world_pos=world_pos, geo_normal=geo_n,
        tangent=geo_t, bitangent=geo_b, valid=valid,
        albedo_srgb_linear=albedo,
        normal_ts=torch.zeros((2, ph, pw), **f32), specular=rough_metal,
        sun_direction=sun_dir, sun_color=sun_color,
        sun_strength_exposed=sun_strength_exposed,
        sun_shadow=torch.ones((ph, pw), **f32),
        camera_position=cam["position"])

    # --- sky composite ---
    _mark(timer, "sky")
    tan_fov_half = math.tan(math.radians(FOV_DEG) * 0.5)
    view_dirs = sky.view_directions(pw, ph, cam["forward"], cam["up"],
                                    cam["right"], tan_fov_half,
                                    width / height)
    hdr = sky.apply_sky(hdr, valid, sky_lut, luts["transmission"],
                        view_dirs, sun_dir, sun_strength_exposed)

    # --- tonemap ---
    _mark(timer, "tonemap")
    time = state.frame_index.to(torch.float32) * 0.016
    image = post.tonemap_pass(hdr, time)[:height, :width]
    _mark(timer, "end")

    new_state = dataclasses.replace(
        state,
        frame_index=state.frame_index + 1,
        exposure=new_exposure,
        prev_color=hdr,
        prev_depth=depth,
        prev_view_projection=mv.view_proj,
        prev_jitter=torch.zeros(2, **f32),
        debug_counters=torch.stack(
            [pairs.overflow, torch.zeros_like(pairs.overflow)]).to(
                torch.int32),
    )
    return image, new_state


def scene_to_device(rs, device="cuda") -> dict:
    """RenderScene (numpy) -> the tensor dict render_frame reads."""
    dev = device_mod.resolve(device)
    if rs.tex_word0 is not None or rs.alpha_masks is not None:
        raise NotImplementedError(
            "textured / alpha-tested scenes arrive in later slices")

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return {
        "corners": put(rs.corners),
        "corner_uvs": put(rs.corner_uvs),
        "corner_normals": put(rs.corner_normals),
        "corner_tangents": put(rs.corner_tangents),
        "corner_bitangents": put(rs.corner_bitangents),
        "tri_material": put(rs.tri_material),
        "tri_object": put(rs.tri_object),
        "material_table": put(rs.material_table),
        "object_bb_min": put(rs.object_bb_min),
        "object_bb_max": put(rs.object_bb_max),
        # first-triangle index per object (triangles are object-contiguous)
        "tri_starts": put(np.searchsorted(
            rs.tri_object[:rs.triangle_count],
            np.arange(rs.object_count)).astype(np.int32)),
        # build-pose inverses for dynamic scenes (frame.py:1174-1179)
        "object_build_inv": put(np.linalg.inv(
            np.asarray(rs.object_matrices, np.float64)).astype(np.float32)),
    }


@functools.lru_cache(maxsize=4)
def _blue_noise_textures(count: int = 4, size: int = 32) -> np.ndarray:
    """RenderFrontend.cpp:40-56 — 4 void-and-cluster blue-noise tiles."""
    tiles = [
        noise_mod.generate_blue_noise((size, size), seed=i).astype(np.float32)
        / 255.0
        for i in range(count)
    ]
    return np.stack(tiles)


def bake_static_luts(settings: RenderSettings, device="cuda") -> dict:
    """Atmosphere-dependent LUTs + noise (rebaked only on settings change)."""
    dev = device_mod.resolve(device)
    return {
        "transmission": sky.bake_transmission_lut(settings.atmosphere, dev),
        "multiscatter": sky.bake_multiscatter_lut(settings.atmosphere, dev),
        "blue_noise": torch.as_tensor(_blue_noise_textures(), device=dev),
    }
