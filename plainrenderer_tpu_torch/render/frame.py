"""The per-frame pass graph (plainrenderer_tpu/render/frame.py).

The port renders the default RenderSettings() on opaque static scenes:
exposure histogram -> exposure -> sky LUT -> TAA-jittered camera ->
frustum cull -> geometry setup -> binning (kernel A) -> G-buffer raster
(kernel B) -> material lookup (kernel C) -> texture sampling (kernel D,
textured scenes) -> cascade fit -> shadow-atlas setup, binning (kernel A)
and depth raster (kernel E) -> PCF shadow resolve (kernel F) -> GI trace
(kernel G, scenes with an attached SDF) -> resolve, spatial, history
resample (kernel H), temporal, spatial -> upscale -> forward shade -> sky
composite -> froxel fog (with shadows) -> TAA (history taps, kernel I) ->
bloom -> tonemap. A scene with alpha masks splits the main view and the
atlas into an opaque stream (kernels A, B, E) and an alpha-tested stream
(kernels A, K + L, J), merged by depth. A scene with object_transforms
moves its objects every frame: the transformed corners and bounds feed
culling, the main view (with the previous frame's clip planes, so kernels
B and L write the previous NDC) and the atlas; with dynamic SDF objects
the scene SDF is recomposited each frame. shading.texture_filter 1 and 2
turn on kernel D's trilinear and anisotropic branches. Every setting
outside it (the TAA supersampling pre-pass, split-frame bands, debug
views) raises NotImplementedError instead of silently skipping its pass.
render_frame runs eagerly and never synchronises with the host: every
per-frame value stays a device tensor. A camera whose leaves lead with a
path dimension is indexed on the device by the frame counter
(camera-path mode), and render_flight renders a whole flight along such
a path: on the card one frame step captured as a CUDA graph (FrameGraph)
and replayed, the port's counterpart of the JAX package's one-dispatch
lax.scan.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import device as device_mod
from .. import native
from ..assets.textures import MAX_MIPS
from ..config import RenderSettings
from ..ops import exposure as exposure_ops
from ..ops import (bloom, hiz, post, raster, sdf_scene, sdfgi, shade, shadow,
                   sky, taa, texture, volumetrics)
from ..parallel.halo import crop_halo, halo_extend
from ..scene.frustum import expand_object_mask, visible_objects_clipspace
from ..utils import mathutils, noise as noise_mod
from ..utils.mathutils import fma, fma_matmul, lu_inverse
from ..utils.sampling import importance_sample_cosine, taa_jitter_sequence
from ..utils.stencil import point_downsample
from .state import FrameState

FOV_DEG = 35.0  # CameraIntrinsic defaults (Camera.h:11-16)
NEAR_PLANE = 0.1
FAR_PLANE = 300.0
_JITTER_TABLE = taa_jitter_sequence(8) * 2.0  # TAA.cpp:168-170


def camera_arrays(position, forward, right, up, device="cuda") -> dict:
    """Dynamic camera inputs as a dict of f32 tensors on `device`."""
    dev = device_mod.resolve(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in (("position", position), ("forward", forward),
                         ("right", right), ("up", up))}


def _view_matrix(cam: dict) -> torch.Tensor:
    rot = torch.stack([cam["right"], cam["up"], -cam["forward"]], dim=0)
    trans = -fma_matmul(rot, cam["position"][:, None])[:, 0]
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


def shadow_bin_sub(sres: int) -> int:
    """Raster-bin height (in 16px rows) for the shadow atlas: the tallest
    of 8, 4, 2, 1 the map resolution divides (frame.py:145) — 128px bins at
    2048 maps; depth-only bins have no winner-slot cap."""
    sub = 8
    while sub > 1 and sres % (raster.TILE_H * sub):
        sub //= 2
    return sub


def apply_object_transforms(scene: dict, transforms: torch.Tensor,
                            positions_only: bool = False):
    """Dynamic scenes (App.cpp:64-74, frame.py:83): per-object delta
    transforms (the model matrix times the build-time inverse) applied to
    the baked world-space corners. transforms (O, 4, 4) is a device tensor
    of this frame's model matrices. Returns (corners, normals, tangents,
    bitangents, bb_min, bb_max), or the corners alone with
    positions_only. Direction attributes go through the inverse-transpose
    of the delta's 3x3 (exact under non-uniform scale; the raster
    renormalises per pixel); the culling AABBs are the transformed boxes'
    bound through |R|. The batched products and inverses round as
    XLA:CPU's dot and LU solve (mathutils.fma_matmul, lu_inverse); the
    per-triangle sums round each step, in the JAX package's order."""
    delta = fma_matmul(transforms, scene["object_build_inv"])
    tri = scene["tri_object"].long()
    tr = delta[:, :3, :].reshape(-1, 12).index_select(0, tri)  # (T, 12)

    def apply(rows, c, n_cols):
        x, y, z = c[..., 0], c[..., 1], c[..., 2]

        def col(i):  # (T, 1) against (T, 3 corners)
            return rows[:, i:i + 1]
        out = []
        for r in range(3):
            b = r * n_cols
            v = col(b) * x + col(b + 1) * y + col(b + 2) * z
            out.append(v + col(b + 3) if n_cols == 4 else v)
        return torch.stack(out, dim=-1)

    corners = apply(tr, scene["corners"], 4)
    if positions_only:
        return corners
    nrm = lu_inverse(delta[:, :3, :3]).transpose(1, 2)
    nrows = nrm.reshape(-1, 9).index_select(0, tri)
    normals, tangents, bitangents = (
        apply(nrows, scene[k], 3) for k in
        ("corner_normals", "corner_tangents", "corner_bitangents"))
    bmin, bmax = scene["object_bb_min"], scene["object_bb_max"]
    ctr = (bmin + bmax) * 0.5
    ext = (bmax - bmin) * 0.5
    r = delta[:, :3, :3]
    nctr = fma_matmul(r, ctr[:, :, None])[..., 0] + delta[:, :3, 3]
    next_ = fma_matmul(torch.abs(r), ext[:, :, None])[..., 0]
    return corners, normals, tangents, bitangents, nctr - next_, nctr + next_


def dynamic_scene(scene: dict):
    """This frame's scene as the passes read it, and the previous frame's
    corners (None for a static scene). With object_transforms the
    corners, corner frames and object bounds are transformed
    (frame.py:363-377), and with dynamic SDF objects as well the scene SDF
    is recomposited into fresh copies of its brick pools, whose coarse
    tables the GI trace then rebuilds (frame.py:379-397)."""
    if "object_transforms" not in scene:
        return scene, None
    keys = ("corners", "corner_normals", "corner_tangents",
            "corner_bitangents", "object_bb_min", "object_bb_max")
    frame_scene = dict(scene, **dict(zip(keys, apply_object_transforms(
        scene, scene["object_transforms"]))))
    prev_corners = apply_object_transforms(
        scene, scene["prev_object_transforms"], positions_only=True)
    if "sdf_dyn_vols" in scene and "sdf_volume" in scene:
        frame_scene["sdf_volume"], frame_scene["sdf_albedo"] = \
            sdf_scene.recomposite_dynamic(
                scene["sdf_volume"], scene["sdf_albedo"], scene["sdf_origin"],
                scene["sdf_voxel_size"], scene["sdf_grid"],
                scene["sdf_dyn_vols"], scene["sdf_dyn_tokens"],
                scene["sdf_dyn_pad_min"], scene["sdf_dyn_pad_max"],
                scene["sdf_dyn_albedo"], scene["sdf_dyn_obj"],
                scene["object_transforms"])
        frame_scene["sdf_coarse"] = None
    return frame_scene, prev_corners


def camera_at_frame(cam: dict, frame_index: torch.Tensor) -> dict:
    """Camera-path mode (frame.py:294-307): when cam["position"] is (n, 3),
    every non-scalar leaf must lead with the path length n (ValueError
    otherwise: a leaf without the path dimension would be misindexed), and
    each is indexed at frame_index % n on the device (index_select: no
    host sync). A single camera passes through."""
    if cam["position"].dim() != 2:
        return cam
    n_path = cam["position"].shape[0]
    for k, v in cam.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] != n_path:
            raise ValueError(
                f"camera-path mode: leaf {k!r} shape {tuple(v.shape)} does "
                f"not lead with the path length {n_path}; stack every "
                "non-scalar camera leaf along the path dimension")
    idx = (frame_index % n_path).reshape(1).long()
    return {k: (torch.index_select(v, 0, idx)[0]
                if getattr(v, "ndim", 0) >= 1 else v)
            for k, v in cam.items()}


def check_slice(scene: dict, cam: dict, settings: RenderSettings) -> None:
    """Raise NotImplementedError for anything the port does not render."""
    unported = [
        (settings.shadows.cascade_count > shadow.MAX_CASCADES,
         f"more than {shadow.MAX_CASCADES} shadow cascades"),
        (settings.taa.enabled and settings.taa.use_separate_supersampling,
         "TAA supersampling pre-pass (taa.use_separate_supersampling)"),
        (settings.shadows.debug_cascade_colors,
         "cascade debug colours (shadows.debug_cascade_colors)"),
        ("ndc_y_scale" in cam, "split-frame band mode (cam 'ndc_y_scale')"),
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
    setup: raster.TriangleSetup  # 8 planes when the scene has alpha masks
    n_tiles_y: int  # bins of sub * 16 rows
    n_tiles_x: int
    sub: int
    pair_budget: int
    alpha_masks: torch.Tensor | None = None  # (n, 128) i32
    alpha_slots: torch.Tensor | None = None  # (T,) i32, 0 = opaque
    alpha_budget: int = 0  # the alpha stream's pair budget


@dataclasses.dataclass
class MainRaster:
    """The main view's raster of one frame: the opaque stream's pair lists
    and setup rows as kernel B read them, the alpha stream's as kernels K
    and L read them (None without alpha masks), and the merged result."""

    pairs: raster.PairLists
    pair_edges: torch.Tensor  # (16, P)
    pair_attrs: torch.Tensor  # (32, P); 40 in a dynamic scene
    depth: torch.Tensor  # (H, W)
    vis: torch.Tensor  # (H, W) i32
    gbuf: torch.Tensor  # (13, H, W); 15 in a dynamic scene
    overflow: torch.Tensor  # () i32, both streams' dropped pairs
    alpha_pairs: raster.PairLists | None = None
    alpha_edges: torch.Tensor | None = None  # (32, P_a)
    alpha_attrs: torch.Tensor | None = None  # (32 or 40, P_a)


def main_view_setup(scene: dict, cam: dict, settings: RenderSettings,
                    jitter_ndc=None, prev_view_proj=None,
                    prev_corners=None) -> MainView:
    """Camera matrices, frustum cull and geometry setup of the main view
    (frame.py:342-420), with its bin grid and pair budgets (:450, :484).
    jitter_ndc (2,), the TAA jitter in NDC units, is added to the
    projection's [0, 2] and [1, 2] (frame.py:352-358). A scene whose
    "alpha_masks" is present and not None gets the 8-plane setup
    (frame.py:408-420). A dynamic scene passes its previous-frame corners
    and the previous view-projection: the setup then carries the
    previous-frame clip planes (39 attribute rows)."""
    width, height = settings.width, settings.height
    pw, ph = raster.pad_resolution(width, height)
    m_sub = main_bin_sub(ph)
    nty, ntx = ph // (raster.TILE_H * m_sub), pw // raster.TILE_W
    view = _view_matrix(cam)
    proj = _frame_constants(settings, view.device)["projection"]
    if jitter_ndc is not None:
        proj = proj.clone()
        proj[0:2, 2] += jitter_ndc
    view_proj = fma_matmul(proj, view)
    t_count = scene["corners"].shape[0]
    obj_visible = visible_objects_clipspace(
        view_proj, scene["object_bb_min"], scene["object_bb_max"])
    tri_visible = expand_object_mask(obj_visible, scene["tri_starts"],
                                     t_count)
    masks = scene.get("alpha_masks")
    slots = None if masks is None else scene["tri_alpha_slot"]
    setup = raster.geometry_setup(
        scene["corners"], scene["corner_uvs"], scene["corner_normals"],
        scene["corner_tangents"], scene["corner_bitangents"],
        scene["tri_material"], tri_visible, view_proj, pw, ph, cull="back",
        near_w=NEAR_PLANE, bin_rows=m_sub, tri_alpha_slot=slots,
        prev_view_proj=prev_view_proj, prev_corners=prev_corners)
    # budgets sized to the culled streams (frame.py:426-451, :484-485):
    # ~2x headroom over measured occupancy; overflow lands in
    # debug_counters
    scale = settings.pair_budget_scale
    return MainView(
        view_proj=view_proj, setup=setup, n_tiles_y=nty, n_tiles_x=ntx,
        sub=m_sub,
        pair_budget=int((t_count // 4 + 8 * nty * m_sub * ntx) * scale),
        alpha_masks=masks, alpha_slots=slots,
        alpha_budget=int((t_count // 32 + 4 * nty * m_sub * ntx) * scale))


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
        # the last cascade reaches the SDF influence radius and the fog's
        # far plane (lightMatrix.comp push constants, frame.py:587-588)
        "sdf_influence": _fill(settings.sdf_trace.influence_radius, dev),
        "fog_max_distance": _fill(settings.volumetrics.max_distance, dev),
        "jitter_table": _fill(_JITTER_TABLE, dev),
        "resolution": _fill([settings.width, settings.height], dev),
        "wind_dir": _fill([
            np.cos(np.deg2rad(settings.volumetrics.wind_direction_deg)), 0.0,
            np.sin(np.deg2rad(settings.volumetrics.wind_direction_deg))],
            dev),
    }


def _mark(timer, name: str) -> None:
    if timer is not None:
        timer.mark(name)


def _bin_main_stream(mv: MainView, setup: raster.TriangleSetup,
                     budget: int):
    pairs = raster.build_pairs(setup, mv.n_tiles_y, mv.n_tiles_x,
                               pair_budget=budget, bin_rows=mv.sub,
                               order_rows=True)
    return (pairs, *raster.gather_pair_setups(setup, pairs,
                                              row_extents=True))


def opaque_stream(setup: raster.TriangleSetup,
                  is_alpha: torch.Tensor) -> raster.TriangleSetup:
    """The opaque stream of an 8-plane setup: its 4 opaque planes, the
    alpha-tested triangles (is_alpha) left out (frame.py:469-472, :648-651)."""
    return dataclasses.replace(setup, edges=setup.edges[:, :4],
                               valid=setup.valid & ~is_alpha)


def raster_main_view(mv: MainView, timer=None) -> MainRaster:
    """Binning (kernel A) + G-buffer raster (kernel B) of the main view.
    order_rows + row_skip: y-sorted bin segments let the raster skip
    sub-blocks outside each pair's row extent (frame.py:421-460).

    With alpha masks the opaque and alpha-tested triangles are two streams
    (frame.py:462-501): the opaque one keeps 4 planes and runs through
    kernels A and B, the alpha one (8 planes, its own budget) through
    kernels A, K and L; a pixel takes the alpha stream's depth, vis and
    channels where its depth is strictly greater (reverse-Z, so the opaque
    stream wins ties), and the overflow counts both streams."""
    setup, budget = mv.setup, mv.pair_budget
    if mv.alpha_masks is not None:
        is_alpha = mv.alpha_slots > 0
        pairs_a, pe_a, pa_a = _bin_main_stream(mv, dataclasses.replace(
            setup, valid=setup.valid & is_alpha), mv.alpha_budget)
        setup = opaque_stream(setup, is_alpha)
    pairs, pe, pa = _bin_main_stream(mv, setup, budget)
    _mark(timer, "gbuffer")
    depth, vis, gbuf = raster.rasterize_gbuffer(
        pe, pa, pairs, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub, row_skip=True)
    if mv.alpha_masks is None:
        return MainRaster(pairs=pairs, pair_edges=pe, pair_attrs=pa,
                          depth=depth, vis=vis, gbuf=gbuf,
                          overflow=pairs.overflow)
    d2, v2, g2 = raster.rasterize_gbuffer(
        pe_a, pa_a, pairs_a, mv.n_tiles_y, mv.n_tiles_x, sub=mv.sub,
        row_skip=True, alpha_masks=mv.alpha_masks)
    win2 = d2 > depth
    return MainRaster(
        pairs=pairs, pair_edges=pe, pair_attrs=pa,
        depth=torch.where(win2, d2, depth), vis=torch.where(win2, v2, vis),
        gbuf=torch.where(win2[None], g2, gbuf),
        overflow=pairs.overflow + pairs_a.overflow, alpha_pairs=pairs_a,
        alpha_edges=pe_a, alpha_attrs=pa_a)


def shadow_atlas_setup(scene: dict, cascade_mats: torch.Tensor, n_cas: int,
                       sres: int, alpha_slots=None) -> raster.TriangleSetup:
    """All cascades as one vertical-atlas TriangleSetup (frame.py:164-226):
    per-cascade clip-space culling without the z test, one batched
    geometry stage with front-face culling (the reference's shadow pass
    culls front faces, RenderFrontend.cpp:1576), then each cascade's edge
    planes shifted into its band of atlas rows (c' = c - b * y_off), its
    bboxes and fine rows offset by the band. alpha_slots (T,) i32 gives
    the 8-plane table; the slot plane has b = 0, so the shift keeps it."""
    sub = shadow_bin_sub(sres)
    s_nty = sres // (raster.TILE_H * sub)
    t_count = scene["corners"].shape[0]
    cas_mats = cascade_mats[:n_cas]
    cas_visible = torch.stack([
        expand_object_mask(
            visible_objects_clipspace(cas_mats[c], scene["object_bb_min"],
                                      scene["object_bb_max"], cull_z=False),
            scene["tri_starts"], t_count)
        for c in range(n_cas)])
    s_setup = raster.geometry_setup(
        scene["corners"], scene["corner_uvs"], scene["corner_normals"],
        scene["corner_tangents"], scene["corner_bitangents"],
        scene["tri_material"], cas_visible, cas_mats, sres, sres,
        cull="front", bin_rows=sub, with_attrs=False,
        tri_alpha_slot=alpha_slots)
    dev = cascade_mats.device
    # edges (3, n_pl, n_cas, T): the atlas stream is a free reshape
    y_off = (torch.arange(n_cas, dtype=torch.float32, device=dev)
             * sres).reshape(1, n_cas, 1)
    e = s_setup.edges
    edges = torch.stack([e[0], e[1], e[2] + (-e[1] * y_off)])
    n_pl = edges.shape[1]
    offs = (torch.arange(n_cas, dtype=torch.int32, device=dev)
            * s_nty)[:, None]
    bb = s_setup.tile_bbox
    bbox = torch.stack([bb[..., 0] + offs, bb[..., 1], bb[..., 2] + offs,
                        bb[..., 3]], dim=-1)
    fine_offs = (torch.arange(n_cas, dtype=torch.int32, device=dev)
                 * (sres // raster.TILE_H)).reshape(n_cas, 1, 1)
    return raster.TriangleSetup(
        edges=edges.reshape(3, n_pl, n_cas * t_count),
        attrs=s_setup.attrs, tile_bbox=bbox.reshape(-1, 4),
        valid=s_setup.valid.reshape(-1),
        fine_y=(s_setup.fine_y + fine_offs).reshape(-1, 2))


@dataclasses.dataclass
class ShadowAtlas:
    """The cascade fit and the rendered cascade maps of one frame."""

    cascade_mats: torch.Tensor  # (MAX_CASCADES, 4, 4)
    splits: torch.Tensor  # (MAX_CASCADES,)
    cascade_scales: torch.Tensor  # (MAX_CASCADES, 2)
    maps: torch.Tensor  # (MAX_CASCADES, S, S) reverse-Z, unused ones 0
    setup: raster.TriangleSetup  # the atlas stream, n_cas * T triangles
    pairs: raster.PairLists  # the opaque casters'
    edges: torch.Tensor  # (16, P) pair edge rows, as kernel E read them
    n_bins_y: int  # atlas bins of sub * 16 rows
    n_bins_x: int
    sub: int
    pair_budget: int
    overflow: torch.Tensor  # () i32, both streams' dropped pairs
    alpha: AlphaCasters | None = None


@dataclasses.dataclass
class AlphaCasters:
    """The atlas's alpha-tested stream, as kernel J read it."""

    pairs: raster.PairLists
    edges: torch.Tensor  # (32, P) pair edge rows
    masks: torch.Tensor  # (n, 128) i32
    n_bins_y: int  # atlas bins of sub * 16 rows
    sub: int
    pair_budget: int


def render_shadow_atlas(scene: dict, cam: dict, depth: torch.Tensor,
                        settings: RenderSettings) -> ShadowAtlas:
    """Cascade fit from the frame's depth bounds, then every cascade in one
    depth-only atlas pass: atlas setup, binning (kernel A, multi-view
    keys), setup gather and depth raster (kernel E) (frame.py:576-752,
    the single-device branches). With alpha masks the alpha-tested
    casters are a second stream (frame.py:637-723): re-binned on
    a_sub = min(4, sub) bins from their fine rows, without row order, and
    rasterized by kernel J, max-merged in place onto kernel E's opaque
    atlas."""
    consts = _frame_constants(settings, depth.device)
    n_cas = settings.shadows.cascade_count
    d_min, d_max = hiz.depth_min_max(depth)
    cascade_mats, splits, cascade_scales = shadow.compute_cascade_info(
        d_min, d_max, cam["position"], cam["forward"], cam["up"],
        cam["right"], math.tan(math.radians(FOV_DEG) * 0.5),
        settings.width / settings.height, NEAR_PLANE, FAR_PLANE,
        consts["sun_dir"], n_cas, consts["sdf_influence"],
        consts["fog_max_distance"],
        sample_radius=settings.shadows.sample_radius)
    sres = settings.shadows.resolution
    s_sub = shadow_bin_sub(sres)
    s_nty = sres // (raster.TILE_H * s_sub)
    s_ntx = sres // raster.TILE_W
    nb = n_cas * s_nty
    t_count = scene["corners"].shape[0]
    masks = scene.get("alpha_masks")
    slots = None if masks is None else scene["tri_alpha_slot"]
    setup = shadow_atlas_setup(scene, cascade_mats, n_cas, sres, slots)
    scale = settings.pair_budget_scale
    # budget 1/6 of the atlas triangle stream + a per-bin floor
    # (frame.py:625-635); overflow lands in debug_counters[1]
    budget = int(((n_cas * t_count) // 6 + 4 * nb * s_sub * s_ntx) * scale)
    setup_o = setup
    if masks is not None:
        is_alpha = (slots > 0).repeat(n_cas)
        setup_o = opaque_stream(setup, is_alpha)
    pairs = raster.build_pairs(setup_o, nb, s_ntx, pair_budget=budget,
                               bin_rows=s_sub, order_rows=True,
                               n_views=n_cas, tile_cap=1 << 15)
    edges, _ = raster.gather_pair_setups(setup_o, pairs, row_extents=True,
                                         with_attrs=False)
    atlas = raster.rasterize_depth(edges, pairs, nb, s_ntx, sub=s_sub,
                                   row_skip=True)
    overflow, alpha = pairs.overflow, None
    if masks is not None:
        # the alpha casters on a_sub-row bins from their fine rows
        # (frame.py:677-685); the band covers the same pixel rows as the
        # opaque pass, so the max-merge onto it lines up
        a_sub = min(4, s_sub)
        a_nb = nb * (s_sub // a_sub)
        fy = setup.fine_y
        setup_a = dataclasses.replace(
            setup, valid=setup.valid & is_alpha,
            tile_bbox=torch.stack([fy[:, 0] // a_sub, setup.tile_bbox[:, 1],
                                   fy[:, 1] // a_sub, setup.tile_bbox[:, 3]],
                                  dim=1))
        a_budget = int(((n_cas * t_count) // 24 + 4 * a_nb * a_sub * s_ntx)
                       * scale)
        pairs_a = raster.build_pairs(setup_a, a_nb, s_ntx,
                                     pair_budget=a_budget, bin_rows=a_sub,
                                     n_views=n_cas, tile_cap=1 << 15)
        edges_a, _ = raster.gather_pair_setups(setup_a, pairs_a,
                                               with_attrs=False)
        alpha = AlphaCasters(pairs=pairs_a, edges=edges_a, masks=masks,
                             n_bins_y=a_nb, sub=a_sub, pair_budget=a_budget)
        raster.rasterize_depth(edges_a, pairs_a, a_nb, s_ntx, sub=a_sub,
                               alpha_masks=masks, init_depth=atlas)
        overflow = overflow + pairs_a.overflow
    maps = atlas.reshape(n_cas, sres, sres)
    if n_cas < shadow.MAX_CASCADES:
        maps = torch.cat([maps, torch.zeros(
            (shadow.MAX_CASCADES - n_cas, sres, sres), dtype=torch.float32,
            device=maps.device)])
    return ShadowAtlas(cascade_mats=cascade_mats, splits=splits,
                       cascade_scales=cascade_scales, maps=maps, setup=setup,
                       pairs=pairs, edges=edges, n_bins_y=nb, n_bins_x=s_ntx,
                       sub=s_sub, pair_budget=budget, overflow=overflow,
                       alpha=alpha)


def blue_noise_screen(luts: dict, frame_index: torch.Tensor, ph: int,
                      pw: int) -> torch.Tensor:
    """The frame's blue-noise tile (frame_index % 4) repeated over the
    padded screen (frame.py:758-761); index_select keeps the device index
    on the device."""
    tile = torch.index_select(luts["blue_noise"], 0,
                              (frame_index % 4).reshape(1).long())[0]
    reps = (ph // tile.shape[0] + 1, pw // tile.shape[1] + 1)
    return tile.repeat(reps)[:ph, :pw].contiguous()


def static_prev_ndc(prev_view_projection, world_pos, valid):
    """Previous-frame NDC of a static scene: the depth-derived world
    position through last frame's view-projection (frame.py:526-532).
    The product rounds as XLA:CPU's dot does, one multiply then fused
    multiply-adds over k, the same on every device (see
    shade.reconstruct_world_position for why the last bits matter)."""
    p = prev_view_projection
    x, y, z = world_pos

    def row(r):
        return fma(p[r, 2], z, fma(p[r, 1], y, p[r, 0] * x)) + p[r, 3]

    pw_h = row(3)
    prev_ndc = torch.stack([row(0), row(1)]) \
        / torch.where(torch.abs(pw_h) > 1e-9, pw_h, 1.0)[None]
    return torch.where(valid[None], prev_ndc, 0.0)


def to_gi_res(plane, gh: int, gw: int, stride: int):
    """Point-subsample to the GI resolution and zero-pad to its tile-padded
    size (frame.py:803-808)."""
    p = point_downsample(plane, stride, stride)
    out = p.new_zeros(p.shape[:-2] + (gh, gw))
    out[..., :p.shape[-2], :p.shape[-1]] = p
    return out


@dataclasses.dataclass
class GITraceInputs:
    """Kernel G's per-frame inputs at GI resolution (frame.py:810-832)."""

    valid: torch.Tensor  # (gh, gw) bool
    world_pos: torch.Tensor  # (3, gh, gw)
    normal: torch.Tensor  # (3, gh, gw) geometric normal
    lin_depth: torch.Tensor  # (gh, gw) view depth, 0 off-surface
    ray_dirs: torch.Tensor  # (3, gh, gw) cosine-sampled directions
    sky_lowres: torch.Tensor  # (3, 32, 64)


def gi_trace_inputs(state: FrameState, luts: dict, settings: RenderSettings,
                    valid, world_pos, geo_normal, pixel_depth,
                    sky_lut) -> GITraceInputs:
    """Downsample the G-buffer to the GI resolution, draw one cosine ray
    per pixel from two blue-noise tiles (frame_index % 4 and the next,
    sdfDiffuseTrace.comp:141-158) and shrink the sky LUT to 32x64 with an
    antialiased bilinear resize (jax.image.resize "linear")."""
    stride = 2 if settings.sdf_trace.half_resolution else 1
    gh, gw = state.gi_history.shape[1:]
    gi_normal = to_gi_res(geo_normal, gh, gw, stride)
    xi = torch.stack([
        blue_noise_screen(luts, state.frame_index, gh, gw),
        blue_noise_screen(luts, state.frame_index + 1, gh, gw)], dim=-1)
    dirs = importance_sample_cosine(xi, torch.movedim(gi_normal, 0, -1))
    sky_lowres = torch.nn.functional.interpolate(
        sky_lut[None], size=(32, 64), mode="bilinear", align_corners=False,
        antialias=True)[0]
    return GITraceInputs(
        valid=to_gi_res(valid, gh, gw, stride),
        world_pos=to_gi_res(world_pos, gh, gw, stride).contiguous(),
        normal=gi_normal.contiguous(),
        lin_depth=to_gi_res(pixel_depth, gh, gw, stride),
        ray_dirs=torch.movedim(dirs, -1, 0).contiguous(),
        sky_lowres=sky_lowres)


def trace_scene_gi(scene: dict, inp: GITraceInputs, settings: RenderSettings,
                   sun_dir, sun_color, sun_strength_exposed):
    """Kernel G on the scene's attached SDF (frame.py:833-847): the fine
    trace clamps to its window; escaped rays continue in the coarse
    volume up to 2.5x the influence radius."""
    st = settings.sdf_trace
    return sdfgi.trace_gi(
        inp.world_pos, inp.normal, inp.ray_dirs, inp.valid, inp.sky_lowres,
        scene["sdf_volume"], scene["sdf_albedo"], scene["sdf_origin"],
        scene["sdf_voxel_size"], scene["sdf_grid"], sun_dir, sun_color,
        sun_strength_exposed, steps=st.trace_steps,
        influence=st.influence_radius * 2.5,
        strict=st.strict_influence_radius_cutoff, dims_zyx=scene["sdf_grid"],
        coarse_fallback=st.coarse_fallback, coarse_tables=scene["sdf_coarse"])


def sdf_gi(state: FrameState, scene: dict, luts: dict,
           settings: RenderSettings, valid, world_pos, geo_normal, depth,
           pixel_depth, prev_ndc, sky_lut, sun_dir, sun_color,
           sun_strength_exposed, timer=None, jitter_ndc=None):
    """The GI pass (frame.py:793-899): trace (kernel G) -> resolve ->
    spatial -> history resample (kernel H) + temporal -> spatial ->
    upscale. jitter_ndc is the frame's TAA jitter (None: no jitter).
    Returns (indirect_y_sh (4, H, W), indirect_cocg (2, H, W), new
    gi_history)."""
    half = settings.sdf_trace.half_resolution
    stride = 2 if half else 1
    width, height = settings.width, settings.height
    ph, pw = depth.shape
    gh, gw = state.gi_history.shape[1:]
    inp = gi_trace_inputs(state, luts, settings, valid, world_pos,
                          geo_normal, pixel_depth, sky_lut)
    y_sh, cocg, _ = trace_scene_gi(scene, inp, settings, sun_dir, sun_color,
                                   sun_strength_exposed)

    _mark(timer, "gi_filter")
    # the chain (resolve -> spatial -> temporal -> spatial) reaches ~40
    # half-res rows: one 48-row halo covers it (frame.py:851)
    halo = min(48, gh) // raster.TILE_H * raster.TILE_H
    y_sh = halo_extend(y_sh, halo)
    cocg = halo_extend(cocg, halo)
    normal_e = halo_extend(inp.normal, halo)
    wpos_e = halo_extend(inp.world_pos, halo)
    lindepth_e = halo_extend(inp.lin_depth, halo)
    y_sh, cocg = sdfgi.neighborhood_resolve(y_sh, cocg, normal_e, lindepth_e)
    proj_scale = 0.5 * height / math.tan(math.radians(FOV_DEG) * 0.5)
    y_sh, cocg = sdfgi.spatial_filter(
        y_sh, cocg, normal_e, wpos_e, lindepth_e, state.frame_index, 1.5,
        proj_scale / stride, seed=0)
    if jitter_ndc is None:
        jitter_ndc = torch.zeros_like(state.prev_jitter)
    motion_e = halo_extend(to_gi_res(taa.compute_motion(
        prev_ndc, valid, jitter_ndc, state.prev_jitter, width, height),
        gh, gw, stride), halo)
    hist, hist_ok = taa.resample_packed_planes(
        halo_extend(state.gi_history, halo), motion_e, gw, gh)
    mx = motion_e[0] * width
    my = motion_e[1] * height
    y_sh, cocg = sdfgi.temporal_filter_gi(
        y_sh, cocg, hist[0:4], hist[4:6], hist_ok, torch.sqrt(mx * mx + my * my),
        state.frame_index == 0)
    new_history = crop_halo(torch.stack([
        taa.pack_f16_pair(y_sh[0], y_sh[1]),
        taa.pack_f16_pair(y_sh[2], y_sh[3]),
        taa.pack_f16_pair(cocg[0], cocg[1])]), halo)
    y_sh, cocg = sdfgi.spatial_filter(
        y_sh, cocg, normal_e, wpos_e, lindepth_e, state.frame_index, 1.0,
        proj_scale / stride, seed=1)
    y_sh = crop_halo(y_sh, halo)
    cocg = crop_halo(cocg, halo)

    _mark(timer, "gi_upscale")
    if half:
        y_sh, cocg = sdfgi.upscale_half_to_full(
            y_sh, cocg, depth, to_gi_res(depth, gh, gw, stride), NEAR_PLANE,
            FAR_PLANE)
    return y_sh[:, :ph, :pw], cocg[:, :ph, :pw], new_history


def render_frame(state: FrameState, scene: dict, cam: dict, luts: dict,
                 delta_time, settings: RenderSettings, device="cuda",
                 timer=None):
    """One frame: (image_u8 (H, W, 3), FrameState').

    All inputs must lie on `device`. cam is one camera, or a camera path
    whose leaves lead with the path length (camera_at_frame). timer
    (utils.timing.PassTimer) records a CUDA event at each pass boundary;
    None records nothing."""
    dev = device_mod.resolve(device)
    if state.prev_color.device.type != dev.type:
        raise ValueError(f"state lies on {state.prev_color.device}, "
                         f"render_frame was asked for {dev}")
    cam = camera_at_frame(cam, state.frame_index)
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

    # --- TAA jitter (frame.py:352-361): the table row frame_index % 8,
    # picked on the device ---
    taa_on = settings.taa.enabled
    if taa_on:
        jitter_px = torch.index_select(
            consts["jitter_table"], 0,
            (state.frame_index % 8).reshape(1).long())[0]
        jitter_ndc = jitter_px / consts["resolution"]
    else:
        jitter_ndc = torch.zeros(2, **f32)

    # --- dynamic objects: transformed geometry, recomposited SDF ---
    if "object_transforms" in scene:
        _mark(timer, "dynamic")
    scene, prev_corners = dynamic_scene(scene)

    # --- cull + setup + binning (kernel A) + G-buffer raster (kernel B) ---
    _mark(timer, "binning")
    mv = main_view_setup(scene, cam, settings,
                         jitter_ndc=jitter_ndc if taa_on else None,
                         prev_view_proj=state.prev_view_projection,
                         prev_corners=prev_corners)
    main = raster_main_view(mv, timer)
    depth, vis, gbuf = main.depth, main.vis, main.gbuf
    valid = vis >= 0

    # --- material constants (kernel C) ---
    _mark(timer, "material")
    mat_packed = gbuf[raster._CH_MAT]
    mat_id = torch.floor(mat_packed * 0.5)
    material = post.material_lookup(scene["material_table"], mat_id, valid)

    # --- forward shade ---
    _mark(timer, "shade")
    # the inverse in f64, rounded: within an ulp of the JAX package's f32
    # LU solve, and the same on every device (under a static camera the
    # reprojection's last bits decide the history windows' edge tests)
    inv_vp = lu_inverse(mv.view_proj)
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
    normal_ts = torch.zeros((2, ph, pw), **f32)

    # --- material textures (kernel D), constants where not ok ---
    if "tex_word0" in scene:
        _mark(timer, "texture")
        # mip bias log2(0.5) under TAA (Filmic SMAA p.117,
        # RenderFrontend.cpp:1176-1181; frame.py:548-549)
        bias = -1.0 if taa_on and settings.taa.use_mip_bias else 0.0
        ts = texture.sample_materials(
            gbuf[raster._CH_U:raster._CH_U + 2],
            gbuf[raster._CH_DUDX:raster._CH_DUDX + 4], mat_id, valid,
            scene["mat_tex"], scene["tex_info"], scene["tex_word0"],
            scene["tex_word1"], n_mips=MAX_MIPS, mip_bias=bias,
            trilinear=settings.shading.texture_filter >= 1,
            aniso=settings.shading.texture_filter >= 2,
            two_mat=settings.shading.texture_two_mat)
        tex_ok = ts[8] > 0.5
        albedo = torch.where(tex_ok[None], ts[0:3], albedo)
        normal_ts = torch.where(tex_ok[None], ts[4:6], normal_ts)
        rough_metal = torch.stack([
            torch.ones_like(material[3]),
            torch.where(tex_ok, ts[6], material[3]),
            torch.where(tex_ok, ts[7], material[4])], dim=0)

    # pixel linear depth = dot(V, -forward) (triangle.frag:205-207)
    to_cam = cam["position"].reshape(3, 1, 1) - world_pos
    view_depth = -torch.sum(to_cam * cam["forward"].reshape(3, 1, 1), dim=0)
    pixel_depth = torch.where(valid, view_depth, 0.0)
    # previous-frame NDC for TAA's and GI's motion: a dynamic scene's
    # interpolated prev-clip planes (G-buffer channels 13-14), a static
    # scene's reprojected depth (frame.py:520-531)
    if prev_corners is not None:
        prev_ndc = gbuf[raster._CH_PREV:raster._CH_PREV + 2]
    else:
        prev_ndc = static_prev_ndc(state.prev_view_projection, world_pos,
                                   valid)

    # --- sun shadows: cascade fit, atlas (kernels A, E), PCF (kernel F) ---
    if settings.shadows.cascade_count > 0:
        _mark(timer, "shadow_atlas")
        atlas = render_shadow_atlas(scene, cam, depth, settings)
        _mark(timer, "shadow_resolve")
        sun_shadow = shadow.shadow_resolve(
            world_pos, pixel_depth,
            blue_noise_screen(luts, state.frame_index, ph, pw), atlas.maps,
            atlas.cascade_mats, atlas.cascade_scales, atlas.splits,
            settings.shadows.cascade_count, taps=settings.shadows.pcf_taps,
            sample_radius=settings.shadows.sample_radius)
        shadow_overflow = atlas.overflow
    else:
        sun_shadow = torch.ones((ph, pw), **f32)
        shadow_overflow = torch.zeros_like(main.overflow)

    # --- SDF GI: trace (kernel G), filters, history (kernel H), upscale ---
    indirect_y_sh = indirect_cocg = None
    new_gi_history = state.gi_history
    if (settings.sdf_trace.enabled
            and settings.shading.indirect_lighting_tech == 0
            and "sdf_volume" in scene):
        _mark(timer, "gi_trace")
        indirect_y_sh, indirect_cocg, new_gi_history = sdf_gi(
            state, scene, luts, settings, valid, world_pos, geo_n, depth,
            pixel_depth, prev_ndc, sky_lut, sun_dir, sun_color,
            sun_strength_exposed, timer, jitter_ndc=jitter_ndc)

    _mark(timer, "shade")
    hdr = shade.shade_forward(
        config=settings.shading, world_pos=world_pos, geo_normal=geo_n,
        tangent=geo_t, bitangent=geo_b, valid=valid,
        albedo_srgb_linear=albedo, normal_ts=normal_ts, specular=rough_metal,
        sun_direction=sun_dir, sun_color=sun_color,
        sun_strength_exposed=sun_strength_exposed, sun_shadow=sun_shadow,
        camera_position=cam["position"], indirect_y_sh=indirect_y_sh,
        indirect_cocg=indirect_cocg)

    # --- sky composite ---
    _mark(timer, "sky")
    tan_fov_half = math.tan(math.radians(FOV_DEG) * 0.5)
    view_dirs = sky.view_directions(pw, ph, cam["forward"], cam["up"],
                                    cam["right"], tan_fov_half,
                                    width / height)
    hdr = sky.apply_sky(hdr, valid, sky_lut, luts["transmission"],
                        view_dirs, sun_dir, sun_strength_exposed)

    # --- froxel fog (frame.py:942-1004), with shadows ---
    new_vol_history = state.volumetric_history
    if settings.volumetrics.enabled and settings.shadows.cascade_count > 0:
        _mark(timer, "fog")
        hdr, new_vol_history = froxel_fog(
            state, cam, luts, settings, atlas, hdr, valid,
            torch.where(valid, view_depth, settings.volumetrics.max_distance),
            sun_dir, sun_color, sun_strength_exposed)
    scene_color = hdr  # pre-TAA color feeds next frame's histogram

    # --- TAA (frame.py:1008-1051): one 16-row edge-padded halo covers the
    # 3x3 neighbourhoods, the dilation and the bicubic history window ---
    taa_history = state.taa_history
    if taa_on:
        _mark(timer, "taa")
        halo = min(16, ph) // raster.TILE_H * raster.TILE_H
        motion = taa.compute_motion(prev_ndc, valid, jitter_ndc,
                                    state.prev_jitter, width, height)
        taa_set = settings.taa
        hdr, taa_history = taa.temporal_filter(
            halo_extend(hdr, halo), halo_extend(state.taa_history, halo),
            halo_extend(motion, halo), halo_extend(depth, halo), jitter_px,
            state.frame_index == 0, width, height,
            use_clipping=taa_set.use_clipping,
            use_motion_dilation=taa_set.use_motion_vector_dilation,
            use_tonemapping=taa_set.filter_use_tonemapping,
            history_sampling_tech=taa_set.history_sampling_tech)
        hdr = crop_halo(hdr, halo)
        taa_history = crop_halo(taa_history, halo)

    # --- bloom (frame.py:1053-1065) ---
    if settings.bloom.enabled:
        _mark(timer, "bloom")
        bs = settings.bloom
        hdr = bloom.compute_bloom(hdr, bs.strength, bs.blur_radius,
                                  bs.mip_count)

    # --- tonemap ---
    _mark(timer, "tonemap")
    time = state.frame_index.to(torch.float32) * 0.016
    image = post.tonemap_pass(hdr, time)[:height, :width]
    _mark(timer, "end")

    new_state = dataclasses.replace(
        state,
        frame_index=state.frame_index + 1,
        exposure=new_exposure,
        prev_color=scene_color,
        prev_depth=depth,
        taa_history=taa_history,
        gi_history=new_gi_history,
        volumetric_history=new_vol_history,
        prev_view_projection=mv.view_proj,
        prev_jitter=jitter_ndc,
        debug_counters=torch.stack([main.overflow, shadow_overflow]).to(
            torch.int32),
    )
    return image, new_state


def froxel_fog(state: FrameState, cam: dict, luts: dict,
               settings: RenderSettings, atlas: ShadowAtlas, hdr, valid,
               fog_depth, sun_dir, sun_color, sun_strength_exposed):
    """The froxel fog pass (frame.py:942-1004): material, the coarse sun
    shadow of the last cascade, scattering, reprojection against the
    carried history, integration and the per-pixel apply. fog_depth is
    the pixel's view depth, max_distance on the sky (sky.frag:31-34).
    Returns (hdr, new volumetric history)."""
    vs = settings.volumetrics
    consts = _frame_constants(settings, hdr.device)
    fd, fh, fw = state.volumetric_history.shape[1:]
    tan_fov_half = math.tan(math.radians(FOV_DEG) * 0.5)
    aspect = settings.width / settings.height
    wind_offset = consts["wind_dir"] * (
        vs.wind_speed * state.frame_index.to(torch.float32) * 0.016)
    fpos = volumetrics.froxel_world_positions(
        (fw, fh, fd), cam, tan_fov_half, aspect, vs.max_distance)
    mat_vol = volumetrics.material_volume(fpos, vs, wind_offset)

    # the last cascade's shadow on a 4x coarser grid, a hard test against
    # the atlas depth at truncated texel indices (frame.py:957-973)
    cd, ch, cw = max(fd // 4, 1), max(fh // 4, 1), max(fw // 4, 1)
    cpos = volumetrics.froxel_world_positions(
        (cw, ch, cd), cam, tan_fov_half, aspect, vs.max_distance)
    last_c = settings.shadows.cascade_count - 1
    m_light = atlas.cascade_mats[last_c]
    cp = cpos.reshape(3, -1).T
    lxy = cp @ m_light[:2, :3].T + m_light[:2, 3]
    lz = cp @ m_light[2, :3] + m_light[2, 3]
    sres = settings.shadows.resolution
    su = torch.clamp(((lxy[:, 0] * 0.5 + 0.5) * sres).to(torch.int32), 0,
                     sres - 1)
    sv = torch.clamp(((lxy[:, 1] * 0.5 + 0.5) * sres).to(torch.int32), 0,
                     sres - 1)
    smap_depth = atlas.maps[last_c][sv.long(), su.long()]
    shadow_c = (torch.clamp(lz, 0.0, 1.0) >= smap_depth).to(
        torch.float32).reshape(cd, ch, cw)

    scat = volumetrics.light_scattering(
        mat_vol, fpos, shadow_c, cam, sun_dir, sun_color,
        sun_strength_exposed, vs.phase_g, ambient=vs.ambient)
    scat = volumetrics.temporal_reprojection(
        scat, state.volumetric_history, cpos, state.prev_view_projection,
        cam["position"], cam["forward"], vs.max_distance,
        state.frame_index == 0)
    integrated = volumetrics.integrate_froxels(scat, vs.max_distance)
    ph, pw = valid.shape
    hdr = volumetrics.apply_froxel_fog(
        hdr, fog_depth, integrated, vs.max_distance,
        blue_noise_screen(luts, state.frame_index, ph, pw))
    return hdr, scat


class FrameGraph:
    """One frame step captured as a CUDA graph, to replay (render_flight).

    The state is cloned into static buffers (the caller's tensors are never
    written), then one render_frame on them is captured with
    torch.cuda.graph, ending with state' copied back into those buffers, so
    each replay() renders the next frame: .state always holds the state
    after the last replay, .image (in the graph's memory pool) its image.
    The caches a frame fills on first use (_frame_constants, the shadow
    fit's constants and PCF spiral, the GI filter's tap table, the kernel
    library and the strip launchers' grids) must be filled before, by an
    eager frame at the same settings on the same device: a host-to-device
    copy or a kernel attribute query inside the capture would fail it. A
    capture that fails raises; nothing falls back to eager frames. Frozen
    at capture: a Python delta_time (a fill baked into the graph; pass a
    device tensor to vary it between replays) and everything the host
    decides per frame (none: render_frame never reads the device). No
    PassTimer runs inside the graph, so per-pass times come from eager
    frames. The kernels' launches recorded by the capture are counted
    once per replay (native.count_replays)."""

    def __init__(self, state: FrameState, scene: dict, cam_path: dict,
                 luts: dict, delta_time, settings: RenderSettings):
        names = [f.name for f in dataclasses.fields(FrameState)]
        self.state = FrameState(**{k: getattr(state, k).clone()
                                   for k in names})
        self.graph = torch.cuda.CUDAGraph()
        with native.capturing() as step:
            with torch.cuda.graph(self.graph):
                image, new = render_frame(
                    self.state, scene, cam_path, luts, delta_time, settings,
                    device=self.state.prev_color.device)
                for k in names:
                    getattr(self.state, k).copy_(getattr(new, k))
        self.image = image
        self.launches = dict(step)  # kernel -> launches per replay

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.graph.replay()
        native.count_replays(self.launches, n)


def render_flight(state: FrameState, scene: dict, cam_path: dict,
                  luts: dict, delta_time, settings: RenderSettings,
                  n_frames: int, device="cuda"):
    """n_frames consecutive frames along cam_path (camera-path mode:
    leaves lead with the path length, indexed by state.frame_index):
    (the last frame's image, the final state), frame_index advanced by
    n_frames (frame.py:1122-1153, render_flight's lax.scan). On the card
    frame 1 runs eagerly (it fills the caches a capture needs), then one
    frame step is captured (FrameGraph) and replayed n_frames - 1 times,
    with no host work per frame; the image is cloned out of the graph's
    pool. On the CPU it is a loop of render_frame. The caller's state is
    not written."""
    dev = device_mod.resolve(device)
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    image, state = render_frame(state, scene, cam_path, luts, delta_time,
                                settings, device=dev)
    if dev.type == "cpu":
        for _ in range(n_frames - 1):
            image, state = render_frame(state, scene, cam_path, luts,
                                        delta_time, settings, device=dev)
        return image, state
    if n_frames == 1:
        return image, state
    step = FrameGraph(state, scene, cam_path, luts, delta_time, settings)
    step.replay(n_frames - 1)
    return step.image.clone(), step.state


def scene_to_device(rs, device="cuda") -> dict:
    """RenderScene (numpy) -> the tensor dict render_frame reads."""
    dev = device_mod.resolve(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    scene = {
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
    if rs.tex_word0 is not None:  # frame.py:1181-1188
        scene.update(mat_tex=put(rs.mat_tex), tex_info=put(rs.tex_info),
                     tex_word0=put(rs.tex_word0), tex_word1=put(rs.tex_word1))
    if rs.alpha_masks is not None:  # frame.py:1189-1191
        scene.update(alpha_masks=put(rs.alpha_masks),
                     tri_alpha_slot=put(rs.tri_alpha_slot))
    return scene


def attach_global_sdf(scene: dict, gsdf) -> dict:
    """Add the composited scene SDF (ops/sdf_scene.GlobalSDF) to the scene
    tensors, padded and quantized for the trace (frame.py:1203-1237), on
    the scene's device. The volume dims ride along as the tuple
    "sdf_grid"; the coarse tables are built once, for a static scene."""
    dev = scene["corners"].device
    vol = np.asarray(gsdf.volume, np.float32)
    alb = np.asarray(gsdf.albedo, np.float32)

    # each axis to whole bricks and at least one 2x2x2-brick window
    def pad_amount(n):
        return max(sdfgi.WINDOW, -(-n // sdfgi.BRICK) * sdfgi.BRICK) - n

    pads = [(0, pad_amount(n)) for n in vol.shape]
    vol = np.pad(vol, pads, constant_values=1e4)
    alb = np.pad(alb, pads + [(0, 0)], constant_values=0.5)
    scene = dict(scene)
    scene["sdf_volume"] = sdfgi.quantize_sdf_volume(
        torch.as_tensor(vol, device=dev), gsdf.voxel_size)
    scene["sdf_albedo"] = sdfgi.pack_albedo_volume(
        torch.as_tensor(alb, device=dev))
    scene["sdf_origin"] = torch.as_tensor(
        np.asarray(gsdf.origin, np.float32), device=dev)
    scene["sdf_voxel_size"] = float(gsdf.voxel_size)
    scene["sdf_dims"] = torch.as_tensor(np.asarray(vol.shape, np.float32),
                                        device=dev)
    scene["sdf_grid"] = tuple(int(n) for n in vol.shape)
    scene["sdf_coarse"] = sdfgi.build_coarse_tables(
        scene["sdf_volume"], scene["sdf_albedo"], vol.shape)
    return scene


def attach_dynamic_sdf(scene: dict, dyn) -> dict:
    """Add the dynamic SDF instances (ops/sdf_scene.DynamicSDFSet) to the
    scene tensors on the scene's device (frame.py:1240-1254), so that
    render_frame recomposites the moved instances into the scene SDF every
    frame; it needs "object_transforms" in the scene (without them the SDF
    stays static). The static window shapes ride along as the tuple
    "sdf_dyn_tokens" of (wd, wh, ww)."""
    dev = scene["corners"].device

    def put(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    scene = dict(scene)
    scene["sdf_dyn_vols"] = [put(v) for v in dyn.volumes]
    scene["sdf_dyn_tokens"] = tuple(tuple(int(n) for n in w)
                                    for w in dyn.window_vox)
    scene["sdf_dyn_pad_min"] = put(dyn.pad_min)
    scene["sdf_dyn_pad_max"] = put(dyn.pad_max)
    scene["sdf_dyn_albedo"] = put(dyn.albedo)
    scene["sdf_dyn_obj"] = put(dyn.object_index, np.int32)
    return scene


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
