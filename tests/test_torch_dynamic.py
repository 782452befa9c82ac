"""The port's dynamic objects against the JAX package: the per-frame object
transforms, the previous-frame clip planes of geometry_setup (39 rows, the
40-row pair table), kernels B's and L's plain versions with the two
previous-NDC channels, the dynamic SDF recomposite, and 3 frames of the
textured small atrium with a moving box, its dynamic SDF and anisotropic
texture filtering; plus the port's identity-transform frame against its
static one. The JAX side runs its Pallas kernels in interpret mode, the
port its plain PyTorch versions; scene, state and LUTs cross by
interop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_alpha import _check_edges_only, _inputs, _masks

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import raster as jr
from plainrenderer_tpu.ops import sdf_scene as jsdf
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.ops import raster as tr
from plainrenderer_tpu_torch.ops import sdf_scene as tsdf
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb
from plainrenderer_tpu_torch.render.state import initial_state

torch.set_num_threads(1)

W, H = 256, 128
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)  # test_frame.py:25-34
BOX = 13  # the small atrium's first scattered box (5 slabs, 8 columns)


def _moved(mats):
    """tests/test_frame.py:115-124: object 2 shifted, object 3 turned by
    0.5 rad about y."""
    new = np.array(mats, np.float32).copy()
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.7, -0.3, 0.4]
    new[2] = shift @ new[2]
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(0.5)
    rot[0, 2] = np.sin(0.5)
    rot[2, 0] = -np.sin(0.5)
    new[3] = rot @ new[3]
    return new


def _box_motion(mats, t):
    """The box at frame t: shifted by 0.3 (sin(0.2 t), 0, cos(0.2 t)) m and
    turned by 0.05 t rad about the vertical axis through its centre (the
    motion chip_smoke.py gives the bench atrium's boxes)."""
    new = np.array(mats, np.float32).copy()
    c = new[BOX][:3, 3].copy()
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(0.05 * t)
    rot[0, 2] = np.sin(0.05 * t)
    rot[2, 0] = -np.sin(0.05 * t)
    move = np.eye(4, dtype=np.float32)
    move[:3, 3] = c + 0.3 * np.asarray([np.sin(0.2 * t), 0.0,
                                        np.cos(0.2 * t)], np.float32)
    back = np.eye(4, dtype=np.float32)
    back[:3, 3] = -c
    new[BOX] = move @ rot @ back @ new[BOX]
    return new


def _carry(scene: dict) -> dict:
    """A JAX scene dict as numpy, keeping what interop reads as it is (the
    SDF's float voxel size, coarse tables, the dynamic volume list and
    window tokens)."""
    keep = ("sdf_voxel_size", "sdf_dyn_tokens")
    out = {}
    for k, v in scene.items():
        if k == "sdf_coarse":
            out[k] = (np.asarray(v[0]), np.asarray(v[1]), v[2], v[3])
        elif k == "sdf_dyn_vols":
            out[k] = [np.asarray(x) for x in v]
        else:
            out[k] = v if k in keep else np.asarray(v)
    return out


def test_object_transforms_match_jax():
    """apply_object_transforms on tests/test_frame.py:108's moved and
    turned objects: corners, normals, tangents, bitangents and culling
    bounds equal the JAX function's (run op by op) bit for bit; the JAX
    frame's jit contracts the corner sums into FMAs, which moves corners
    by at most 1e-6 (7 ulp here)."""
    rs = jsb.build_render_scene(jproc.build_atrium_scene(
        jproc.AtriumConfig(**SMALL_ATRIUM), textured=False))
    j_scene = jframe.scene_to_device(rs)
    t_scene = interop.scene_from_arrays(
        {k: np.asarray(v) for k, v in j_scene.items()}, device="cpu")
    new = _moved(rs.object_matrices)
    j_out = [np.asarray(a) for a in jframe._apply_object_transforms(
        j_scene, jnp.asarray(new))]
    t_out = [a.numpy() for a in tframe.apply_object_transforms(
        t_scene, torch.as_tensor(new))]
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(b, a)
    jit_corners = np.asarray(jax.jit(jframe._apply_object_transforms)(
        j_scene, jnp.asarray(new))[0])
    np.testing.assert_allclose(t_out[0], jit_corners, rtol=0, atol=1e-6)
    # the moved objects moved, the others stayed
    tc = rs.triangle_count
    moved = np.abs(t_out[0][:tc] - rs.corners[:tc]).max(axis=(1, 2)) > 1e-3
    obj = rs.tri_object[:tc]
    assert moved[(obj == 2) | (obj == 3)].all() and not moved[obj > 3].any()
    positions = tframe.apply_object_transforms(
        t_scene, torch.as_tensor(new), positions_only=True)
    np.testing.assert_array_equal(positions.numpy(), t_out[0])


def _dynamic_case(alpha=False):
    """40 random triangles of test_torch_alpha's kind (ortho view), their
    previous corners moved by up to 0.05 and seen through a perspective
    previous view-projection, so the previous w varies."""
    rng = np.random.default_rng(61)
    inputs, alpha_slots = _inputs(rng, 40)
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0] = vp[1, 1] = 2.0
    vp[0, 3] = vp[1, 3] = -1.0
    prev_vp = vp.copy()
    prev_vp[3, 2] = 0.6
    prev_vp[0, 3] = -0.97
    prev = (inputs[0] + rng.uniform(-0.05, 0.05, inputs[0].shape)).astype(
        np.float32)
    return inputs, prev, vp, prev_vp, (alpha_slots if alpha else None), rng


def _setups(case, bin_rows=2):
    inputs, prev, vp, prev_vp, slots, _ = case
    j = jr.geometry_setup(
        *[jnp.asarray(a) for a in inputs], jnp.asarray(vp),
        jnp.asarray(prev_vp), W, 64, cull="none", bin_rows=bin_rows,
        prev_corners=jnp.asarray(prev),
        tri_alpha_slot=None if slots is None else jnp.asarray(slots))
    t = tr.geometry_setup(
        *[torch.as_tensor(a) for a in inputs], torch.as_tensor(vp), W, 64,
        cull="none", bin_rows=bin_rows,
        tri_alpha_slot=None if slots is None else torch.as_tensor(slots),
        prev_view_proj=torch.as_tensor(prev_vp),
        prev_corners=torch.as_tensor(prev))
    return j, t


def test_prev_clip_rows_and_table_match_jax():
    """geometry_setup(prev_corners=...)'s 39 attribute rows equal the JAX
    function's (run op by op) bit for bit, and the 40-row pair table (39
    rows padded to a multiple of 8, zero row 39) of gather_pair_setups
    equals JAX's; without prev_corners the rows stay 30."""
    case = _dynamic_case()
    j, t = _setups(case)
    assert t.attrs.shape == (tr.NATTR_PREV, 40)
    valid = t.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(j.valid))
    np.testing.assert_array_equal(t.attrs.numpy()[:, valid],
                                  np.asarray(j.attrs)[:, valid])
    assert np.ptp(t.attrs.numpy()[36:39, valid]) > 0  # prev w varies
    jp = jr.build_pairs(j, 2, 2, bin_rows=2, order_rows=True,
                        interpret=True)
    tp = tr.build_pairs(t, 2, 2, bin_rows=2, order_rows=True)
    jpe, jpa = jr.gather_pair_setups(j, jp, True, row_extents=True)
    tpe, tpa = tr.gather_pair_setups(t, tp, row_extents=True)
    assert tpa.shape[0] == 40 and (tpa[39] == 0).all()
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(jpe))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    inputs, _, vp, _, _, _ = case
    static = tr.geometry_setup(*[torch.as_tensor(a) for a in inputs],
                               torch.as_tensor(vp), W, 64, cull="none")
    assert static.attrs.shape[0] == tr.NATTR


@pytest.mark.parametrize("stream", ["opaque", "alpha"])
def test_fifteen_channel_gbuffer_plain_matches_jax(stream):
    """Kernel B's (opaque) and kernels K + L's (alpha) plain versions with
    a dynamic scene's 40-row pair table against rasterize_gbuffer in
    interpret mode: 15 channels; depth and winners by test_torch_alpha's
    raster rule (<= 1e-3 of pixels differ, each on a triangle or
    mask-texel edge), all 15 channels within 1e-4 where both win the same
    triangle, channels 13-14 zero off the geometry."""
    alpha = stream == "alpha"
    case = _dynamic_case(alpha)
    j, t = _setups(case)
    masks = _masks(case[5]) if alpha else None
    jp = jr.build_pairs(j, 2, 2, bin_rows=2, order_rows=True,
                        interpret=True)
    jpe, jpa = jr.gather_pair_setups(j, jp, True, row_extents=True)
    jd, jv, jg = (np.asarray(x) for x in jr.rasterize_gbuffer(
        jpe, jpa, jp, 2, 2, interpret=True, sub=2, row_skip=True,
        alpha_masks=None if masks is None else jnp.asarray(masks)))
    tp = tr.build_pairs(t, 2, 2, bin_rows=2, order_rows=True)
    tpe, tpa = tr.gather_pair_setups(t, tp, row_extents=True)
    td, tv, tg = tr.rasterize_gbuffer(
        tpe, tpa, tp, 2, 2, sub=2, row_skip=True,
        alpha_masks=None if masks is None else torch.as_tensor(masks))
    assert tg.shape == jg.shape == (15, 64, W)
    j_ids = np.asarray(jr.winner_triangle_ids(jnp.asarray(jv), jp, 2, 2))
    t_ids = tr.winner_triangle_ids(tv, tp, 2, 2).numpy()
    _check_edges_only((j_ids != t_ids) | (jd != td.numpy()),
                      t.edges.numpy(), W, 64)
    both = (j_ids >= 0) & (j_ids == t_ids)
    assert both.mean() > 0.3
    np.testing.assert_allclose(tg.numpy()[:, both], jg[:, both], atol=1e-4,
                               rtol=0)
    assert (tg.numpy()[13:, tv.numpy() < 0] == 0).all()
    assert np.abs(tg.numpy()[13:, both]).max() > 0.1


@functools.lru_cache(maxsize=1)
def _dynamic_atrium():
    """The small textured atrium with its scene SDF baked by the JAX
    package's jnp path at 16^3 per mesh, the first box dynamic in the
    raster and in the SDF."""
    scene = jproc.build_atrium_scene(jproc.AtriumConfig(**SMALL_ATRIUM),
                                     textured=True)
    rs = jsb.build_render_scene(scene)
    gsdf, dset = jsdf.build_scene_sdf(rs, scene, use_jax_bake=True,
                                      bake_resolution_cap=16,
                                      dynamic_objects=(BOX,))
    j_scene = jframe.attach_dynamic_sdf(jframe.attach_global_sdf(
        jframe.scene_to_device(rs), gsdf), dset)
    return scene, rs, gsdf, dset, j_scene


def test_dynamic_sdf_set_matches_jax(monkeypatch):
    """build_scene_sdf(dynamic_objects=...) leaves the box out of the
    static composite as the JAX package does (the composite bit for bit)
    and describes it the same way (window, padded box, albedo)."""
    scene_j, rs, gsdf, dset, _ = _dynamic_atrium()
    t_scene = tproc.build_atrium_scene(tproc.AtriumConfig(**SMALL_ATRIUM),
                                       textured=True)
    t_rs = tsb.build_render_scene(t_scene)
    # the same per-mesh volumes: the JAX bake's, so that only the
    # composite and the set's description are compared
    vols = {}

    def bake(positions, indices, bb_min, bb_max, resolution, device):
        key = (tuple(np.round(bb_min, 6)), tuple(np.round(bb_max, 6)))
        return vols[key]
    from plainrenderer_tpu.assets import sdf_bake as jbake
    from plainrenderer_tpu.render.scenebuild import _mesh_arrays
    for obj in scene_j.objects:
        arrays = _mesh_arrays(scene_j.meshes[obj.mesh_index])
        lo, hi = arrays["positions"].min(0), arrays["positions"].max(0)
        res = tuple(min(r, 16) for r in jbake.sdf_resolution_for_aabb(lo, hi))
        vols[(tuple(np.round(lo, 6)), tuple(np.round(hi, 6)))] = np.asarray(
            jbake.bake_mesh_sdf(arrays["positions"], arrays["indices"], lo,
                                hi, resolution=res, use_jax=True))
    from plainrenderer_tpu_torch.assets import sdf_bake as tbake
    monkeypatch.setattr(tbake, "bake_mesh_sdf", bake)
    t_gsdf, t_dset = tsdf.build_scene_sdf(
        t_rs, t_scene, bake_resolution_cap=16, device="cpu",
        dynamic_objects=(BOX,))
    np.testing.assert_array_equal(t_gsdf.volume, gsdf.volume)
    np.testing.assert_array_equal(t_dset.object_index, dset.object_index)
    assert t_dset.window_vox == [tuple(w) for w in dset.window_vox]
    for k in ("pad_min", "pad_max", "albedo"):
        np.testing.assert_array_equal(getattr(t_dset, k), getattr(dset, k))
    np.testing.assert_array_equal(t_dset.volumes[0], dset.volumes[0])


def _int8_words(words):
    """The s8 distance quanta of packed (NB, 8, 128) words."""
    w = np.asarray(words).astype(np.int64)
    q = np.stack([(w >> (8 * b)) & 0xFF for b in range(4)], -1)
    return np.where(q > 127, q - 256, q)


def test_recomposite_matches_jax():
    """recomposite_dynamic (in the JAX frame's jit) against the port's, on
    the same pristine pools and instance data, the box moved and turned:
    the packed distance quanta equal on >= 99.9% of voxels and within 1
    quantum elsewhere (jnp.cbrt against |det|^(1/3) in f64, and XLA's
    contracted multiply-adds, move a distance by an ulp, which can cross a
    rounding boundary), the albedo words on >= 99.9%; both differ from the
    pristine pools inside the box's window and nowhere else, and the
    pristine pools are not written. The coarse tables the GI trace
    rebuilds from them equal the JAX function's run op by op on >= 99.9%
    of words; under jit XLA sums some coarse albedos in another order."""
    _, rs, _, _, j_scene = _dynamic_atrium()
    t_scene = interop.scene_from_arrays(_carry(j_scene), device="cpu")
    mats = _box_motion(rs.object_matrices, 7)
    j_vol, j_alb = jax.jit(
        lambda v, a, o, t: jsdf.recomposite_dynamic(
            v, a, o, j_scene["sdf_voxel_size"],
            j_scene["sdf_shape"].shape[:3], j_scene["sdf_dyn_vols"],
            j_scene["sdf_dyn_tokens"], j_scene["sdf_dyn_pad_min"],
            j_scene["sdf_dyn_pad_max"], j_scene["sdf_dyn_albedo"],
            j_scene["sdf_dyn_obj"], t))(
        j_scene["sdf_volume"], j_scene["sdf_albedo"], j_scene["sdf_origin"],
        jnp.asarray(mats))
    pristine = t_scene["sdf_volume"].clone(), t_scene["sdf_albedo"].clone()
    t_vol, t_alb = tsdf.recomposite_dynamic(
        t_scene["sdf_volume"], t_scene["sdf_albedo"], t_scene["sdf_origin"],
        t_scene["sdf_voxel_size"], t_scene["sdf_grid"],
        t_scene["sdf_dyn_vols"], t_scene["sdf_dyn_tokens"],
        t_scene["sdf_dyn_pad_min"], t_scene["sdf_dyn_pad_max"],
        t_scene["sdf_dyn_albedo"], t_scene["sdf_dyn_obj"],
        torch.as_tensor(mats))
    assert torch.equal(t_scene["sdf_volume"], pristine[0])
    assert torch.equal(t_scene["sdf_albedo"], pristine[1])
    jq, tq = _int8_words(j_vol), _int8_words(t_vol.numpy())
    assert (jq == tq).mean() >= 0.999, (jq == tq).mean()
    assert np.abs(jq - tq).max() <= 1
    assert (np.asarray(j_alb) == t_alb.numpy()).mean() >= 0.999
    from plainrenderer_tpu.ops import sdfgi as jgi
    from plainrenderer_tpu_torch.ops import sdfgi as tgi
    j_coarse = jgi.build_coarse_tables(j_vol, j_alb, t_scene["sdf_grid"])
    t_coarse = tgi.build_coarse_tables(t_vol, t_alb, t_scene["sdf_grid"])
    for a, b in zip(j_coarse[:2], t_coarse[:2]):
        assert (np.asarray(a) == b.numpy()).mean() >= 0.999
    changed = (t_vol != pristine[0]).flatten(1).any(1).numpy()
    assert changed.any()
    assert (np.asarray(j_vol) != np.asarray(j_scene["sdf_volume"])) \
        .reshape(len(changed), -1).any(1)[~changed].sum() == 0


def _dynamic_settings(cfg):
    """Slice 3's settings (3 cascades at 256x256 maps, SDF GI; TAA, bloom
    and fog off) with anisotropic texture filtering (texture_filter 2,
    trilinear as well)."""
    off = dict(enabled=False)
    return cfg.RenderSettings(
        width=W, height=H, exposure_adaption_speed=1000.0,
        shadows=cfg.ShadowSettings(resolution=256),
        taa=cfg.TAASettings(**off), bloom=cfg.BloomSettings(**off),
        volumetrics=cfg.VolumetricsSettings(**off),
        shading=cfg.ShadingConfig(texture_filter=2))


def test_three_dynamic_frames_match_jax():
    """3 frames of the textured small atrium whose first box moves and
    turns (raster and SDF), texture_filter 2, on a moving camera: the u8
    image by the golden rule (> 99.9% of pixels within 2 LSB), exposure
    at rtol 1e-4, debug_counters 0 on both sides, and the GI history (f16
    pairs) within 2 ulp on >= 95% and 16 ulp on >= 99% of words (measured
    96.6% and 99.13%). The static GI frame holds 99% and 99.9%
    (test_torch_frame): here the moved box empties the prebuilt coarse
    tables, both frames rebuild them from the recomposited pools (equal
    word for word in the frame), and XLA's jit sums 2.3% of the coarse
    albedo words in another order than the same function run op by op,
    which the port matches (test_recomposite_matches_jax); those albedos
    reach every GI ray that leaves its window. Frame 2's previous NDC
    (G-buffer channels 13-14) equals the static reprojection of its depth
    within 1e-4 on 99.9% of the static objects' pixels and differs from
    it by more than 1e-3 on 90% of the moving box's."""
    _, rs, _, _, j_scene = _dynamic_atrium()
    js, ts = _dynamic_settings(jcfg), _dynamic_settings(tcfg)
    j_luts = jframe.bake_static_luts(js)
    t_luts = interop.luts_from_arrays(
        {k: np.asarray(v) for k, v in j_luts.items()}, device="cpu")
    j_state = j_initial_state(W, H)
    t_state = interop.state_from_arrays(j_state, device="cpu")
    base = interop.scene_from_arrays(_carry(j_scene), device="cpu")
    views, rasters = [], []
    setup_fn, raster_fn = tframe.main_view_setup, tframe.raster_main_view
    tframe.main_view_setup = lambda *a, **k: (
        views.append(setup_fn(*a, **k)), views[-1])[1]
    tframe.raster_main_view = lambda *a, **k: (
        rasters.append(raster_fn(*a, **k)), rasters[-1])[1]
    try:
        for i in range(3):
            mats, prev = (_box_motion(rs.object_matrices, t)
                          for t in (i + 1, i))
            ext = jcam.extrinsic_from_angles(
                [0.05 * i, -1.7, 0.02 * i], pitch_deg=5.0,
                yaw_deg=20.0 + 0.3 * i)
            j_img, j_state = jframe.render_frame(
                j_state, dict(j_scene, object_transforms=jnp.asarray(mats),
                              prev_object_transforms=jnp.asarray(prev)),
                jframe.camera_arrays(ext.position, ext.forward, ext.right,
                                     ext.up),
                j_luts, jnp.asarray(0.016), js, interpret=True)
            t_img, t_state = tframe.render_frame(
                t_state, dict(base, object_transforms=torch.as_tensor(mats),
                              prev_object_transforms=torch.as_tensor(prev)),
                tframe.camera_arrays(ext.position, ext.forward, ext.right,
                                     ext.up, device="cpu"),
                t_luts, 0.016, ts, device="cpu")
    finally:
        tframe.main_view_setup, tframe.raster_main_view = setup_fn, raster_fn
    j_img, t_img = np.asarray(j_img).astype(np.int32), t_img.numpy()
    diff = np.abs(j_img - t_img.astype(np.int32))
    assert (diff <= 2).mean() > 0.999, ((diff <= 2).mean(), diff.max())
    assert 2 < t_img.mean() < 253 and t_img.std() > 5
    np.testing.assert_allclose(float(t_state.exposure),
                               float(j_state.exposure), rtol=1e-4)
    assert (np.asarray(j_state.debug_counters) == 0).all()
    assert (t_state.debug_counters.numpy() == 0).all()
    from test_torch_frame import _f16_ulps
    ulps = _f16_ulps(np.asarray(j_state.gi_history),
                     t_state.gi_history.numpy())
    assert (ulps <= 2).mean() >= 0.95, (ulps <= 2).mean()
    assert (ulps <= 16).mean() >= 0.99, (ulps <= 16).mean()
    # frame 2's previous NDC (G-buffer channels 13-14) against the static
    # reprojection of its depth: equal within 1e-4 on the static objects,
    # apart on the moving box
    static_err, box_err = prev_ndc_against_reprojection(
        views[2], rasters[2], views[1].view_proj, rs.tri_object, (BOX,))
    assert static_err.size > 1000 and box_err.size > 50
    assert np.quantile(static_err, 0.999) < 1e-4, static_err.max()
    assert (box_err > 1e-3).mean() > 0.9


def prev_ndc_against_reprojection(mv, main, prev_view_proj, tri_object,
                                  moving):
    """|channels 13-14 - static_prev_ndc| (max over x, y) of one frame's
    main view, on the pixels of static objects and on those of the moving
    ones (object indices `moving`)."""
    from plainrenderer_tpu_torch.ops import shade as tshade
    from plainrenderer_tpu_torch.utils.mathutils import lu_inverse

    ph, pw = main.depth.shape
    valid = main.vis >= 0
    world = tshade.reconstruct_world_position(
        main.depth, lu_inverse(mv.view_proj), pw, ph)
    err = (main.gbuf[tr._CH_PREV:tr._CH_PREV + 2] - tframe.static_prev_ndc(
        prev_view_proj, world, valid)).abs().amax(dim=0).numpy()
    ids = tr.winner_triangle_ids(main.vis, main.pairs, mv.n_tiles_x,
                                 mv.sub).numpy()
    obj = np.where(ids >= 0, np.asarray(tri_object)[np.maximum(ids, 0)], -1)
    on_moving = np.isin(obj, moving)
    return err[(obj >= 0) & ~on_moving], err[on_moving]


def test_identity_transforms_render_the_static_frame():
    """The port's version of tests/test_frame.py:151: the small untextured
    atrium with identity object transforms (the build matrices) renders
    within 1 LSB of the static path on > 99.9% of pixels over 2 frames of
    the default settings (512^2 shadow maps); the dynamic branch differs
    only by the rounding of M @ M^-1 and of the plane-interpolated
    previous NDC."""
    rs = tsb.build_render_scene(tproc.build_atrium_scene(
        tproc.AtriumConfig(**SMALL_ATRIUM), textured=False))
    scene = tframe.scene_to_device(rs, device="cpu")
    settings = tcfg.RenderSettings(
        width=W, height=H, exposure_adaption_speed=1000.0,
        shadows=tcfg.ShadowSettings(resolution=512))
    luts = tframe.bake_static_luts(settings, device="cpu")
    ext = jcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)
    cam = tframe.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                               device="cpu")
    build = torch.as_tensor(rs.object_matrices).float()
    images = []
    for dynamic in (False, True):
        sc = dict(scene, object_transforms=build,
                  prev_object_transforms=build) if dynamic else scene
        state = initial_state(W, H, device="cpu")
        for _ in range(2):
            img, state = tframe.render_frame(state, sc, cam, luts, 0.016,
                                             settings, device="cpu")
        images.append(img.numpy().astype(np.int32))
    close = (np.abs(images[0] - images[1]) <= 1).mean()
    assert close > 0.999, close
