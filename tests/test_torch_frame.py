"""The port's whole frame against the JAX package at 256x128: 3 frames of
the small untextured atrium with shadows, GI, TAA and bloom off (slice 1),
3 frames of the small textured atrium with the default sun shadows at
256x256 maps (slice 2; fog, GI, TAA and bloom off), 3 frames of it with
SDF GI on as well (slice 3), plus scene registration, the scene SDF,
LUT/noise setup, the slice guard and device selection."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import sdf_scene as jsdf
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.ops import sdf_scene as tsdf
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb
from plainrenderer_tpu_torch.render.state import FrameState, initial_state

torch.set_num_threads(1)

W, H = 256, 128
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)  # test_frame.py:25-34


def slice_settings(cfg):
    return cfg.RenderSettings(
        width=W, height=H, exposure_adaption_speed=1000.0,
        shadows=cfg.ShadowSettings(cascade_count=0),
        sdf_trace=cfg.SDFTraceSettings(enabled=False),
        taa=cfg.TAASettings(enabled=False),
        bloom=cfg.BloomSettings(enabled=False))


def shadow_settings(cfg):
    """Slice 2: the default ShadowSettings (3 cascades, 12 PCF taps) with
    256x256 maps; fog off (it runs only with shadows, a later slice)."""
    return dataclasses.replace(
        slice_settings(cfg), shadows=cfg.ShadowSettings(resolution=256),
        volumetrics=cfg.VolumetricsSettings(enabled=False))


def gi_settings(cfg):
    """Slice 3: slice 2 with the default SDFTraceSettings() (half-res,
    128 steps, influence 3, coarse fallback) and indirect_lighting_tech
    0."""
    return dataclasses.replace(shadow_settings(cfg),
                               sdf_trace=cfg.SDFTraceSettings())


def _arrays(d):
    """A JAX scene/LUT dict as numpy, keeping the SDF's float voxel size
    and coarse-table tuple (see interop.scene_from_arrays)."""
    out = {}
    for k, v in d.items():
        if k == "sdf_coarse":
            out[k] = (np.asarray(v[0]), np.asarray(v[1]), v[2], v[3])
        elif k == "sdf_voxel_size":
            out[k] = v
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=1)
def _textured_atrium_sdf():
    """The small textured atrium and its scene SDF, baked by the JAX
    package's jnp path at 16^3 per mesh (bench.py:93-95 uses 32)."""
    scene = jproc.build_atrium_scene(jproc.AtriumConfig(**SMALL_ATRIUM),
                                     textured=True)
    rs = jsb.build_render_scene(scene)
    return scene, rs, jsdf.build_scene_sdf(rs, scene, use_jax_bake=True,
                                           bake_resolution_cap=16)


def test_three_frames_match_jax():
    """Slice 1: the untextured atrium without shadows (_check_three_frames)."""
    _check_three_frames(textured_shadowed=False)


def test_three_frames_textured_shadowed_match_jax():
    """Slice 2: the textured atrium (banner_count=0) with the default sun
    shadows at 256x256 maps (_check_three_frames)."""
    _check_three_frames(textured_shadowed=True)


def test_three_frames_gi_match_jax():
    """Slice 3: the textured atrium with sun shadows and SDF GI, the JAX
    scene and its SDF carried across by interop; the camera moves a little
    every frame, as on the bench path (_check_three_frames). The GI history
    after frame 3: f16 words within 2 ulp on >= 99% and within 16 ulp on
    >= 99.9%. Ulp-level differences upstream (raster depth, kernel B's
    normals within 1e-4, the sky LUT's cancellation-sensitive texels)
    redirect a few rays, and the 16-tap spatial filter spreads each over
    ~150 half-res pixels, so 2 ulp on 99.9% is not reached here; fed the
    JAX frame's GI inputs, the GI block reaches it
    (test_gi_block_on_jax_inputs_matches_jax_history)."""
    _check_three_frames(textured_shadowed=True, gi=True)


def _check_three_frames(textured_shadowed: bool, gi: bool = False):
    """3 frames from the same scene, state and LUTs (carried over with
    interop): the u8 image by the golden rule (test_golden.py:30-31, more
    than 99.9% of pixels within 2 LSB); exposure at rtol 1e-4 (a few
    float32 scalar transcendentals); prev_color at rtol 1e-3 on pixels both
    sides cover or both leave to the sky, with atol 1e-3 x the frame's
    peak for the sky LUT's cancellation-sensitive texels (see
    test_torch_post.test_lut_bakes_match_jitted_jax), except on at most
    0.1% of pixels where the textured frame's shadow or texture window can
    differ (a u16 map texel one step off, see test_torch_shadow);
    debug_counters 0 on both sides. Untextured without shadows (slice 1)
    and textured with sun shadows (slice 2, banner_count=0)."""
    settings = (gi_settings if gi else shadow_settings if textured_shadowed
                else slice_settings)
    js, ts = settings(jcfg), settings(tcfg)
    if gi:
        _, rs, gsdf = _textured_atrium_sdf()
    else:
        rs = jsb.build_render_scene(jproc.build_atrium_scene(
            jproc.AtriumConfig(**SMALL_ATRIUM), textured=textured_shadowed))
    assert (rs.tex_word0 is not None) == textured_shadowed
    assert rs.alpha_masks is None
    j_scene = jframe.scene_to_device(rs)
    if gi:
        j_scene = jframe.attach_global_sdf(j_scene, gsdf)
    j_luts = jframe.bake_static_luts(js)
    j_state = j_initial_state(W, H)
    t_scene = interop.scene_from_arrays(_arrays(j_scene), device="cpu")
    t_luts = interop.luts_from_arrays(_arrays(j_luts), device="cpu")
    t_state = interop.state_from_arrays(j_state, device="cpu")
    ext = jcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)  # test_frame.py:42
    j_cam = jframe.camera_arrays(ext.position, ext.forward, ext.right,
                                 ext.up)
    t_cam = tframe.camera_arrays(ext.position, ext.forward, ext.right,
                                 ext.up, device="cpu")
    for i in range(3):
        if gi:
            ext = jcam.extrinsic_from_angles(
                [0.05 * i, -1.7, 0.02 * i], pitch_deg=5.0,
                yaw_deg=20.0 + 0.3 * i)
            j_cam = jframe.camera_arrays(ext.position, ext.forward,
                                         ext.right, ext.up)
            t_cam = tframe.camera_arrays(ext.position, ext.forward,
                                         ext.right, ext.up, device="cpu")
        j_img, j_state = jframe.render_frame(
            j_state, j_scene, j_cam, j_luts, jnp.asarray(0.016), js,
            interpret=True)
        t_img, t_state = tframe.render_frame(
            t_state, t_scene, t_cam, t_luts, 0.016, ts, device="cpu")
    j_img, t_img = np.asarray(j_img), t_img.numpy()
    assert t_img.shape == (H, W, 3) and t_img.dtype == np.uint8
    diff = np.abs(j_img.astype(np.int32) - t_img.astype(np.int32))
    assert (diff <= 2).mean() > 0.999, ((diff <= 2).mean(), diff.max())
    assert 2 < t_img.mean() < 253 and t_img.std() > 5
    assert int(t_state.frame_index) == 3
    np.testing.assert_allclose(float(t_state.exposure),
                               float(j_state.exposure), rtol=1e-4)
    j_prev, t_prev = np.asarray(j_state.prev_color), t_state.prev_color.numpy()
    same_cover = (np.asarray(j_state.prev_depth) > 0) == \
        (t_state.prev_depth.numpy() > 0)
    assert same_cover.mean() > 0.999
    close = np.isclose(t_prev, j_prev, rtol=1e-3,
                       atol=1e-3 * np.abs(j_prev).max()).all(axis=0)
    assert close[same_cover].mean() >= (0.999 if textured_shadowed else 1.0)
    assert (np.asarray(j_state.debug_counters) == 0).all()
    assert (t_state.debug_counters.numpy() == 0).all()
    if gi:
        ulps = _f16_ulps(np.asarray(j_state.gi_history),
                         t_state.gi_history.numpy())
        assert (ulps <= 2).mean() >= 0.99, (ulps <= 2).mean()
        assert (ulps <= 16).mean() >= 0.999, (ulps <= 16).mean()
        assert (t_state.gi_history.numpy() != 0).mean() > 0.5


def _f16_ulps(a, b):
    """Ulp distance of the f16 halves of two packed-pair word planes."""
    def ordered(words):  # f16 halves as sign-magnitude ordered ints
        h = np.stack([words & 0xFFFF, (words >> 16) & 0xFFFF]) \
            .astype(np.int64)
        return np.where(h & 0x8000, -(h & 0x7FFF), h & 0x7FFF)
    return np.abs(ordered(a) - ordered(b))


def test_gi_block_on_jax_inputs_matches_jax_history(monkeypatch):
    """The port's GI block (frame.sdf_gi) fed, each frame, the JAX frame's
    own GI inputs (G-buffer at GI resolution, ray directions, low-res sky,
    sun, motion, depth) while it carries its own history: the GI history
    after each of test_three_frames_gi_match_jax's 3 frames is within 2
    f16 ulp of the JAX history on >= 99.9% of words. So the whole-frame
    test's wider spread comes from the inputs upstream of the GI block,
    not from the block."""
    import jax

    from plainrenderer_tpu.ops import sdfgi as j_sdfgi
    from plainrenderer_tpu.ops import taa as j_taa

    js, ts = gi_settings(jcfg), gi_settings(tcfg)
    _, rs, gsdf = _textured_atrium_sdf()
    j_scene = jframe.attach_global_sdf(jframe.scene_to_device(rs), gsdf)
    j_luts = jframe.bake_static_luts(js)
    t_scene = interop.scene_from_arrays(_arrays(j_scene), device="cpu")
    t_luts = interop.luts_from_arrays(_arrays(j_luts), device="cpu")

    # record the JAX frame's GI inputs on their way into its GI functions,
    # in a jit of a function of its own: jit reuses the trace of a function
    # it has traced before, which would skip the recorders
    seen = {}

    def recording(module, name, keep):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            jax.debug.callback(
                lambda *a: seen.__setitem__(name, [np.array(x) for x in a]),
                *(args[i] for i in keep))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    recording(j_sdfgi, "trace_gi", (0, 1, 2, 3, 4, 10, 11, 12))
    recording(j_sdfgi, "neighborhood_resolve", (3,))
    recording(j_taa, "compute_motion", (0, 1))
    recording(j_sdfgi, "upscale_half_to_full", (2,))

    @functools.partial(jax.jit, static_argnames=("settings", "interpret"))
    def j_render(state, scene, cam, luts, delta_time, settings, interpret):
        return jframe.render_frame.__wrapped__(state, scene, cam, luts,
                                               delta_time, settings,
                                               interpret)

    j_state = j_initial_state(W, H)
    history = interop.state_from_arrays(j_state, device="cpu").gi_history
    for i in range(3):
        t_state = dataclasses.replace(
            interop.state_from_arrays(j_state, device="cpu"),
            gi_history=history)
        ext = jcam.extrinsic_from_angles([0.05 * i, -1.7, 0.02 * i],
                                         pitch_deg=5.0, yaw_deg=20.0 + 0.3 * i)
        _, j_state = j_render(
            j_state, j_scene, jframe.camera_arrays(
                ext.position, ext.forward, ext.right, ext.up),
            j_luts, jnp.asarray(0.016), js, interpret=True)
        jax.effects_barrier()
        wpos, normal, dirs, valid, sky_lowres, sun_dir, sun_col, sun_str = \
            [torch.from_numpy(a) for a in seen["trace_gi"]]
        halo = (seen["neighborhood_resolve"][0].shape[0]
                - history.shape[1]) // 2
        inp = tframe.GITraceInputs(
            valid=valid, world_pos=wpos, normal=normal,
            lin_depth=torch.from_numpy(
                seen["neighborhood_resolve"][0][halo:-halo]),
            ray_dirs=dirs, sky_lowres=sky_lowres)
        monkeypatch.setattr(tframe, "gi_trace_inputs", lambda *a: inp)
        prev_ndc, valid_full = [torch.from_numpy(a)
                                for a in seen["compute_motion"]]
        depth = torch.from_numpy(seen["upscale_half_to_full"][0])
        _, _, history = tframe.sdf_gi(
            t_state, t_scene, t_luts, ts, valid_full, None, None, depth,
            None, prev_ndc, None, sun_dir, sun_col, sun_str)
        ulps = _f16_ulps(np.asarray(j_state.gi_history), history.numpy())
        assert (ulps <= 2).mean() >= 0.999, (i, (ulps <= 2).mean())
    assert (history.numpy() != 0).mean() > 0.5


def test_scene_build_and_luts_match_jax():
    """The port's numpy copies of the procedural atrium, scene registration
    and blue-noise generator give bit-identical arrays; scene_to_device
    holds the same numbers as the JAX dict."""
    cfg_kw = dict(SMALL_ATRIUM, banner_count=2)
    j_rs = jsb.build_render_scene(jproc.build_atrium_scene(
        jproc.AtriumConfig(**cfg_kw), textured=False))
    t_rs = tsb.build_render_scene(tproc.build_atrium_scene(
        tproc.AtriumConfig(**cfg_kw), textured=False))
    for f in dataclasses.fields(t_rs):
        a, b = getattr(j_rs, f.name), getattr(t_rs, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif b is None:
            assert a is None, f.name
        else:
            assert a == b, f.name
    j_scene = jframe.scene_to_device(j_rs)
    t_scene = tframe.scene_to_device(t_rs, device="cpu")
    assert sorted(j_scene) == sorted(t_scene)
    for k in t_scene:
        np.testing.assert_array_equal(np.asarray(j_scene[k]),
                                      t_scene[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(jframe._blue_noise_textures(),
                                  tframe._blue_noise_textures())


def test_scene_sdf_matches_jax():
    """build_scene_sdf (the port's torch bake on the CPU + the host
    composite) against the JAX package's jnp bake on the small textured
    atrium: volumes within 1e-5, albedo, origin and voxel size equal; and
    attach_global_sdf of one GlobalSDF equals the JAX scene's SDF keys
    carried across by interop, coarse tables included; interop refuses an
    incomplete dynamic SDF group and keys it does not read."""
    scene, rs, want = _textured_atrium_sdf()
    got = tsdf.build_scene_sdf(rs, scene, bake_resolution_cap=16,
                               device="cpu")
    assert got.volume.shape == want.volume.shape
    np.testing.assert_allclose(got.volume, want.volume, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.albedo, want.albedo)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert got.voxel_size == want.voxel_size
    carried = interop.scene_from_arrays(
        _arrays(jframe.attach_global_sdf(jframe.scene_to_device(rs), want)),
        device="cpu")
    mine = tframe.attach_global_sdf(
        tframe.scene_to_device(tsb.build_render_scene(
            tproc.build_atrium_scene(tproc.AtriumConfig(**SMALL_ATRIUM),
                                     textured=True)), device="cpu"), want)
    assert sorted(mine) == sorted(carried)
    for k in ("sdf_volume", "sdf_albedo", "sdf_origin", "sdf_dims"):
        np.testing.assert_array_equal(mine[k].numpy(), carried[k].numpy(),
                                      err_msg=k)
    assert mine["sdf_voxel_size"] == carried["sdf_voxel_size"]
    assert mine["sdf_grid"] == carried["sdf_grid"] == (64, 48, 112)
    for a, b in zip(mine["sdf_coarse"][:2], carried["sdf_coarse"][:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert mine["sdf_coarse"][2:] == carried["sdf_coarse"][2:]
    # the dynamic SDF keys cross as one group (tests/test_torch_dynamic.py):
    # a part of the group is refused, and so is a key the port never reads
    with pytest.raises(ValueError):
        interop.scene_from_arrays(dict(_arrays(jframe.scene_to_device(rs)),
                                       sdf_dyn_vols=[]), device="cpu")
    with pytest.raises(NotImplementedError):
        interop.scene_from_arrays(dict(_arrays(jframe.scene_to_device(rs)),
                                       unknown_key=np.zeros(1)),
                                  device="cpu")


def test_initial_state_and_interop_match_jax():
    """Every FrameState field at the JAX package's padded sizes, and the
    interop conversion keeps them."""
    j = j_initial_state(W, 120)
    t = initial_state(W, 120, device="cpu")
    for f in dataclasses.fields(FrameState):
        a, b = np.asarray(getattr(j, f.name)), getattr(t, f.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    carried = interop.state_from_arrays(j, device="cpu")
    assert carried.prev_color.shape == (3, 128, W)
    full = initial_state(W, 120, gi_half_res=False, device="cpu")
    assert full.gi_history.shape == \
        j_initial_state(W, 120, gi_half_res=False).gi_history.shape


def test_render_frame_refuses_settings_outside_the_slice():
    """The port raises instead of skipping a pass it does not render: more
    than 4 cascades. The TAA supersampling pre-pass renders (slice 14,
    tests/test_torch_supersampling.py) and writes taa_luminance. TAA, bloom and
    froxel fog run (slice 4, with the default RenderSettings():
    tests/test_torch_golden.py), and so does alpha-tested geometry (slice
    5, tests/test_torch_alpha_frame.py): a scene whose alpha_masks is None
    renders as the opaque scene does. Trilinear / anisotropic texture
    filtering and dynamic objects run too (slice 6,
    tests/test_torch_texture_filter.py, tests/test_torch_dynamic.py), and
    so do the three debug views (slice 13, tests/test_torch_debugviz.py):
    bounding boxes and the cascade tint change the frame here, and the
    SDF debug view leaves a scene without an SDF as it is (frame.py:1084).
    """
    rs = tsb.build_render_scene(tproc.build_atrium_scene(
        tproc.AtriumConfig(**SMALL_ATRIUM), textured=False))
    scene = tframe.scene_to_device(rs, device="cpu")
    luts = {"transmission": torch.zeros(3, 128, 128),
            "multiscatter": torch.zeros(3, 32, 32)}
    state = initial_state(W, H, device="cpu")
    cam = tframe.camera_arrays([0, -1.7, 0], [1, 0, 0], [0, 0, 1],
                               [0, -1, 0], device="cpu")
    base = slice_settings(tcfg)
    shadowed = shadow_settings(tcfg)
    bad = [dataclasses.replace(shadowed, shadows=tcfg.ShadowSettings(
               cascade_count=5))]
    for settings in bad:
        with pytest.raises(NotImplementedError):
            tframe.render_frame(state, scene, cam, luts, 0.016, settings,
                                device="cpu")
    pre_pass = dataclasses.replace(base, taa=tcfg.TAASettings(
        use_separate_supersampling=True))
    img, new = tframe.render_frame(state, scene, cam, luts, 0.016, pre_pass,
                                   device="cpu")
    assert img.shape == (H, W, 3)
    assert bool(torch.isfinite(new.taa_luminance).all())
    assert bool((new.taa_luminance > 0).any())
    # alpha-tested geometry is in the port; alpha_masks=None is the opaque
    # path (scene.get in frame.py:408)
    images = [tframe.render_frame(state, sc, cam, luts, 0.016, base,
                                  device="cpu")[0]
              for sc in (scene, dict(scene, alpha_masks=None))]
    assert torch.equal(images[0], images[1])
    # the debug views draw (ops/debugviz.py)
    luts = dict(luts, blue_noise=torch.zeros(4, 32, 32))  # shadow PCF's
    shaded = tframe.render_frame(state, scene, cam, luts, 0.016, shadowed,
                                 device="cpu")[0]
    for plain, settings in (
            (images[0], dataclasses.replace(base, draw_bounding_boxes=True)),
            (shaded, dataclasses.replace(shadowed, shadows=tcfg.ShadowSettings(
                resolution=256, debug_cascade_colors=True)))):
        img = tframe.render_frame(state, scene, cam, luts, 0.016, settings,
                                  device="cpu")[0]
        assert (img != plain).any()
    img = tframe.render_frame(state, scene, cam, luts, 0.016,
                              dataclasses.replace(
                                  base, sdf_debug=tcfg.SDFDebugSettings(1)),
                              device="cpu")[0]
    assert torch.equal(img, images[0])


def test_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    """With no usable GPU, an entry point called without a device raises
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        initial_state(W, H)
    with pytest.raises(RuntimeError):
        tframe.camera_arrays([0, 0, 0], [1, 0, 0], [0, 0, 1], [0, -1, 0])
    with pytest.raises(RuntimeError):
        tframe.bake_static_luts(slice_settings(tcfg))
    assert initial_state(W, H, device="cpu").prev_color.device.type == "cpu"
