"""The port's whole frame against the JAX package at 256x128: 3 frames of
the small untextured atrium with shadows, GI, TAA and bloom off (slice 1),
3 frames of the small textured atrium with the default sun shadows at
256x256 maps (slice 2; fog, GI, TAA and bloom off), plus scene
registration, LUT/noise setup, the slice guard and device selection."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.assets import procedural as tproc
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


def _arrays(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_three_frames_match_jax():
    """Slice 1: the untextured atrium without shadows (_check_three_frames)."""
    _check_three_frames(textured_shadowed=False)


def test_three_frames_textured_shadowed_match_jax():
    """Slice 2: the textured atrium (banner_count=0) with the default sun
    shadows at 256x256 maps (_check_three_frames)."""
    _check_three_frames(textured_shadowed=True)


def _check_three_frames(textured_shadowed: bool):
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
    settings = shadow_settings if textured_shadowed else slice_settings
    js, ts = settings(jcfg), settings(tcfg)
    rs = jsb.build_render_scene(jproc.build_atrium_scene(
        jproc.AtriumConfig(**SMALL_ATRIUM), textured=textured_shadowed))
    assert (rs.tex_word0 is not None) == textured_shadowed
    assert rs.alpha_masks is None
    j_scene = jframe.scene_to_device(rs)
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
    for _ in range(3):
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


def test_render_frame_refuses_settings_outside_the_slice():
    """RenderSettings() defaults turn on GI, TAA, bloom and fog: the port
    raises instead of skipping them; so does each one alone (fog only with
    shadows, where it runs), trilinear / anisotropic texture filtering,
    cascade debug colours, and a scene with alpha-tested geometry or
    dynamic objects."""
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
    bad = [tcfg.RenderSettings(width=W, height=H),
           dataclasses.replace(base, shadows=tcfg.ShadowSettings()),
           dataclasses.replace(base, sdf_trace=tcfg.SDFTraceSettings()),
           dataclasses.replace(base, taa=tcfg.TAASettings()),
           dataclasses.replace(base, bloom=tcfg.BloomSettings()),
           dataclasses.replace(base, draw_bounding_boxes=True),
           dataclasses.replace(base, sdf_debug=tcfg.SDFDebugSettings(1)),
           dataclasses.replace(base, shading=tcfg.ShadingConfig(
               texture_filter=1)),
           dataclasses.replace(shadowed, shadows=tcfg.ShadowSettings(
               resolution=256, debug_cascade_colors=True)),
           dataclasses.replace(shadowed, shadows=tcfg.ShadowSettings(
               cascade_count=5))]
    for settings in bad:
        with pytest.raises(NotImplementedError):
            tframe.render_frame(state, scene, cam, luts, 0.016, settings,
                                device="cpu")
    for key in ("alpha_masks", "object_transforms"):
        with pytest.raises(NotImplementedError):
            tframe.render_frame(state, dict(scene, **{key: None}), cam, luts,
                                0.016, base, device="cpu")


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
