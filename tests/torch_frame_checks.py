"""The whole-frame comparison of the port with the JAX package at
256x128 that tests/test_torch_frame*.py share: the settings of slices 1-3,
the small textured atrium and its scene SDF (baked once a process), and
_check_three_frames, the rule 3 frames are held to. Not a test module:
each slow comparison is a test file of its own, so that pytest-xdist's
--dist loadfile can run them on different workers."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import sdf_scene as jsdf
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.render import frame as tframe

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
