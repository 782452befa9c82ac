"""The port's TAA supersampling pre-pass against the JAX package:
temporal_supersampling (history_resample through kernel I's plain version
with one tap, the (luminance, linear depth) pair through kernel H's plain
version with one plane) against JAX's temporal_supersampling in interpret
mode on a padded band, and 3 frames of the small atrium with TAA and the
pre-pass against the JAX frame.

Band rules: the acceptance mask (the pixels that take 50% of the last
frame) and both fetches' ok planes equal on every pixel; the output
colour within 1e-5 relative (atol 1e-6) and the luminance within 4 f32
ulps. XLA fuses the tonemap's products and the bilinear blends into
FMAs, the port rounds each step; the inverse tonemap divides by
1 - luminance, which magnifies an ulp near 1."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import taa as jtaa
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu.scene import camera as jcam
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.ops import color_packing as tcp
from plainrenderer_tpu_torch.ops import taa as ttaa
from plainrenderer_tpu_torch.ops.shadow import linearize_depth
from plainrenderer_tpu_torch.render import frame as tframe

torch.set_num_threads(1)

NEAR, FAR = 0.1, 300.0
BAND_H, BAND_W, HALO = 64, 256, 32


def _t(a):
    return torch.as_tensor(np.array(a))


def _edge_rows(a, n):
    """Edge-replicated rows above and below (the frame's halo_extend)."""
    pad = [(0, 0)] * (a.ndim - 2) + [(n, n), (0, 0)]
    return np.pad(a, pad, mode="edge")


def _band(seed):
    """A 64x256 band and its last frame, halo-extended by 32 rows: HDR
    colour with a bright block (luminance contrast crosses 0.5), a depth
    ramp whose linear depth steps across 1.0 against the last frame's,
    motion of a few pixels with a strip that reprojects off the window
    and one that leaves the frame."""
    rng = np.random.default_rng(seed)
    h, w = BAND_H, BAND_W
    color = (rng.random((3, h, w)) ** 2 * 1.5).astype(np.float32)
    color[:, 10:30, 40:90] *= 6.0
    depth = (0.02 + 0.3 * rng.random((h, w)) ** 4).astype(np.float32)
    motion = rng.normal(0, 1.5, (2, h, w)).astype(np.float32)
    motion[0, :, 200:] += 90.0
    motion[1, 40:48] -= 20.0
    motion /= np.array([w, h], np.float32)[:, None, None]
    prev = (color * (1 + 0.2 * rng.normal(size=(3, h, w)))).clip(0) \
        .astype(np.float32)
    prev_lum = (prev[0] * 0.21 + prev[1] * 0.72 + prev[2] * 0.07
                + rng.normal(0, 0.15, (h, w))).astype(np.float32)
    lin = NEAR * FAR / (FAR + (1.0 - depth) * (NEAR - FAR))
    prev_lin = (lin + rng.uniform(-1.6, 1.6, (h, w))).astype(np.float32)
    planes = dict(color=color, depth=depth, motion=motion,
                  prev_packed=tcp.pack_r11g11b10(_t(prev)).numpy(),
                  prev_ld=ttaa.pack_f16_pair(_t(prev_lum),
                                             _t(prev_lin)).numpy())
    return {k: _edge_rows(v, HALO) for k, v in planes.items()}


@functools.lru_cache(maxsize=None)
def _jax_pre_pass(use_tonemapping):
    """JAX's pre-pass jitted once per tonemapping flag, its kernels in
    interpret mode (an eager call recompiles them every time)."""
    return jax.jit(functools.partial(
        jtaa.temporal_supersampling, near=NEAR, far=FAR, width=BAND_W,
        height=BAND_H + 2 * HALO, use_tonemapping=use_tonemapping,
        interpret=True))


def _both(b, camera_cut, use_tonemapping, prev_packed=None):
    prev_packed = b["prev_packed"] if prev_packed is None else prev_packed
    j_out, j_lum = _jax_pre_pass(use_tonemapping)(
        jnp.asarray(b["color"]), jnp.asarray(prev_packed),
        jnp.asarray(b["prev_ld"]), jnp.asarray(b["motion"]),
        jnp.asarray(b["depth"]), camera_cut=jnp.asarray(camera_cut))
    t_out, t_lum = ttaa.temporal_supersampling(
        _t(b["color"]), _t(prev_packed), _t(b["prev_ld"]), _t(b["motion"]),
        _t(b["depth"]), NEAR, FAR, BAND_W, BAND_H + 2 * HALO,
        torch.tensor(camera_cut), use_tonemapping=use_tonemapping)
    return (np.asarray(j_out), np.asarray(j_lum)), (t_out.numpy(),
                                                    t_lum.numpy())


def _ulps(a, b):
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("camera_cut", [False, True], ids=["blend", "cut"])
@pytest.mark.parametrize("use_tonemapping", [True, False],
                         ids=["tonemap", "linear"])
def test_temporal_supersampling_matches_jax(camera_cut, use_tonemapping):
    """The band with its last frame and with a black last frame: the
    pixels whose output moves between the two are the accepted ones
    (acceptance reads the last colour only through its window test), so
    both sides' acceptance masks are compared exactly; a camera cut
    accepts nothing and returns the input within the tonemap's round
    trip."""
    b = _band(7)
    (j_out, j_lum), (t_out, t_lum) = _both(b, camera_cut, use_tonemapping)
    black = np.zeros_like(b["prev_packed"])
    (j_blk, _), (t_blk, _) = _both(b, camera_cut, use_tonemapping, black)
    j_acc = (j_out != j_blk).any(axis=0)
    t_acc = (t_out != t_blk).any(axis=0)
    np.testing.assert_array_equal(t_acc, j_acc)
    if camera_cut:
        assert not t_acc.any()
    else:
        assert 0.1 < t_acc.mean() < 0.9, t_acc.mean()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_blk, j_blk, rtol=1e-5, atol=1e-6)
    assert _ulps(t_lum, j_lum).max() <= 4
    assert np.isfinite(t_out).all()


def test_supersampling_rejects_by_each_test():
    """Each of three acceptance tests rejects pixels the others accept on
    the band: the 2x2 contrast, the linear depth and kernel I's window
    (tap 0's 2.5-texel margin). Kernel H's window (0.5 and 1.5 texels)
    holds wherever I's does, so it rejects only pixels I's rejects too.
    The two fetches' ok planes equal JAX's on every pixel."""
    b = _band(7)
    motion_d = ttaa.dilate_motion(_t(b["motion"]), _t(b["depth"]))
    hgt = BAND_H + 2 * HALO
    rgb, ok_i = ttaa.history_resample(_t(b["prev_packed"]), motion_d,
                                      BAND_W, hgt)
    ld, ok_h = ttaa.resample_packed_planes(_t(b["prev_ld"])[None], motion_d,
                                           BAND_W, hgt)
    j_md = jnp.asarray(motion_d.numpy())
    j_rgb, j_ok_i = jax.jit(functools.partial(
        jtaa.history_resample, width=BAND_W, height=hgt, interpret=True))(
        jnp.asarray(b["prev_packed"]), j_md)
    j_ld, j_ok_h = jax.jit(functools.partial(
        jtaa.resample_packed_planes, width=BAND_W, height=hgt,
        interpret=True))(jnp.asarray(b["prev_ld"])[None], j_md)
    np.testing.assert_array_equal(ok_i.numpy(), np.asarray(j_ok_i))
    np.testing.assert_array_equal(ok_h.numpy(), np.asarray(j_ok_h))
    mag = ttaa.history_taps_plain(
        _t(b["prev_packed"]),
        ttaa.reprojected_coords(motion_d, BAND_W, hgt))[:3]
    assert (np.abs(rgb.numpy() - np.asarray(j_rgb))
            <= 1e-6 * mag.numpy()).all()
    # H's bilinear blend: XLA fuses it into FMAs, the port rounds each step
    np.testing.assert_allclose(ld.numpy(), np.asarray(j_ld), rtol=1e-5,
                               atol=2e-6)
    from plainrenderer_tpu_torch.utils.color import luminance
    from plainrenderer_tpu_torch.utils.stencil import EdgePadded

    lum = luminance(_t(b["color"]))
    e, le = EdgePadded(lum, 1, 1), EdgePadded(ld[0], 1, 1)
    last_max = torch.stack([le.tap(dy, dx).abs() for dy, dx in
                            ((0, 0), (0, -1), (-1, 0), (-1, -1))]).amax(0)
    contrast_ok = sum(e.tap(dy, dx).abs() - last_max for dy, dx in
                      ((0, 0), (0, -1), (-1, 0), (-1, -1))) < 0.5
    d = EdgePadded(_t(b["depth"]), 1, 1)
    closest = torch.stack([d.tap(dy, dx) for dy in (-1, 0, 1)
                           for dx in (-1, 0, 1)]).amax(0)
    depth_ok = (linearize_depth(closest, NEAR, FAR) - ld[1]).abs() < 1.0
    assert bool((ok_h | ~ok_i).all()) and bool((~ok_h).any())
    tests = [contrast_ok, depth_ok, ok_i & ok_h]
    for k, t in enumerate(tests):
        others = torch.stack([o for j, o in enumerate(tests) if j != k]) \
            .all(0)
        assert bool((others & ~t).any()), k


def test_three_frames_with_the_pre_pass_match_jax():
    """3 frames of the small untextured atrium at 256x128 with TAA and
    the supersampling pre-pass (no shadows, GI or bloom), the camera
    moving a little every frame, JAX's state and LUTs carried over with
    interop: the u8 image by the golden rule (> 99.9% of pixels within 2
    LSB) and taa_luminance (the input luminance of frame 3, written to
    state') by the rule _check_three_frames in test_torch_frame.py holds
    prev_color to: rtol 1e-3 with atol 1e-3 x the frame's peak on >=
    99.9% of the pixels both sides cover or both leave to the sky. One
    JAX compile."""
    w, h = 256, 128

    def settings(cfg):
        return cfg.RenderSettings(
            width=w, height=h, exposure_adaption_speed=1000.0,
            shadows=cfg.ShadowSettings(cascade_count=0),
            sdf_trace=cfg.SDFTraceSettings(enabled=False),
            taa=cfg.TAASettings(use_separate_supersampling=True),
            bloom=cfg.BloomSettings(enabled=False))

    js, ts = settings(jcfg), settings(tcfg)
    rs = jsb.build_render_scene(jproc.build_atrium_scene(jproc.AtriumConfig(
        columns_per_row=2, floor_subdiv=2, box_count=3, box_subdiv=1,
        column_segments=8), textured=False))
    j_scene = jframe.scene_to_device(rs)
    j_luts = jframe.bake_static_luts(js)
    j_state = j_initial_state(w, h)
    t_scene = interop.scene_from_arrays(
        {k: np.asarray(v) for k, v in j_scene.items()}, device="cpu")
    t_luts = interop.luts_from_arrays(
        {k: np.asarray(v) for k, v in j_luts.items()}, device="cpu")
    t_state = interop.state_from_arrays(j_state, device="cpu")
    for i in range(3):
        ext = jcam.extrinsic_from_angles([0.05 * i, -1.7, 0.02 * i],
                                         pitch_deg=5.0, yaw_deg=20.0 + 0.3 * i)
        j_img, j_state = jframe.render_frame(
            j_state, j_scene, jframe.camera_arrays(
                ext.position, ext.forward, ext.right, ext.up),
            j_luts, jnp.asarray(0.016), js, interpret=True)
        t_img, t_state = tframe.render_frame(
            t_state, t_scene, tframe.camera_arrays(
                ext.position, ext.forward, ext.right, ext.up, device="cpu"),
            t_luts, 0.016, ts, device="cpu")
    j_img, t_img = np.asarray(j_img), t_img.numpy()
    diff = np.abs(j_img.astype(np.int32) - t_img.astype(np.int32))
    assert (diff <= 2).mean() > 0.999, ((diff <= 2).mean(), diff.max())
    assert 2 < t_img.mean() < 253 and t_img.std() > 5
    j_lum = np.asarray(j_state.taa_luminance)
    t_lum = t_state.taa_luminance.numpy()
    assert (j_lum != 0).mean() > 0.5
    same_cover = (np.asarray(j_state.prev_depth) > 0) == \
        (t_state.prev_depth.numpy() > 0)
    assert same_cover.mean() > 0.999
    close = np.isclose(t_lum, j_lum, rtol=1e-3,
                       atol=1e-3 * np.abs(j_lum).max())
    assert close[same_cover].mean() >= 0.999, close[same_cover].mean()
    # the pre-pass changes the frame: the same 3 frames without it differ
    plain = dataclasses.replace(ts, taa=tcfg.TAASettings())
    st = interop.state_from_arrays(j_initial_state(w, h), device="cpu")
    for i in range(3):
        ext = jcam.extrinsic_from_angles([0.05 * i, -1.7, 0.02 * i],
                                         pitch_deg=5.0, yaw_deg=20.0 + 0.3 * i)
        img, st = tframe.render_frame(
            st, t_scene, tframe.camera_arrays(
                ext.position, ext.forward, ext.right, ext.up, device="cpu"),
            t_luts, 0.016, plain, device="cpu")
    assert (img.numpy() != t_img).any()
    assert not bool(st.taa_luminance.any())
