"""The port's whole frame against the JAX package at 256x128: 3 frames of
the small untextured atrium with shadows, GI, TAA and bloom off (slice 1),
plus scene registration, the scene SDF, LUT/noise setup, the slice guard
and device selection. Slices 2 and 3 (the textured, shadowed atrium, with
SDF GI) and the GI block on the JAX frame's inputs are in
test_torch_frame_textured.py, test_torch_frame_gi.py and
test_torch_frame_gi_block.py, on the rule of torch_frame_checks.py."""

import dataclasses

import numpy as np
import pytest
import torch

from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.render.state import initial_state as j_initial_state
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.ops import sdf_scene as tsdf
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb
from plainrenderer_tpu_torch.render.state import FrameState, initial_state
from torch_frame_checks import (H, SMALL_ATRIUM, W, _arrays,
                                _check_three_frames, _textured_atrium_sdf,
                                shadow_settings, slice_settings)

torch.set_num_threads(1)


def test_three_frames_match_jax():
    """Slice 1: the untextured atrium without shadows (_check_three_frames)."""
    _check_three_frames(textured_shadowed=False)


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
