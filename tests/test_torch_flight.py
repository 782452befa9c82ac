"""The port's camera-path mode and render_flight on the CPU: 3 frames along
a 3-camera path (tests/test_frame.py:364-401's path) against the JAX
package's render_flight(interpret=True) at 256x128, the flight against
single frames with per-frame camera dicts bit for bit, the path's leaf
check and a flight of one frame. The flight's CUDA graph runs only on the
card (tests/test_torch_cuda.py)."""

import dataclasses
import functools

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
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render.state import FrameState

torch.set_num_threads(1)

W, H = 256, 128
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)  # test_frame.py:25-34
# test_frame.py:370-381: (position, pitch, yaw) of c0, c1; the path c0 c1 c0
CAMERAS = (([0.0, -1.7, 0.0], 5.0, 20.0), ([0.2, -1.7, 0.1], 6.0, 22.0))
PATH = (0, 1, 0)
FIELDS = [f.name for f in dataclasses.fields(FrameState)]


def settings(cfg):
    """test_torch_frame.py's slice-1 settings: the untextured atrium with
    shadows, GI, TAA and bloom off, exposure converging at once."""
    return cfg.RenderSettings(
        width=W, height=H, exposure_adaption_speed=1000.0,
        shadows=cfg.ShadowSettings(cascade_count=0),
        sdf_trace=cfg.SDFTraceSettings(enabled=False),
        taa=cfg.TAASettings(enabled=False),
        bloom=cfg.BloomSettings(enabled=False))


def _extrinsics():
    return [jcam.extrinsic_from_angles(pos, pitch_deg=pitch, yaw_deg=yaw)
            for pos, pitch, yaw in CAMERAS]


@functools.lru_cache(maxsize=1)
def _setup():
    """The JAX scene, LUTs and initial state, and the port's copies of them
    (interop), on the CPU."""
    rs = jsb.build_render_scene(jproc.build_atrium_scene(
        jproc.AtriumConfig(**SMALL_ATRIUM), textured=False))
    j_scene = jframe.scene_to_device(rs)
    j_luts = jframe.bake_static_luts(settings(jcfg))
    j_state = j_initial_state(W, H)
    t_scene = interop.scene_from_arrays(
        {k: np.asarray(v) for k, v in j_scene.items()}, device="cpu")
    t_luts = interop.luts_from_arrays(
        {k: np.asarray(v) for k, v in j_luts.items()}, device="cpu")
    t_state = interop.state_from_arrays(j_state, device="cpu")
    return j_scene, j_luts, j_state, t_scene, t_luts, t_state


def _port_cams():
    """The port's per-frame camera dicts and the path stacked from them."""
    cams = [tframe.camera_arrays(e.position, e.forward, e.right, e.up,
                                 device="cpu") for e in _extrinsics()]
    per_frame = [cams[i] for i in PATH]
    path = {k: torch.stack([c[k] for c in per_frame]) for k in cams[0]}
    return per_frame, path


@functools.lru_cache(maxsize=1)
def _port_runs():
    """The port's 3 frames three ways: camera-path render_frame calls,
    render_flight, and render_frame with per-frame camera dicts."""
    *_, t_scene, t_luts, t_state = _setup()
    per_frame, path = _port_cams()
    ts = settings(tcfg)
    runs = {}
    for name, cams in (("path", [path] * 3), ("dicts", per_frame)):
        img, st = None, t_state
        for cam in cams:
            img, st = tframe.render_frame(st, t_scene, cam, t_luts, 0.016,
                                          ts, device="cpu")
        runs[name] = (img, st)
    runs["flight"] = tframe.render_flight(t_state, t_scene, path, t_luts,
                                          0.016, ts, 3, device="cpu")
    return runs


def test_flight_matches_jax_render_flight():
    """The port's 3 camera-path frames and its render_flight against the
    JAX package's render_flight (one lax.scan, kernels in interpret mode)
    on the same path: the image by the golden rule (test_golden.py:30-31,
    more than 99.9% of pixels within 2 LSB; the raster's depth differs
    from XLA:CPU's fused products by a few ulps, see test_torch_frame.py),
    frame_index equal, exposure within rtol 1e-4."""
    j_scene, j_luts, j_state, *_ = _setup()
    cams = [jframe.camera_arrays(e.position, e.forward, e.right, e.up)
            for e in _extrinsics()]
    j_path = {k: jnp.stack([cams[i][k] for i in PATH]) for k in cams[0]}
    j_img, j_st = jframe.render_flight(j_state, j_scene, j_path, j_luts,
                                       jnp.asarray(0.016), settings(jcfg), 3,
                                       interpret=True)
    j_img = np.asarray(j_img).astype(np.int32)
    assert int(j_st.frame_index) == 3
    for name in ("path", "flight"):
        img, st = _port_runs()[name]
        assert img.shape == (H, W, 3) and img.dtype == torch.uint8
        diff = np.abs(img.numpy().astype(np.int32) - j_img)
        assert (diff <= 2).mean() > 0.999, (name, (diff <= 2).mean())
        assert 2 < img.float().mean() < 253 and img.float().std() > 5
        assert int(st.frame_index) == int(j_st.frame_index)
        np.testing.assert_allclose(float(st.exposure),
                                   float(j_st.exposure), rtol=1e-4)
        assert (st.debug_counters.numpy() == 0).all()


@pytest.mark.parametrize("name", ["path", "flight"])
def test_flight_equals_single_frames(name):
    """Camera-path frames and render_flight on the CPU equal 3 render_frame
    calls given each frame's camera dict, bit for bit: the image and every
    FrameState field (torch.equal)."""
    runs = _port_runs()
    img, st = runs[name]
    img_d, st_d = runs["dicts"]
    assert torch.equal(img, img_d)
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(st_d, k)), k
    assert int(st.frame_index) == 3


def test_camera_path_leaves_must_lead_with_the_path_length():
    """A non-scalar leaf that does not lead with the path length raises
    ValueError (frame.py:300-307) in render_frame and render_flight; on a
    2-camera path an unstacked (3,) vector is such a leaf. Scalar leaves
    pass."""
    *_, t_scene, t_luts, t_state = _setup()
    per_frame, _ = _port_cams()
    path = {k: torch.stack([per_frame[0][k], per_frame[1][k]])
            for k in per_frame[0]}
    bad = dict(path, up=per_frame[0]["up"])
    ts = settings(tcfg)
    with pytest.raises(ValueError, match="'up'"):
        tframe.render_frame(t_state, t_scene, bad, t_luts, 0.016, ts,
                            device="cpu")
    with pytest.raises(ValueError, match="path length 2"):
        tframe.render_flight(t_state, t_scene, bad, t_luts, 0.016, ts, 2,
                             device="cpu")
    cam = tframe.camera_at_frame(dict(path, scale=torch.tensor(2.0)),
                                 torch.tensor(3, dtype=torch.int32))
    assert torch.equal(cam["position"], path["position"][1])
    assert float(cam["scale"]) == 2.0


def test_flight_of_one_frame():
    """render_flight with n_frames 1 is one render_frame (frame_index 1);
    n_frames 0 raises."""
    *_, t_scene, t_luts, t_state = _setup()
    per_frame, path = _port_cams()
    ts = settings(tcfg)
    img, st = tframe.render_flight(t_state, t_scene, path, t_luts, 0.016,
                                   ts, 1, device="cpu")
    img_1, st_1 = tframe.render_frame(t_state, t_scene, per_frame[0], t_luts,
                                      0.016, ts, device="cpu")
    assert torch.equal(img, img_1)
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(st_1, k)), k
    assert int(st.frame_index) == 1 and int(t_state.frame_index) == 0
    with pytest.raises(ValueError):
        tframe.render_flight(t_state, t_scene, path, t_luts, 0.016, ts, 0,
                             device="cpu")
