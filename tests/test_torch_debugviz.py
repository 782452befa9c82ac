"""The port's debug views (plainrenderer_tpu_torch/ops/debugviz.py) against
the JAX package's (plainrenderer_tpu/ops/debugviz.py), called eagerly on
the courtyard demo's composited scene SDF (its 3 DDS volumes, as the JAX
App composites them) and on small images: trace_primary, sdf_debug_image
modes 1-4 at 256x128, cascade_debug_tint and aabb_line_overlay.

Tolerances: the trace's t, hit mask, step counts and hit voxels equal,
its normals within 2.4e-7 (rsqrt rounds differently); the images within
1e-6 (the normals, and the sky composite's sampling, a few ulps); the
tint and the wireframes exact."""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets.plain_format import load_binary_scene
from plainrenderer_tpu.ops import debugviz as jdv
from plainrenderer_tpu.ops import sky as jsky
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.runtime import app as japp
from plainrenderer_tpu.runtime.shell import CameraController, InputState
from plainrenderer_tpu_torch import interop
from plainrenderer_tpu_torch.ops import debugviz as tdv
from plainrenderer_tpu_torch.ops import sdfgi as tsdfgi

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COURTYARD = REPO / "assets" / "demo" / "courtyard.plain"
W, H = 256, 128


def _arrays(d):
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
def courtyard():
    """The JAX courtyard scene dict with its composited SDF
    (app.py:75-112), the port's copy by interop, and the camera of
    tests/test_demo_asset.py (outside the -x face, yaw 0)."""
    data = load_binary_scene(str(COURTYARD))
    rs = jsb.build_render_scene(data)
    gsdf = japp.App._load_or_bake_sdf(None, rs, data, None)
    j_scene = jframe.attach_global_sdf(jframe.scene_to_device(rs), gsdf)
    t_scene = interop.scene_from_arrays(_arrays(j_scene), device="cpu")
    lo, hi = rs.object_bb_min.min(0), rs.object_bb_max.max(0)
    ctl = CameraController(position=[lo[0] - 0.6 * (hi[0] - lo[0]),
                                     (lo[1] + hi[1]) / 2,
                                     (lo[2] + hi[2]) / 2], yaw=0.0)
    ext = ctl.update(InputState(), 0.0)
    cam = {k: np.asarray(getattr(ext, k), np.float32)
           for k in ("position", "forward", "right", "up")}
    return j_scene, t_scene, cam


def _t(a):
    return torch.as_tensor(np.array(a))


def test_dense_volume_unpack_matches_jax():
    j_scene, t_scene, _ = courtyard()
    dims = t_scene["sdf_grid"]
    assert dims == tuple(np.shape(j_scene["sdf_shape"])[:3])
    np.testing.assert_array_equal(
        tsdfgi.unpack_sdf_volume(t_scene["sdf_volume"], dims).numpy(),
        np.asarray(jdv.unpack_sdf_volume(j_scene["sdf_volume"], dims)))
    np.testing.assert_array_equal(
        tsdfgi.unpack_albedo_volume(t_scene["sdf_albedo"], dims).numpy(),
        np.asarray(jdv.unpack_albedo_volume(j_scene["sdf_albedo"], dims)))


def _view_dirs(cam, w, h):
    return np.asarray(jsky.view_directions(
        w, h, jnp.asarray(cam["forward"]), jnp.asarray(cam["up"]),
        jnp.asarray(cam["right"]), np.tan(np.radians(35.0) * 0.5), w / h))


def test_trace_primary_matches_jax():
    j_scene, t_scene, cam = courtyard()
    dims = t_scene["sdf_grid"]
    vol = np.asarray(jdv.unpack_sdf_volume(j_scene["sdf_volume"], dims))
    dirs = _view_dirs(cam, W // 2, H // 2)
    voxel = float(j_scene["sdf_voxel_size"])
    origin = np.asarray(j_scene["sdf_origin"])
    want = jdv.trace_primary(jnp.asarray(vol), jnp.asarray(cam["position"]),
                             jnp.asarray(dirs), jnp.asarray(origin), voxel)
    got = tdv.trace_primary(_t(vol), _t(cam["position"]), _t(dirs),
                            _t(origin), voxel)
    assert 0.05 < np.asarray(want["hit"]).mean() < 0.95  # geometry, sky
    for k in ("t", "hit", "steps", "hit_voxel"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["normal"].numpy(),
                               np.asarray(want["normal"]), rtol=0,
                               atol=2.4e-7)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_sdf_debug_image_matches_jax(mode):
    j_scene, t_scene, cam = courtyard()
    settings = jcfg.RenderSettings(width=W, height=H)
    luts = jframe.bake_static_luts(settings)
    sun_dir = np.asarray([0.3, -0.8, 0.2], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sun_color = np.asarray([1.0, 0.9, 0.8], np.float32)
    strength = np.float32(2.5)
    sky_lut = np.asarray(jsky.bake_sky_lut(
        jnp.asarray(sun_dir), jnp.asarray(strength), luts["multiscatter"],
        settings=settings.atmosphere))
    tan_half = float(np.tan(np.radians(35.0) * 0.5))
    want = np.asarray(jdv.sdf_debug_image(
        mode, j_scene, {k: jnp.asarray(v) for k, v in cam.items()},
        jnp.asarray(sky_lut), luts["transmission"], jnp.asarray(sun_dir),
        jnp.asarray(sun_color), jnp.asarray(strength), W, H, tan_half,
        W / H))
    got = tdv.sdf_debug_image(
        mode, t_scene, {k: _t(v) for k, v in cam.items()}, _t(sky_lut),
        _t(luts["transmission"]), _t(sun_dir), _t(sun_color), _t(strength),
        W, H, tan_half, W / H).numpy()
    assert got.shape == want.shape == (3, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want.std() > 0.01  # the view is not flat


def test_cascade_debug_tint_matches_jax():
    rng = np.random.default_rng(3)
    hdr = rng.uniform(0, 4, (3, 32, 128)).astype(np.float32)
    idx = rng.integers(-1, 4, (32, 128)).astype(np.int32)
    for n in (1, 3, 4):
        want = np.asarray(jdv.cascade_debug_tint(jnp.asarray(hdr),
                                                 jnp.asarray(idx), n))
        got = tdv.cascade_debug_tint(_t(hdr), _t(idx), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_aabb_line_overlay_matches_jax():
    """The courtyard's object boxes under the camera's view-projection,
    and a near box with points behind the camera, over a random image."""
    j_scene, _, cam = courtyard()
    settings = jcfg.RenderSettings(width=W, height=H)
    jcam_d = {k: jnp.asarray(v) for k, v in cam.items()}
    vp = np.asarray(jframe._projection(settings) @ jframe._view_matrix(
        jcam_d))
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    bb_min = np.asarray(j_scene["object_bb_min"])
    bb_max = np.asarray(j_scene["object_bb_max"])
    near = cam["position"][None] + np.asarray([[-1.0, -0.5, -0.5]])
    bb_min = np.concatenate([bb_min, near]).astype(np.float32)
    bb_max = np.concatenate([bb_max, near + 2.0]).astype(np.float32)
    want = np.asarray(jdv.aabb_line_overlay(
        jnp.asarray(image), jnp.asarray(bb_min), jnp.asarray(bb_max),
        jnp.asarray(vp), W, H))
    got = tdv.aabb_line_overlay(_t(image), _t(bb_min), _t(bb_max), _t(vp),
                                W, H).numpy()
    drawn = (want != image).any(axis=-1)
    assert drawn.sum() > 200
    np.testing.assert_array_equal(got, want)
