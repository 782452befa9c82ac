"""Kernel D's trilinear and anisotropic branches (shading.texture_filter 1
and 2) against the JAX package: the port's plain version on the CPU, the
JAX kernel in interpret mode (as tests/test_texture.py runs it), on the
same inputs made with numpy. The rule is kernel D's: the ok channel equal
on every pixel, the 8 value channels within 1e-5 where ok."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_texture import _sample_inputs

from plainrenderer_tpu.assets import textures as jtex
from plainrenderer_tpu.ops import texture as jtexture
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.assets.textures import MAX_MIPS
from plainrenderer_tpu_torch.ops import raster as tr
from plainrenderer_tpu_torch.ops import texture as ttexture
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb
from plainrenderer_tpu_torch.render.state import initial_state
from plainrenderer_tpu_torch.scene import camera as tcam

torch.set_num_threads(1)

# two_mat stays on, as in the frame: trilinear ignores it on both sides;
# the aniso-only case runs without it (the frame never runs aniso without
# trilinear, and the pair doubles the JAX kernel's interpret-mode compile)
FILTERS = {"trilinear": dict(trilinear=True, two_mat=True),
           "aniso": dict(aniso=True, two_mat=False),
           "trilinear_aniso": dict(trilinear=True, aniso=True, two_mat=True)}
# every input is padded to one shape (H, W, bricks, level rows, materials),
# so the jitted JAX kernel compiles once per filter in interpret mode (~120 s
# under trilinear + aniso); run eagerly it lowers again on every call
H, W, N_BRICKS, N_INFO, N_MAT = 48, 256, 1616, 192, 16


def _one_texture(img):
    pool = jtex.build_texture_pool([jtex.MaterialTextures(albedo=img)])
    return pool, np.zeros((1,), np.int32)


def _mips_inputs():
    """tests/test_texture.py:123: a 1-texel checker whose mips average to
    grey, footprint sqrt(2) texels (lod 0.5) on one 16x128 tile."""
    h, w = 16, 128
    img = np.zeros((64, 256, 3), np.float32)
    img[::2, ::2] = 1.0
    img[1::2, 1::2] = 1.0
    pool, mat_tex = _one_texture(img)
    u = np.broadcast_to((np.arange(w) + 0.5) / w * 0.25, (h, w))
    v = np.broadcast_to(((np.arange(h) + 0.5) / h * 0.25)[:, None], (h, w))
    uv = np.stack([u, v]).astype(np.float32)
    duv = np.full((4, h, w), 2.0 ** 0.5 / 256.0, np.float32)
    return (pool, mat_tex, uv, duv, np.zeros((h, w), np.float32),
            np.ones((h, w), bool), 0.0)


def _stripes_inputs():
    """tests/test_texture.py:162: 4-texel stripes under a footprint of 1
    texel in x and 8 in y (a glancing view)."""
    h, w = 16, 128
    img = np.zeros((64, 256, 3), np.float32)
    img[:, (np.arange(256) // 4) % 2 == 0] = 1.0
    pool, mat_tex = _one_texture(img)
    u = np.broadcast_to((np.arange(w) + 0.5) / w * 0.5, (h, w))
    v = np.broadcast_to(((np.arange(h) + 0.5) / h * 0.5)[:, None], (h, w))
    uv = np.stack([u, v]).astype(np.float32)
    duv = np.stack([np.full((h, w), 1.0 / 256.0), np.zeros((h, w)),
                    np.zeros((h, w)), np.full((h, w), 8.0 / 64.0)])
    return (pool, mat_tex, uv, duv.astype(np.float32),
            np.zeros((h, w), np.float32), np.ones((h, w), bool), 0.0)


def _mixed_inputs():
    """test_torch_texture's 6 tiles: one, two and three materials per tile,
    an untextured material, a uv wrap seam, a partly empty tile."""
    pool, mat_tex, uv, duv, mat, valid = _sample_inputs()
    return pool, mat_tex, uv, duv, mat, valid, 0.0


@functools.lru_cache(maxsize=1)
def _atrium_inputs():
    """The G-buffer of the small textured atrium at 256x128 (the port's
    raster on the CPU) and its texture pool. Mip bias 0 on every input, a
    static argument of the JAX kernel (chip_smoke.py holds kernel D to its
    plain version under TAA's bias -1)."""
    rs = tsb.build_render_scene(tproc.build_atrium_scene(
        tproc.AtriumConfig(columns_per_row=2, floor_subdiv=2, box_count=3,
                           box_subdiv=1, column_segments=8), textured=True))
    scene = tframe.scene_to_device(rs, device="cpu")
    ext = tcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)
    cam = tframe.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                               device="cpu")
    settings = tcfg.RenderSettings(width=256, height=128)
    main = tframe.raster_main_view(
        tframe.main_view_setup(scene, cam, settings))
    gbuf = main.gbuf.numpy()

    class Pool:
        info, word0, word1, n_mips = (rs.tex_info, rs.tex_word0,
                                      rs.tex_word1, MAX_MIPS)
    rows = slice(80, 128)  # the floor and a box, every pixel covered
    return (Pool, rs.mat_tex, gbuf[tr._CH_U:tr._CH_U + 2, rows],
            gbuf[tr._CH_DUDX:tr._CH_DUDX + 4, rows],
            np.floor(gbuf[tr._CH_MAT, rows] * 0.5),
            main.vis.numpy()[rows] >= 0, 0.0)


def _padded(inputs):
    """The inputs at the common shape: pixels padded as invalid, the pool
    with zero bricks, level rows of texture 0 (never referenced) and
    untextured materials. None of them changes a sample."""
    pool, mat_tex, uv, duv, mat, valid, bias = inputs()
    h, w = valid.shape

    def px(a, fill=0):
        out = np.full(a.shape[:-2] + (H, W), fill, a.dtype)
        out[..., :h, :w] = a
        return out

    def grow(a, n, fill):
        return np.concatenate([a, np.broadcast_to(
            fill, (n - a.shape[0],) + a.shape[1:])]).astype(a.dtype)

    info = np.asarray(pool.info)
    return (px(uv), px(duv), px(mat), px(valid, False),
            grow(np.asarray(mat_tex), N_MAT, -1),
            grow(info, N_INFO, info[:1]),
            grow(np.asarray(pool.word0), N_BRICKS, 0),
            grow(np.asarray(pool.word1), N_BRICKS, 0)), pool.n_mips, bias


INPUTS = {"mips": _mips_inputs, "stripes": _stripes_inputs,
          "mixed": _mixed_inputs, "atrium": _atrium_inputs}


@functools.lru_cache(maxsize=None)
def _jax_sampler(filt, n_mips, bias):
    """sample_materials in interpret mode under one jit per filter."""
    return jax.jit(functools.partial(
        jtexture.sample_materials, n_mips=n_mips, mip_bias=bias,
        interpret=True, **FILTERS[filt]))


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_filtered_sample_plain_matches_jax(inputs, filt):
    """ok equal on every pixel, values within 1e-5 where ok, zeros where
    not."""
    arrays, n_mips, bias = _padded(INPUTS[inputs])
    kw = FILTERS[filt]
    j = np.asarray(_jax_sampler(filt, n_mips, bias)(
        *(jnp.asarray(a) for a in arrays)))
    t = ttexture.sample_materials(
        *(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays),
        n_mips=n_mips, mip_bias=bias, **kw).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t[8], j[8])
    ok = j[8] > 0.5
    assert ok.sum() > 400, ok.sum()
    np.testing.assert_allclose(t[:8][:, ok], j[:8][:, ok], rtol=0, atol=1e-5)
    assert (t[:8][:, ~ok] == 0).all()


def test_filters_change_the_sample():
    """The branches do work: on the lod-0.5 checker trilinear blends in the
    grey mip (its variance falls), and under the glancing footprint aniso
    keeps the stripes that the isotropic mip greys out
    (tests/test_texture.py:123-199, on the port)."""
    def run(inputs, **kw):
        pool, mat_tex, uv, duv, mat, valid, bias = inputs()
        out = ttexture.sample_materials(
            *(torch.as_tensor(np.ascontiguousarray(a))
              for a in (uv, duv, mat, valid, mat_tex, pool.info, pool.word0,
                        pool.word1)), n_mips=pool.n_mips, **kw).numpy()
        return out[0][out[8] > 0.5]

    assert run(_mips_inputs, trilinear=True).std() \
        < 0.75 * run(_mips_inputs).std()
    assert run(_stripes_inputs, aniso=True).std() \
        > 1.5 * run(_stripes_inputs).std()


def test_frame_renders_each_texture_filter():
    """render_frame on the textured small atrium at 256x128 (sun shadows
    and GI off) with texture_filter 0, 1 and 2: each renders a plausible
    image, and the filters change the textured pixels."""
    rs = tsb.build_render_scene(tproc.build_atrium_scene(
        tproc.AtriumConfig(columns_per_row=2, floor_subdiv=2, box_count=3,
                           box_subdiv=1, column_segments=8), textured=True))
    scene = tframe.scene_to_device(rs, device="cpu")
    off = dict(enabled=False)
    ext = tcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)
    cam = tframe.camera_arrays(ext.position, ext.forward, ext.right, ext.up,
                               device="cpu")
    images = []
    for filt in (0, 1, 2):
        settings = tcfg.RenderSettings(
            width=256, height=128, exposure_adaption_speed=1000.0,
            shadows=tcfg.ShadowSettings(cascade_count=0),
            sdf_trace=tcfg.SDFTraceSettings(**off),
            taa=tcfg.TAASettings(**off), bloom=tcfg.BloomSettings(**off),
            shading=tcfg.ShadingConfig(texture_filter=filt))
        luts = tframe.bake_static_luts(settings, device="cpu")
        state = initial_state(256, 128, device="cpu")
        for _ in range(2):
            img, state = tframe.render_frame(state, scene, cam, luts, 0.016,
                                             settings, device="cpu")
        img = img.numpy().astype(np.int32)
        assert 2 < img.mean() < 253 and img.std() > 5
        assert (state.debug_counters.numpy() == 0).all()
        images.append(img)
    for img in images[1:]:
        assert (np.abs(img - images[0]).max(-1) > 2).mean() > 0.01
