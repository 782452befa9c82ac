"""The port's texture pool, textured atrium and texture sampling against
the JAX package (plain PyTorch version on the CPU; the JAX kernel in
interpret mode, as tests/test_texture.py runs it)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.assets import textures as jtex
from plainrenderer_tpu.ops import texture as jtexture
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.assets import textures as ttex
from plainrenderer_tpu_torch.ops import texture as ttexture
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb

torch.set_num_threads(1)

SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)


def _materials(mod, proc):
    """Power-of-two levels of several sizes, one square and two not, an
    alpha-tested lattice, a normal-only set and an empty set (defaults)."""
    rng = np.random.default_rng(3)
    mats = [proc.procedural_texture([0.6, 0.5, 0.4], kind, size=size,
                                    seed=i)
            for i, (kind, size) in enumerate(
                [("checker", 256), ("brick", 64), ("marble", 32),
                 ("lattice", 128)])]
    mats.append(mod.MaterialTextures(
        albedo=rng.random((512, 128, 3)).astype(np.float32),
        normal=rng.random((256, 64, 2)).astype(np.float32)))
    mats.append(mod.MaterialTextures())
    return mats


def _assert_same_fields(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif y is None or isinstance(y, (int, float, str)):
            assert x == y, f.name


def test_texture_pool_matches_jax():
    """build_texture_pool is bit-identical, defaults and alpha slots too."""
    defaults = [None] * 5 + [{"albedo": [0.1, 0.2, 0.3], "roughness": 0.4,
                              "metal": 1.0}]
    j = jtex.build_texture_pool(_materials(jtex, jproc), defaults)
    t = ttex.build_texture_pool(_materials(ttex, tproc), defaults)
    _assert_same_fields(j, t)
    assert t.alpha_slot.tolist() == [0, 0, 0, 1, 0, 0]
    np.testing.assert_array_equal(
        jtex.build_alpha_mask(np.linspace(0, 1, 48 * 80).reshape(48, 80)),
        ttex.build_alpha_mask(np.linspace(0, 1, 48 * 80).reshape(48, 80)))


def test_textured_atrium_matches_jax():
    """The textured atrium (banners alpha-tested) registers bit-identical
    arrays, texture pool and alpha tables included, and scene_to_device
    carries the same keys and numbers as the JAX dict."""
    cfg = dict(SMALL_ATRIUM, banner_count=2)
    j_scene = jproc.build_atrium_scene(jproc.AtriumConfig(**cfg))
    t_scene = tproc.build_atrium_scene(tproc.AtriumConfig(**cfg))
    for jm, tm in zip(j_scene.meshes, t_scene.meshes):
        _assert_same_fields(jm.texture_images, tm.texture_images)
    j_rs = jsb.build_render_scene(j_scene)
    t_rs = tsb.build_render_scene(t_scene)
    _assert_same_fields(j_rs, t_rs)
    assert t_rs.alpha_masks is not None and t_rs.tri_alpha_slot.max() == 2
    j_dev = jframe.scene_to_device(j_rs)
    t_dev = tframe.scene_to_device(t_rs, device="cpu")
    assert sorted(j_dev) == sorted(t_dev)
    for k in t_dev:
        np.testing.assert_array_equal(np.asarray(j_dev[k]), t_dev[k].numpy(),
                                      err_msg=k)


def test_path_loaded_textures_wait_for_the_image_readers():
    scene = tproc.build_atrium_scene(tproc.AtriumConfig(**SMALL_ATRIUM),
                                     textured=False)
    scene.meshes[0].texture_paths.albedo = "bricks.png"
    with pytest.raises(NotImplementedError):
        tsb.build_render_scene(scene)


def test_thread_layout_and_tile_sum_order():
    """to_thread_layout inverts; tile_sum adds each thread's 8 rows in
    turn, then halves over the 256 threads."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 32, 256)).astype(np.float32))
    t = ttexture.to_thread_layout(x)
    assert t.shape == (2, 4, 256, 8)
    torch.testing.assert_close(ttexture.from_thread_layout(t, 32, 256), x,
                               rtol=0, atol=0)
    # tile (0, 1), thread 130 = row half 1, column 2: rows 8-15 of col 130
    torch.testing.assert_close(t[0, 1, 130], x[0, 8:16, 128 + 2],
                               rtol=0, atol=0)
    v = t[0].numpy()
    acc = np.zeros((4, 256), np.float32)
    for r in range(8):
        acc = acc + v[..., r]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    np.testing.assert_array_equal(ttexture.tile_sum(t[0]).numpy(),
                                  acc[:, 0])


def _sample_inputs():
    """6 tiles (48x256) over a pool of 4 textures: a single-material tile,
    a two-material tile, a tile with an untextured material, a tile across
    a uv wrap seam, a three-material tile, and a partly empty tile; the
    levels include ones that fit the 24x256 window and ones that do not."""
    rng = np.random.default_rng(5)
    mats = [jproc.procedural_texture([0.7, 0.4, 0.3], kind, size=size,
                                     seed=i)
            for i, (kind, size) in enumerate(
                [("checker", 512), ("brick", 64), ("marble", 256),
                 ("checker", 16)])]
    pool = jtex.build_texture_pool(mats)
    mat_tex = np.asarray([0, 1, -1, 2, 3], np.int32)
    h, w = 48, 256
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    scale = np.where(xs < 128, 1.0 / 700.0, 1.0 / 90.0).astype(np.float32)
    u = 0.13 + xs * scale + ys * 0.0004
    v = 0.41 + ys * scale * 0.8 - xs * 0.0002
    mat = np.zeros((h, w), np.float32)
    mat[:16, 128:] = np.where(xs[:16, 128:] < 200, 0, 1)  # two materials
    mat[16:32, :128] = np.where(ys[16:32, :128] < 24, 2, 0)  # untextured
    seam = (ys >= 16) & (ys < 32) & (xs >= 128)
    u[seam] = 0.97 + (xs[seam] - 128) * 0.0009  # crosses u = 1
    mat[seam] = 3
    mat[32:, :128] = (xs[32:, :128] // 43)  # materials 0, 1, 2
    mat[32:, 128:] = 4
    valid = np.ones((h, w), bool)
    valid[32:, 128:] = rng.random((16, 128)) > 0.6
    duv = np.stack([scale, np.full_like(scale, 0.0003),
                    np.full_like(scale, -0.0002), scale * 0.8])
    uv = np.stack([u, v]).astype(np.float32)
    return pool, mat_tex, uv, duv.astype(np.float32), mat, valid


@pytest.mark.parametrize("two_mat", [True, False])
def test_sample_plain_matches_jax(two_mat):
    """ok equal on every pixel; the 8 value channels within 1e-5 where
    both sides are ok."""
    pool, mat_tex, uv, duv, mat, valid = _sample_inputs()
    j = np.asarray(jtexture.sample_materials(
        jnp.asarray(uv), jnp.asarray(duv), jnp.asarray(mat),
        jnp.asarray(valid), jnp.asarray(mat_tex), jnp.asarray(pool.info),
        jnp.asarray(pool.word0), jnp.asarray(pool.word1),
        n_mips=pool.n_mips, two_mat=two_mat, interpret=True))
    t = ttexture.sample_materials(
        *(torch.as_tensor(a) for a in (uv, duv, mat, valid, mat_tex,
                                       pool.info, pool.word0, pool.word1)),
        n_mips=pool.n_mips, two_mat=two_mat).numpy()
    assert t.shape == (9, 48, 256)
    np.testing.assert_array_equal(t[8], j[8])
    ok = j[8] > 0.5
    assert 0.3 < ok.mean() < 0.95  # both outcomes are exercised
    np.testing.assert_allclose(t[:8][:, ok], j[:8][:, ok], rtol=0, atol=1e-5)
    assert (t[:8][:, ~ok] == 0).all()
    # the two-material tile's minority material samples only through the
    # second window
    assert ok[:16, 128:200].any() and ok[:16, 200:].any() == two_mat
    # untextured material and the third material of a tile fall back
    assert not ok[16:24, :128].any()
