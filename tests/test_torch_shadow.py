"""The port's sun-shadow path against the JAX package: depth bounds,
cascade fit, the cascade atlas (setup, multi-view pair lists, depth-only
raster), u16 packing and the PCF resolve. The JAX side runs its Pallas
kernels in interpret mode, the port its plain PyTorch versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.ops import hiz as jhiz
from plainrenderer_tpu.ops import raster as jr
from plainrenderer_tpu.ops import shadow as jshadow
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu.scene import frustum as jfrustum
from plainrenderer_tpu_torch.ops import hiz as thiz
from plainrenderer_tpu_torch.ops import raster as tr
from plainrenderer_tpu_torch.ops import shadow as tshadow
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.scene import frustum as tfrustum

torch.set_num_threads(1)

SRES = 256  # map size: 2 x 2 bins of 128 px per cascade
N_CAS = 3
SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)
CAM = dict(position=[-3.0, -1.8, 0.3], forward=[0.94, 0.14, 0.31],
           up=[0.13, -0.99, 0.04], right=[-0.31, 0.0, 0.95])


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def _fit_args(lib, to):
    """compute_cascade_info's arguments for one camera, as `lib` arrays."""
    sun = _unit([0.3, -0.8, 0.45])
    return (to(np.float32(0.004)), to(np.float32(0.3)),
            to(np.asarray(CAM["position"], np.float32)),
            to(_unit(CAM["forward"])), to(_unit(CAM["up"])),
            to(_unit(CAM["right"])), 0.3153, 16 / 9, 0.1, 300.0, to(sun),
            N_CAS, to(np.float32(3.0)), to(np.float32(30.0)))


def _jax_fit():
    return jshadow.compute_cascade_info(*_fit_args(jnp, jnp.asarray))


def test_depth_min_max_matches_jax():
    rng = np.random.default_rng(21)
    depth = rng.uniform(0.0, 1.0, (64, 128)).astype(np.float32)
    depth[rng.random((64, 128)) < 0.3] = 0.0  # sky
    j = jhiz.depth_min_max(jnp.asarray(depth))
    t = thiz.depth_min_max(torch.as_tensor(depth))
    assert [float(x) for x in j] == [float(x) for x in t]
    sky = thiz.depth_min_max(torch.zeros((16, 128)))
    assert [float(x) for x in sky] == [1.0, 0.0]


def test_compute_cascade_info_matches_jax():
    """Matrices, splits and light-space scales within rtol 1e-5 (atol 1e-6
    for the matrices' near-zero entries); the padding cascade is the
    identity with unit scales."""
    j = [np.asarray(a) for a in _jax_fit()]
    t = [a.numpy() for a in tshadow.compute_cascade_info(
        *_fit_args(torch, torch.as_tensor))]
    for name, a, b in zip(("matrices", "splits", "scales"), j, t):
        assert a.shape == b.shape and b.dtype == np.float32, name
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(t[0][N_CAS], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(t[2][N_CAS], [1.0, 1.0])


def test_cull_without_z_matches_jax():
    rng = np.random.default_rng(22)
    lo = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 4, (200, 3)).astype(np.float32)
    mats = np.asarray(_jax_fit()[0])
    for c in range(N_CAS):
        for cull_z in (True, False):
            j = np.asarray(jfrustum.visible_objects_clipspace(
                jnp.asarray(mats[c]), jnp.asarray(lo), jnp.asarray(hi),
                cull_z=cull_z))
            t = tfrustum.visible_objects_clipspace(
                torch.as_tensor(mats[c]), torch.as_tensor(lo),
                torch.as_tensor(hi), cull_z=cull_z).numpy()
            np.testing.assert_array_equal(t, j)
    assert not j.all() and j.any()


@pytest.fixture(scope="module")
def atlas_case():
    """The small atrium's cascade atlas set up by both packages from the
    same cascade fit."""
    rs = jsb.build_render_scene(jproc.build_atrium_scene(
        jproc.AtriumConfig(**SMALL_ATRIUM), textured=False))
    j_scene = jframe.scene_to_device(rs)
    t_scene = tframe.scene_to_device(rs, device="cpu")
    mats = _jax_fit()[0]
    t_count = rs.corners.shape[0]
    j_setup = jframe.shadow_atlas_setup(
        j_scene, j_scene["corners"], j_scene["corner_normals"],
        j_scene["corner_tangents"], j_scene["corner_bitangents"],
        j_scene["object_bb_min"], j_scene["object_bb_max"], mats, N_CAS,
        SRES, None, t_count)
    t_setup = tframe.shadow_atlas_setup(
        t_scene, torch.as_tensor(np.asarray(mats)), N_CAS, SRES)
    return j_setup, t_setup, t_count


def _atlas_grid():
    sub = tframe.shadow_bin_sub(SRES)
    assert sub == jframe.shadow_bin_sub(SRES) == 8
    return sub, N_CAS * SRES // (16 * sub), SRES // 128


def test_shadow_atlas_setup_matches_jax(atlas_case):
    """The batched atlas setup: edge planes within rtol 1e-5 of the vmapped
    JAX stage (atol 1e-3 of each triangle's plane scale), valid flags and
    bin / fine-row bboxes equal for all but 0.1% of triangles (bboxes can
    move a bin where a vertex sits on a bin edge)."""
    j, t, t_count = atlas_case
    assert t.edges.shape == (3, 4, N_CAS * t_count)
    assert t.attrs.shape[1] == 0
    valid = np.asarray(j.valid)
    assert 0.05 < valid.mean() < 0.9
    assert (t.valid.numpy() == valid).mean() > 0.999
    same = (np.asarray(j.tile_bbox) == t.tile_bbox.numpy()).all(1)
    same &= (np.asarray(j.fine_y) == t.fine_y.numpy()).all(1)
    assert same.mean() > 0.999
    je, te = np.asarray(j.edges)[..., valid], t.edges.numpy()[..., valid]
    scale = np.abs(je).max(axis=0, keepdims=True) + 1e-30
    np.testing.assert_allclose(te / scale, je / scale, rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def atlas_pairs(atlas_case):
    """Pair lists of the JAX atlas setup on both sides (the same setup
    numbers, carried over), with the frame's budget formula."""
    j_setup, _, t_count = atlas_case
    sub, nb, ntx = _atlas_grid()
    budget = (N_CAS * t_count) // 6 + 4 * nb * sub * ntx
    jp = jr.build_pairs(j_setup, nb, ntx, n_views=N_CAS, tile_cap=1 << 15,
                        bin_rows=sub, order_rows=True, pair_budget=budget,
                        interpret=True)
    t_setup = tr.TriangleSetup(**{
        k: torch.as_tensor(np.array(getattr(j_setup, k)))
        for k in ("edges", "attrs", "tile_bbox", "valid", "fine_y")})
    tp = tr.build_pairs(t_setup, nb, ntx, pair_budget=budget, bin_rows=sub,
                        order_rows=True, n_views=N_CAS, tile_cap=1 << 15)
    return j_setup, t_setup, jp, tp


def test_atlas_build_pairs_matches_jax_exactly(atlas_pairs):
    """build_pairs(n_views=3): pair stream, segment starts, counts and
    overflow equal the JAX package's (Pallas key expansion, interpret)."""
    _, _, jp, tp = atlas_pairs
    for k in ("pair_tri", "tile_start", "tile_count", "overflow"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert int(tp.overflow) == 0
    counts = tp.tile_count.numpy()
    assert counts.sum() > 100 and (counts > 0).mean() > 0.5
    # the view-local keys put pairs of every view into their own bins
    tri = tp.pair_tri.numpy()
    starts = tp.tile_start.numpy()
    for b in np.flatnonzero(counts):
        views = tri[starts[b]:starts[b] + counts[b]] // (tri.max() // N_CAS)
        assert (views == b // (SRES // 128 * SRES // 128)).all()


def test_rasterize_depth_matches_jax(atlas_pairs):
    """The depth-only atlas raster (128-px bins, row skip, depth clamp):
    the same pair edges give the same covered pixels, and depth within
    1e-6 (a few ulps; one u16 map step is 1.5e-5). Not bit for bit: XLA on
    the CPU fuses the JAX kernel's a*x + (b*y + c) into two FMAs, while the
    port rounds each product and sum, as kernel B does (an FMA-evaluating
    copy of the plain loop equals the JAX run on every pixel; with
    separate rounding 85% of the depths are bit-equal, the rest differ by
    at most 18 ulps where the plane's terms cancel)."""
    j_setup, t_setup, jp, tp = atlas_pairs
    sub, nb, ntx = _atlas_grid()
    je, _ = jr.gather_pair_setups(j_setup, jp, False, row_extents=True)
    j = np.asarray(jr.rasterize_depth(je, jp, nb, ntx, interpret=True,
                                      sub=sub, row_skip=True))
    te, ta = tr.gather_pair_setups(t_setup, tp, row_extents=True,
                                   with_attrs=False)
    assert ta is None
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    t = tr.rasterize_depth(te, tp, nb, ntx, sub=sub, row_skip=True).numpy()
    assert t.shape == (N_CAS * SRES, SRES)
    np.testing.assert_array_equal(t > 0, j > 0)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert (t.view(np.int32) == j.view(np.int32)).mean() > 0.8
    assert (t > 0).mean() > 0.3 and t.max() <= 1.0
    assert t[t > 0].min() >= 1.0 / 16384.0


def test_pack_shadow_maps_u16_matches_jax():
    rng = np.random.default_rng(23)
    maps = rng.uniform(-0.2, 1.2, (4, 64, 256)).astype(np.float32)
    maps[:, :, :8] = np.asarray([0.5 / 65535, 1.5 / 65535, 0.0, 1.0, 0.25,
                                 2.5 / 65535, 1e-9, 0.999999])
    np.testing.assert_array_equal(
        tshadow.pack_shadow_maps_u16(torch.as_tensor(maps)).numpy(),
        np.asarray(jshadow.pack_shadow_maps_u16(jnp.asarray(maps))))


def test_shadow_resolve_plain_matches_jax(atlas_pairs):
    """PCF resolve over the atrium's 3-cascade atlas (map 256) for
    receivers on the floor and a wall, with blue-noise-like random
    rotation: >= 99.9% of pixels equal, the rest within 1/taps (a tap can
    round to the other texel where cos / sin differ in the last bit)."""
    j_setup, _, jp, _ = atlas_pairs
    sub, nb, ntx = _atlas_grid()
    je, _ = jr.gather_pair_setups(j_setup, jp, False, row_extents=True)
    atlas = np.asarray(jr.rasterize_depth(je, jp, nb, ntx, interpret=True,
                                          sub=sub, row_skip=True))
    maps = np.concatenate([atlas.reshape(N_CAS, SRES, SRES),
                           np.zeros((1, SRES, SRES), np.float32)])
    mats, splits, scales = (np.asarray(a) for a in _jax_fit())
    rng = np.random.default_rng(24)
    h, w = 64, 256
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    pos = np.asarray(CAM["position"], np.float32)
    world = np.stack([pos[0] + 2.0 + 16.0 * xs, np.zeros_like(xs) - 0.001,
                      -5.5 + 11.0 * ys]).astype(np.float32)
    world[:, h // 2:, : w // 2] = np.stack([
        11.5 + 0 * xs, -6.5 * ys, -5.5 + 11.0 * xs])[:, h // 2:, : w // 2]
    fwd = _unit(CAM["forward"])
    lin = np.einsum("c,chw->hw", fwd, world - pos[:, None, None])
    lin = lin.astype(np.float32)
    lin[rng.random((h, w)) < 0.05] = 0.0  # sky
    noise = rng.random((h, w)).astype(np.float32)
    args = (world, lin, noise, maps, mats, scales, splits)
    j = np.asarray(jshadow.shadow_resolve(
        *(jnp.asarray(a) for a in args), cascade_count=N_CAS, taps=12,
        interpret=True))
    t = tshadow.shadow_resolve(*(torch.as_tensor(a) for a in args),
                               cascade_count=N_CAS, taps=12).numpy()
    assert t.shape == (h, w)
    assert (t[lin <= 0] == 1.0).all()
    diff = np.abs(t - j)
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert diff.max() <= 1.0 / 12 + 1e-6
    # both shadow and light are exercised, over more than one cascade
    assert 0.05 < (t < 0.5).mean() < 0.95
    assert len(np.unique(np.searchsorted(splits[:N_CAS - 1], lin[lin > 0],
                                         side="right"))) >= 2


def test_shadow_resolve_rejects_bad_inputs():
    z = torch.zeros
    with pytest.raises(ValueError):  # map rows not a multiple of 256
        tshadow.shadow_resolve(z(3, 16, 128), z(16, 128), z(16, 128),
                               z(4, 128, 128), z(4, 4, 4), z(4, 2), z(4), 3)
    with pytest.raises(ValueError):  # screen not a multiple of the tile
        tshadow.shadow_resolve(z(3, 8, 128), z(8, 128), z(8, 128),
                               z(4, 256, 256), z(4, 4, 4), z(4, 2), z(4), 3)


def test_settings_match_shadow_defaults():
    """The slice runs the default ShadowSettings: 3 cascades, 2048 maps,
    12 taps, 0.03 world-space radius."""
    j, t = jcfg.ShadowSettings(), tframe.RenderSettings().shadows
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.cascade_count, t.resolution, t.pcf_taps) == (3, 2048, 12)
    assert tshadow.MAX_CASCADES == jshadow.MAX_CASCADES
