"""The port's raster front end and G-buffer against the JAX package.

Inputs come from a numpy seed and go through both sides; the JAX side runs
its Pallas kernels in interpret mode, the port side its plain PyTorch
versions (the CUDA kernels run only on the card, see chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import raster as jr
from plainrenderer_tpu_torch.ops import raster as tr

torch.set_num_threads(1)

W, H = 256, 64  # 2 x 4 tiles of 128 x 16


def _ortho_vp():
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0] = 2.0
    vp[0, 3] = -1.0
    vp[1, 1] = 2.0
    vp[1, 3] = -1.0
    return vp


def _random_tris(rng, n):
    """n random counter-clockwise screen triangles in [0, 1]^2 ortho space
    at random depths (test_raster.py's unit_tri, randomised)."""
    cx, cy = rng.uniform(0.1, 0.9, (2, n))
    size = rng.uniform(0.02, 0.25, n)
    z = rng.uniform(0.1, 0.95, n)
    tris = np.stack([
        np.stack([cx - size, cy - size, z], -1),
        np.stack([cx + size, cy - size * rng.uniform(0.5, 1.5, n), z], -1),
        np.stack([cx + size * rng.uniform(-0.8, 0.8, n), cy + size, z], -1),
    ], axis=1)
    return tris.astype(np.float32)


def _setup_inputs(rng, tris):
    n = tris.shape[0]
    uvs = rng.random((n, 3, 2)).astype(np.float32)
    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    normals = unit(rng.normal(size=(n, 3, 3))).astype(np.float32)
    tangents = unit(rng.normal(size=(n, 3, 3))).astype(np.float32)
    bitangents = unit(rng.normal(size=(n, 3, 3))).astype(np.float32)
    material = rng.integers(0, 40, n).astype(np.float32)
    visible = np.ones(n, bool)
    return (tris, uvs, normals, tangents, bitangents, material, visible)


def _both_setups(inputs, vp, width, height, bin_rows, near_w=0.0,
                 cull="none"):
    j = jr.geometry_setup(*[jnp.asarray(a) for a in inputs], jnp.asarray(vp),
                          jnp.asarray(vp), width, height, cull=cull,
                          near_w=near_w, bin_rows=bin_rows)
    t = tr.geometry_setup(*[torch.as_tensor(a) for a in inputs],
                          torch.as_tensor(vp), width, height, cull=cull,
                          near_w=near_w, bin_rows=bin_rows)
    return j, t


def _to_port(setup) -> tr.TriangleSetup:
    """The JAX TriangleSetup's arrays as the port's (same numbers)."""
    return tr.TriangleSetup(**{
        k: torch.as_tensor(np.array(getattr(setup, k)))
        for k in ("edges", "attrs", "tile_bbox", "valid", "fine_y")})


def _perspective_vp():
    """A camera looking down -z at the random triangles' [0, 1]^2 square
    from z = 2.5, so triangles near the eye cross the near plane."""
    from plainrenderer_tpu_torch.render.frame import _projection
    from plainrenderer_tpu_torch.config import RenderSettings

    proj = _projection(RenderSettings(width=W, height=H))
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [-0.5, -0.5, -2.5]
    return (proj @ view).astype(np.float32)


@pytest.mark.parametrize("projection", ["ortho", "perspective"])
def test_geometry_setup_matches_jax(projection):
    """Same corners -> same planes, bboxes and validity. rtol 1e-5: both
    sides do the same float32 operations in the same order; the slack
    covers the two libraries' reciprocal and fused-kernel rounding."""
    rng = np.random.default_rng(1)
    tris = _random_tris(rng, 200)
    if projection == "perspective":
        tris[:, :, 2] = rng.uniform(-1.0, 2.45, (200, 1))
        vp, near_w = _perspective_vp(), 0.1
    else:
        vp, near_w = _ortho_vp(), 0.0
    j, t = _both_setups(_setup_inputs(rng, tris), vp, W, H, bin_rows=2,
                        near_w=near_w)
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    assert t.valid.sum() > 50
    np.testing.assert_array_equal(np.asarray(j.tile_bbox), t.tile_bbox.numpy())
    np.testing.assert_array_equal(np.asarray(j.fine_y), t.fine_y.numpy())
    for name in ("edges", "attrs"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        scale = np.abs(a).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * scale.max())


def _random_bbox_setup(rng, t, nty, ntx, bin_rows):
    """test_raster.py:351's random bboxes: sparse validity, 1-3 bins tall,
    1-2 wide, fine rows inside the first bin row."""
    ty0 = rng.integers(0, nty, t).astype(np.int32)
    ty1 = np.minimum(ty0 + rng.integers(1, 4, t) - 1, nty - 1).astype(np.int32)
    tx0 = rng.integers(0, ntx, t).astype(np.int32)
    tx1 = np.minimum(tx0 + rng.integers(1, 3, t) - 1, ntx - 1).astype(np.int32)
    valid = rng.random(t) > 0.6
    bbox = np.stack([ty0, tx0, ty1, tx1], axis=1)
    fine = np.stack([ty0 * bin_rows + rng.integers(0, bin_rows, t),
                     ty1 * bin_rows + bin_rows - 1], axis=1).astype(np.int32)
    fine = np.where(valid[:, None], fine, [1, 0]).astype(np.int32)
    arrays = dict(edges=np.zeros((3, 4, t), np.float32),
                  attrs=np.zeros((jr.NATTR, 0), np.float32), tile_bbox=bbox,
                  valid=valid, fine_y=fine)
    j = jr.TriangleSetup(**{k: jnp.asarray(v) for k, v in arrays.items()})
    p = tr.TriangleSetup(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return j, p


@pytest.mark.parametrize("expand_impl", ["kernel", "xla"])
@pytest.mark.parametrize("order_rows,bin_rows",
                         [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_build_pairs_matches_jax_exactly(expand_impl, order_rows, bin_rows):
    """Kernel A's plain version + sort + segments: pair_tri, tile_start,
    tile_count and overflow equal the JAX package's exactly, with an ample
    budget and with one that forces overflow."""
    rng = np.random.default_rng(7)
    nty, ntx = 8, 4
    j_setup, t_setup = _random_bbox_setup(rng, 400, nty, ntx, bin_rows)
    for budget in (None, 256):
        a = jr.build_pairs(j_setup, nty, ntx, bin_rows=bin_rows,
                           order_rows=order_rows, pair_budget=budget,
                           expand_impl=expand_impl, interpret=True)
        b = tr.build_pairs(t_setup, nty, ntx, bin_rows=bin_rows,
                           order_rows=order_rows, pair_budget=budget)
        np.testing.assert_array_equal(np.asarray(a.pair_tri),
                                      b.pair_tri.numpy())
        np.testing.assert_array_equal(np.asarray(a.tile_start),
                                      b.tile_start.numpy())
        np.testing.assert_array_equal(np.asarray(a.tile_count),
                                      b.tile_count.numpy())
        assert int(a.overflow) == int(b.overflow)
    assert int(b.overflow) > 0  # the 256 budget really overflowed


def test_expand_keys_plain_matches_jax_kernel_keys():
    """Kernel A's contract at the key level: the plain version's keys and
    owners equal the Pallas kernel's (interpret mode) for live slots, and
    dead slots carry the sentinel key and owner 0."""
    rng = np.random.default_rng(3)
    nty, ntx, bin_rows = 8, 4, 2
    j_setup, t_setup = _random_bbox_setup(rng, 600, nty, ntx, bin_rows)
    ki = tr.pair_key_inputs(t_setup, nty, ntx, bin_rows=bin_rows,
                            order_rows=True)
    keys, owners = tr.expand_keys(ki)
    jk, jo = jr._expand_keys(
        jnp.asarray(ki.cum.numpy()), jnp.asarray(ki.cum_ex.numpy()),
        jnp.asarray(ki.geom_packed.numpy()), jnp.int32(int(ki.cum[-1])),
        ki.budget, n_tiles_x=ntx, bin_rows=bin_rows, order_rows=True,
        order_alpha=False, tpv=ki.tpv, n_views=1, sentinel=ki.sentinel,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(jk), keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo), owners.numpy())
    total = int(ki.cum[-1])
    assert 0 < total < ki.budget
    assert (keys.numpy()[total:] == ki.sentinel).all()


@pytest.mark.parametrize("short", [False, True])
def test_expand_keys_plain_matches_jax_on_a_flat_alpha_stream(short):
    """Kernel A's plain version against the Pallas kernel (interpret mode)
    on an alpha stream's table: 4,096 triangles of which three runs and a
    few singles cover bins, so cum is flat over long runs of empty
    triangles (the case kernel A's window search jumps), alpha keys; a
    budget past the total (dead slots: sentinel keys, owner 0) and one
    below it."""
    rng = np.random.default_rng(8)
    t, nty, ntx, bin_rows = 4096, 8, 4, 2
    j_setup, t_setup = _random_bbox_setup(rng, t, nty, ntx, bin_rows)
    valid = np.zeros(t, bool)
    for s in (100, 2000, t - 40):
        valid[s:s + 40] = True
    valid[rng.integers(0, t, 12)] = True
    t_setup = dataclasses.replace(t_setup, valid=torch.as_tensor(valid))
    alpha = torch.as_tensor(valid)
    ki = tr.pair_key_inputs(t_setup, nty, ntx, bin_rows=bin_rows,
                            order_rows=True, tri_alpha=alpha)
    total = int(ki.cum[-1])
    if short:
        ki = tr.pair_key_inputs(t_setup, nty, ntx, total // 2, bin_rows,
                                True, tri_alpha=alpha)
    assert (ki.budget < total) == short
    keys, owners = tr.expand_keys_plain(ki)
    jk, jo = jr._expand_keys(
        jnp.asarray(ki.cum.numpy()), jnp.asarray(ki.cum_ex.numpy()),
        jnp.asarray(ki.geom_packed.numpy()), jnp.int32(total), ki.budget,
        n_tiles_x=ntx, bin_rows=bin_rows, order_rows=True, order_alpha=True,
        tpv=ki.tpv, n_views=1, sentinel=ki.sentinel, interpret=True)
    np.testing.assert_array_equal(np.asarray(jk), keys.numpy())
    np.testing.assert_array_equal(np.asarray(jo), owners.numpy())
    spans = np.diff(ki.cum.numpy(), prepend=0)
    assert (spans == 0).mean() > 0.9
    if not short:
        assert (keys.numpy()[total:] == ki.sentinel).all()
        assert (owners.numpy()[total:] == 0).all()


def _edge_margin(edges, width, height):
    """Per pixel, min over triangles of |e| / |grad e| for the three edge
    planes: the pixel centre's distance (px) to the nearest edge line."""
    xs = np.arange(width) + 0.5
    ys = np.arange(height) + 0.5
    best = np.full((height, width), np.inf)
    a, b, c = (edges[k].astype(np.float64) for k in range(3))
    for t in range(edges.shape[2]):
        for p in range(3):
            g = np.hypot(a[p, t], b[p, t])
            if g == 0:
                continue
            e = a[p, t] * xs[None, :] + b[p, t] * ys[:, None] + c[p, t]
            best = np.minimum(best, np.abs(e) / g)
    return best


def _check_winners(ids_a, ids_b, depth_a, depth_b, margin):
    """>= 99.9% of pixels agree on winner and depth; any pixel that differs
    lies within 1e-4 px of an edge line (a coverage tie at float rounding)."""
    diff = (ids_a != ids_b) | (depth_a != depth_b)
    assert diff.mean() <= 1e-3, diff.mean()
    assert (margin[diff] < 1e-4).all(), margin[diff].max()


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_gbuffer_matches_jax(seed):
    """sub=2 bins with row_skip: depth and winner_triangle_ids agree on
    >= 99.9% of pixels (differences only on edges); G-buffer channels
    within atol 1e-4 where both are covered (the TPU's bf16 hi+lo
    coefficient split and rsqrt-Newton reciprocal are mirrored, so only
    library rounding is left)."""
    rng = np.random.default_rng(seed)
    tris = _random_tris(rng, 60)
    j_setup, _ = _both_setups(_setup_inputs(rng, tris), _ortho_vp(), W, H,
                              bin_rows=2)
    t_setup = _to_port(j_setup)
    sub, nty, ntx = 2, H // 32, W // 128
    jp = jr.build_pairs(j_setup, nty, ntx, bin_rows=sub, order_rows=True,
                        interpret=True)
    jpe, jpa = jr.gather_pair_setups(j_setup, jp, True, row_extents=True)
    jd, jv, jg = (np.asarray(x) for x in jr.rasterize_gbuffer(
        jpe, jpa, jp, nty, ntx, interpret=True, sub=sub, row_skip=True))
    j_ids = np.asarray(jr.winner_triangle_ids(jnp.asarray(jv), jp, ntx, sub))

    tp = tr.build_pairs(t_setup, nty, ntx, bin_rows=sub, order_rows=True)
    tpe, tpa = tr.gather_pair_setups(t_setup, tp, row_extents=True)
    np.testing.assert_array_equal(np.asarray(jpe), tpe.numpy())
    np.testing.assert_array_equal(np.asarray(jpa), tpa.numpy())
    td, tv, tg = tr.rasterize_gbuffer(tpe, tpa, tp, nty, ntx, sub=sub,
                                      row_skip=True)
    t_ids = tr.winner_triangle_ids(tv, tp, ntx, sub).numpy()
    assert (t_ids >= 0).mean() > 0.3
    margin = _edge_margin(np.asarray(j_setup.edges), W, H)
    _check_winners(j_ids, t_ids, jd, td.numpy(), margin)
    both = (j_ids >= 0) & (j_ids == t_ids)
    np.testing.assert_allclose(tg.numpy()[:, both], jg[:, both], atol=1e-4,
                               rtol=0)
    assert tg.shape == (tr.GBUF_CHANNELS, H, W)
    # depth keeps the slot bits cleared; vis is -1 exactly where uncovered
    bits = td.numpy().view(np.int32)
    assert (bits & tr.SLOT_MASK == 0).all()
    np.testing.assert_array_equal(tv.numpy() < 0, td.numpy() == 0)


def test_plain_raster_matches_reference_rasterize():
    """The plain raster (order_rows=False: triangle order within a bin, so
    ties break like the reference's later-wins) against the brute-force
    numpy reference: winners on >= 99.9% of pixels with differences only
    on edges, and depth within the 11-bit slot quantisation (2e-3)."""
    rng = np.random.default_rng(5)
    tris = _random_tris(rng, 40)
    _, t_setup = _both_setups(_setup_inputs(rng, tris), _ortho_vp(), W, H,
                              bin_rows=1)
    nty, ntx = H // 16, W // 128
    pairs = tr.build_pairs(t_setup, nty, ntx)
    pe, pa = tr.gather_pair_setups(t_setup, pairs)
    depth, vis, _ = tr.rasterize_gbuffer(pe, pa, pairs, nty, ntx)
    ids = tr.winner_triangle_ids(vis, pairs, ntx).numpy()
    ref_depth, ref_ids = tr.reference_rasterize(
        t_setup.edges.numpy(), t_setup.valid.numpy(), W, H)
    margin = _edge_margin(t_setup.edges.numpy(), W, H)
    cov_diff = (ids >= 0) != (ref_ids >= 0)
    assert (margin[cov_diff] < 1e-4).all()
    covered = (ids >= 0) & (ref_ids >= 0)
    assert covered.mean() > 0.3
    assert (ids[covered] != ref_ids[covered]).mean() < 1e-3
    np.testing.assert_allclose(depth.numpy()[covered], ref_depth[covered],
                               atol=2e-3)
    assert int(pairs.overflow) == 0


def test_gbuffer_wrapper_rejects_bad_inputs():
    """The kernel wrapper checks dtype, shape, contiguity and the bin
    height before it picks a path."""
    pairs = tr.PairLists(pair_tri=torch.zeros(256, dtype=torch.int32),
                         tile_start=torch.zeros(8, dtype=torch.int32),
                         tile_count=torch.zeros(8, dtype=torch.int32),
                         overflow=torch.zeros((), dtype=torch.int32))
    edges = torch.zeros((16, 256))
    attrs = torch.zeros((32, 256))
    with pytest.raises(ValueError):
        tr.rasterize_gbuffer(edges.double(), attrs, pairs, 4, 2)
    with pytest.raises(ValueError):
        tr.rasterize_gbuffer(edges.t().contiguous().t(), attrs, pairs, 4, 2)
    with pytest.raises(ValueError):  # kernel B's block is 128 * sub <= 512
        tr.rasterize_gbuffer(edges, attrs, pairs, 1, 2, sub=8)
    depth, vis, gbuf = tr.rasterize_gbuffer(edges, attrs, pairs, 4, 2)
    assert (vis == -1).all() and (depth == 0).all() and (gbuf == 0).all()
