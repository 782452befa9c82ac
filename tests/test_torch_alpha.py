"""The port's alpha-tested geometry against the JAX package: the 8-plane
setup (main view and cascade atlas), the 32-row pair table, kernel A's
alpha key bit, the alpha depth raster (kernel J's plain version, both
bodies), the alpha G-buffer split (kernels K + L's plain versions), the
numpy reference's cut-out, the atlas's opaque/alpha stream split and the
sort-carried setup rows (kernel M's plain version). The JAX side runs its
Pallas kernels in interpret mode, the port its plain PyTorch versions.

The raster comparisons state one rule: coverage and winners agree on all
but 1e-3 of the pixels, and every pixel that differs lies on a triangle
edge (within 1e-4 px) or on a mask-texel edge (u or v within 1e-3 texel of
a multiple of 1/64). XLA on the CPU may fuse the JAX kernel's plane
evaluation into FMAs and its rsqrt is not correctly rounded, while the
port rounds every step; one ulp of u at a texel edge flips a mask bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import raster as jr
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu_torch.assets.textures import build_alpha_mask
from plainrenderer_tpu_torch.ops import raster as tr
from plainrenderer_tpu_torch.render import frame as tframe

torch.set_num_threads(1)

W, H = 256, 64  # 2 x 4 tiles of 128 x 16
SUB = 2  # 32-px bins, as the main view
NTY, NTX = H // (16 * SUB), W // 128


def _ortho_vp():
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0] = vp[1, 1] = 2.0
    vp[0, 3] = vp[1, 3] = -1.0
    return vp


def _masks(rng, n=2):
    """Mask 1: an 8x8-texel checkerboard; mask 2: random texels, 60% set."""
    yy, xx = np.mgrid[0:64, 0:64]
    masks = np.zeros((n, 128), np.int32)
    masks[0] = build_alpha_mask((((yy // 8) + (xx // 8)) % 2)
                                .astype(np.float32))
    for m in range(1, n):
        masks[m] = build_alpha_mask((rng.random((64, 64)) > 0.4)
                                    .astype(np.float32))
    return masks


def _inputs(rng, n, uv_scale=3.0, slot_max=2):
    """n random screen triangles (ortho [0, 1]^2) with uvs over several
    wraps of the mask and slots 0 (opaque) .. slot_max."""
    cx, cy = rng.uniform(0.1, 0.9, (2, n))
    size = rng.uniform(0.05, 0.3, n)
    z = rng.uniform(0.1, 0.95, n)
    tris = np.stack([
        np.stack([cx - size, cy - size, z], -1),
        np.stack([cx + size, cy - size * rng.uniform(0.5, 1.5, n), z], -1),
        np.stack([cx + size * rng.uniform(-0.8, 0.8, n), cy + size, z], -1),
    ], axis=1).astype(np.float32)
    uvs = (rng.random((n, 3, 2)) * uv_scale).astype(np.float32)
    unit = rng.normal(size=(n, 3, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    material = rng.integers(0, 40, n).astype(np.float32)
    slots = rng.integers(0, slot_max + 1, n).astype(np.int32)
    return (tris, uvs, unit, unit, unit, material, np.ones(n, bool)), slots


def _jax_setup(inputs, slots, vp, width=W, height=H, bin_rows=SUB,
               near_w=0.0, cull="none"):
    return jr.geometry_setup(
        *[jnp.asarray(a) for a in inputs], jnp.asarray(vp), jnp.asarray(vp),
        width, height, cull=cull, near_w=near_w,
        tri_alpha_slot=jnp.asarray(slots), bin_rows=bin_rows)


def _to_port(setup) -> tr.TriangleSetup:
    return tr.TriangleSetup(**{
        k: torch.as_tensor(np.array(getattr(setup, k)))
        for k in ("edges", "attrs", "tile_bbox", "valid", "fine_y")})


def _edge_margin(edges, width, height):
    """Per pixel, the distance (px) to the nearest edge line of any
    triangle."""
    xs = np.arange(width) + 0.5
    ys = np.arange(height) + 0.5
    best = np.full((height, width), np.inf)
    a, b, c = (edges[k].astype(np.float64) for k in range(3))
    for t in range(edges.shape[2]):
        for p in range(3):
            g = np.hypot(a[p, t], b[p, t])
            if g:
                e = a[p, t] * xs[None, :] + b[p, t] * ys[:, None] + c[p, t]
                best = np.minimum(best, np.abs(e) / g)
    return best


def _texel_margin(edges, width, height):
    """Per pixel, over the alpha-tested triangles, the distance (texels) of
    u * 64 or v * 64 to the nearest integer: 0 on a mask-texel edge."""
    xs = np.arange(width) + 0.5
    ys = np.arange(height) + 0.5
    best = np.full((height, width), np.inf)
    a, b, c = (edges[k].astype(np.float64) for k in range(3))
    for t in np.flatnonzero(c[7] > 0.5):
        ev = [a[p, t] * xs[None, :] + b[p, t] * ys[:, None] + c[p, t]
              for p in (4, 5, 6)]
        iw = np.where(ev[2] > 1e-12, ev[2], 1.0)
        for q in (ev[0] / iw, ev[1] / iw):
            best = np.minimum(best, np.abs(q * 64 - np.round(q * 64)))
    return best


def _check_edges_only(diff, edges, width, height):
    """<= 1e-3 of pixels differ, each on a triangle or mask-texel edge."""
    assert diff.mean() <= 1e-3, diff.mean()
    if diff.any():
        on_edge = (_edge_margin(edges, width, height) < 1e-4) \
            | (_texel_margin(edges, width, height) < 1e-3)
        assert on_edge[diff].all()


@pytest.mark.parametrize("projection", ["ortho", "perspective"])
def test_eight_plane_setup_matches_jax(projection):
    """Planes 4-7 (u/w, v/w, 1/w, the slot) beside the 4 opaque planes:
    the same bits as the JAX setup for these inputs (both sides do the
    same float32 operations in the same order); the slot plane is exactly
    (0, 0, slot) on valid triangles and 0 elsewhere; bboxes and validity
    equal."""
    rng = np.random.default_rng(31)
    inputs, slots = _inputs(rng, 120)
    vp, near_w = _ortho_vp(), 0.0
    if projection == "perspective":
        from plainrenderer_tpu_torch.config import RenderSettings

        inputs[0][:, :, 2] = rng.uniform(-1.0, 2.45, (120, 1))
        proj = tframe._projection(RenderSettings(width=W, height=H))
        view = np.eye(4, dtype=np.float32)
        view[:3, 3] = [-0.5, -0.5, -2.5]
        vp, near_w = (proj @ view).astype(np.float32), 0.1
    j = _jax_setup(inputs, slots, vp, near_w=near_w)
    t = tr.geometry_setup(*[torch.as_tensor(a) for a in inputs],
                          torch.as_tensor(vp), W, H, cull="none",
                          near_w=near_w, bin_rows=SUB,
                          tri_alpha_slot=torch.as_tensor(slots))
    assert t.edges.shape == (3, 8, 120)
    for name in ("valid", "tile_bbox", "fine_y", "edges", "attrs"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    e = t.edges.numpy()
    assert (e[:2, 7] == 0).all()
    # the slot plane is zeroed where the triangle fails the facing or
    # near tests (it is written before the offscreen cull)
    assert ((e[2, 7] != 0) <= (slots > 0)).all() and (e[2, 7] > 0).any()
    assert (e[2, 7][t.valid.numpy()] == slots[t.valid.numpy()]).all()
    # the opaque planes are the 4-plane setup's
    t4 = tr.geometry_setup(*[torch.as_tensor(a) for a in inputs],
                           torch.as_tensor(vp), W, H, cull="none",
                           near_w=near_w, bin_rows=SUB)
    np.testing.assert_array_equal(e[:, :4], t4.edges.numpy())


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def test_alpha_atlas_setup_matches_jax():
    """The batched cascade setup with alpha slots (frame.py:164-226) of the
    small banner atrium under test_torch_shadow.py's cascade fit: the
    8-plane atlas table within rtol 1e-5 of the vmapped JAX stage (the
    4-plane atlas test's rule), validity, bboxes and the slot plane equal
    (the band shift leaves it alone)."""
    from plainrenderer_tpu.assets import procedural as jproc
    from plainrenderer_tpu.ops import shadow as jshadow
    from plainrenderer_tpu.render import scenebuild as jsb

    rs = jsb.build_render_scene(jproc.build_atrium_scene(jproc.AtriumConfig(
        columns_per_row=2, floor_subdiv=2, box_count=0, box_subdiv=1,
        column_segments=8, banner_count=2), textured=True))
    j_scene = jframe.scene_to_device(rs)
    t_scene = tframe.scene_to_device(rs, device="cpu")
    mats = jshadow.compute_cascade_info(
        jnp.float32(0.004), jnp.float32(0.3),
        jnp.asarray([-3.0, -1.8, 0.3], jnp.float32),
        jnp.asarray(_unit([0.94, 0.14, 0.31])),
        jnp.asarray(_unit([0.13, -0.99, 0.04])),
        jnp.asarray(_unit([-0.31, 0.0, 0.95])), 0.3153, 16 / 9, 0.1, 300.0,
        jnp.asarray(_unit([0.3, -0.8, 0.45])), 3, jnp.float32(3.0),
        jnp.float32(30.0))[0]
    n_cas, sres, t_count = 3, 256, rs.corners.shape[0]
    j = jframe.shadow_atlas_setup(
        j_scene, j_scene["corners"], j_scene["corner_normals"],
        j_scene["corner_tangents"], j_scene["corner_bitangents"],
        j_scene["object_bb_min"], j_scene["object_bb_max"], mats, n_cas,
        sres, j_scene["tri_alpha_slot"], t_count)
    t = tframe.shadow_atlas_setup(t_scene, torch.as_tensor(np.array(mats)),
                                  n_cas, sres, t_scene["tri_alpha_slot"])
    assert t.edges.shape == (3, 8, n_cas * t_count)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    np.testing.assert_array_equal(t.tile_bbox.numpy(), np.asarray(j.tile_bbox))
    np.testing.assert_array_equal(t.fine_y.numpy(), np.asarray(j.fine_y))
    je, te = np.asarray(j.edges), t.edges.numpy()
    np.testing.assert_array_equal(te[:, 7], je[:, 7])
    slots = np.tile(rs.tri_alpha_slot, n_cas)
    assert (te[2, 7][valid] == slots[valid]).all()
    assert (valid & (slots > 0)).sum() > 20
    scale = np.abs(je[..., valid]).max(axis=0, keepdims=True) + 1e-30
    np.testing.assert_allclose(te[..., valid] / scale, je[..., valid] / scale,
                               rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def alpha_case():
    """60 random triangles, a third opaque, with their JAX setup and the
    same numbers on the port's side."""
    rng = np.random.default_rng(32)
    inputs, slots = _inputs(rng, 60)
    j_setup = _jax_setup(inputs, slots, _ortho_vp())
    return j_setup, _to_port(j_setup), _masks(rng), slots


def test_alpha_pair_table_matches_jax(alpha_case):
    """The 32-row pair table, plane-major [a, b, c, pad] with rows 3/7 the
    fine-row bbox and row 30 the slot, equals JAX's bit for bit."""
    j_setup, t_setup, _, _ = alpha_case
    jp = jr.build_pairs(j_setup, NTY, NTX, bin_rows=SUB, order_rows=True,
                        interpret=True)
    tp = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB, order_rows=True)
    jpe, jpa = jr.gather_pair_setups(j_setup, jp, True, row_extents=True)
    tpe, tpa = tr.gather_pair_setups(t_setup, tp, row_extents=True)
    assert tpe.shape[0] == 32
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(jpe))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    live = tp.pair_tri.numpy() < 60
    slots = alpha_case[3]
    np.testing.assert_array_equal(tpe.numpy()[30][live],
                                  slots[tp.pair_tri.numpy()[live]])


@pytest.mark.parametrize("with_init", [False, True])
def test_alpha_depth_plain_matches_jax(alpha_case, with_init):
    """Kernel J's plain version against _depth_kernel_alpha (and, with
    init_depth, _depth_kernel_alpha_acc, onto an opaque pass of other
    triangles): coverage equal except at triangle and texel edges
    (module rule), depth within 1e-6 elsewhere; the masks really cut."""
    j_setup, t_setup, masks, slots = alpha_case
    j_init = t_init = None
    if with_init:
        rng = np.random.default_rng(33)
        inputs, _ = _inputs(rng, 30)
        jo = jr.geometry_setup(
            *[jnp.asarray(a) for a in inputs], jnp.asarray(_ortho_vp()),
            jnp.asarray(_ortho_vp()), W, H, cull="none", bin_rows=SUB)
        jop = jr.build_pairs(jo, NTY, NTX, bin_rows=SUB, interpret=True)
        joe, _ = jr.gather_pair_setups(jo, jop, False)
        j_init = jr.rasterize_depth(joe, jop, NTY, NTX, interpret=True,
                                    sub=SUB)
        t_init = torch.as_tensor(np.array(j_init))
    jp = jr.build_pairs(j_setup, NTY, NTX, bin_rows=SUB, interpret=True)
    je, _ = jr.gather_pair_setups(j_setup, jp, False)
    j = np.asarray(jr.rasterize_depth(
        je, jp, NTY, NTX, interpret=True, alpha_masks=jnp.asarray(masks),
        sub=SUB, init_depth=j_init))
    tp = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB)
    te, _ = tr.gather_pair_setups(t_setup, tp, with_attrs=False)
    t = tr.rasterize_depth(te, tp, NTY, NTX, sub=SUB,
                           alpha_masks=torch.as_tensor(masks),
                           init_depth=None if t_init is None
                           else t_init.clone()).numpy()
    _check_edges_only(np.abs(t - j) > 1e-6, t_setup.edges.numpy(), W, H)
    # the masks cut: without them more texels are covered
    uncut = tr.depth_plain(te, tp.tile_start, tp.tile_count, NTY, NTX, SUB,
                           False, init=t_init).numpy()
    assert (uncut > 0).sum() > (t > 0).sum() > 0.3 * W * H
    assert (uncut >= t).all()
    if with_init:
        assert (t >= t_init.numpy()).all() and (t > t_init.numpy()).any()


def test_split_atlas_streams_equal_single_stream(alpha_case):
    """The port's opaque/alpha atlas split (4-plane kernel-E pass, then the
    alpha stream max-merged in place into it by kernel J's init_depth)
    equals its single 8-plane alpha raster bit for bit
    (tests/test_raster.py:400-456 holds the same for JAX)."""
    _, t_setup, masks, slots = alpha_case
    m = torch.as_tensor(masks)
    pairs = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB, order_rows=True)
    edges, _ = tr.gather_pair_setups(t_setup, pairs, row_extents=True,
                                     with_attrs=False)
    single = tr.rasterize_depth(edges, pairs, NTY, NTX, sub=SUB,
                                row_skip=True, alpha_masks=m)
    is_alpha = torch.as_tensor(slots > 0)
    so = dataclasses.replace(t_setup, edges=t_setup.edges[:, :4],
                             valid=t_setup.valid & ~is_alpha)
    sa = dataclasses.replace(t_setup, valid=t_setup.valid & is_alpha)
    po = tr.build_pairs(so, NTY, NTX, bin_rows=SUB, order_rows=True)
    eo, _ = tr.gather_pair_setups(so, po, row_extents=True, with_attrs=False)
    d0 = tr.rasterize_depth(eo, po, NTY, NTX, sub=SUB, row_skip=True)
    pa = tr.build_pairs(sa, NTY, NTX, bin_rows=SUB, order_rows=True)
    ea, _ = tr.gather_pair_setups(sa, pa, row_extents=True, with_attrs=False)
    merged = d0.clone()
    split = tr.rasterize_depth(ea, pa, NTY, NTX, sub=SUB, row_skip=True,
                               alpha_masks=m, init_depth=merged)
    assert split is merged
    np.testing.assert_array_equal(split.view(torch.int32).numpy(),
                                  single.view(torch.int32).numpy())
    assert (split > d0).any() and (split > 0).float().mean() > 0.3
    assert int(po.overflow) == int(pa.overflow) == 0


def test_alpha_gbuffer_plain_matches_jax(alpha_case):
    """Kernels K + L's plain versions against _rasterize_gbuffer_split:
    depth and winners by the module rule (the rule of
    test_torch_raster.py:200-203, widened to mask-texel edges); channels
    within 1e-4 where both win the same triangle (test_torch_raster's
    tolerance: only library rounding is left)."""
    j_setup, t_setup, masks, _ = alpha_case
    jp = jr.build_pairs(j_setup, NTY, NTX, bin_rows=SUB, order_rows=True,
                        interpret=True)
    jpe, jpa = jr.gather_pair_setups(j_setup, jp, True, row_extents=True)
    jd, jv, jg = (np.asarray(x) for x in jr.rasterize_gbuffer(
        jpe, jpa, jp, NTY, NTX, interpret=True,
        alpha_masks=jnp.asarray(masks), sub=SUB, row_skip=True))
    j_ids = np.asarray(jr.winner_triangle_ids(jnp.asarray(jv), jp, NTX, SUB))
    tp = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB, order_rows=True)
    tpe, tpa = tr.gather_pair_setups(t_setup, tp, row_extents=True)
    td, tv, tg = tr.rasterize_gbuffer(tpe, tpa, tp, NTY, NTX, sub=SUB,
                                      row_skip=True,
                                      alpha_masks=torch.as_tensor(masks))
    t_ids = tr.winner_triangle_ids(tv, tp, NTX, SUB).numpy()
    _check_edges_only((j_ids != t_ids) | (jd != td.numpy()),
                      t_setup.edges.numpy(), W, H)
    both = (j_ids >= 0) & (j_ids == t_ids)
    assert both.mean() > 0.3
    np.testing.assert_allclose(tg.numpy()[:, both], jg[:, both], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(tv.numpy() < 0, td.numpy() == 0)
    # the split is the composition of its two halves
    d2, v2 = tr.winner_alpha_plain(tpe, tp.tile_start, tp.tile_count,
                                   torch.as_tensor(masks), NTY, NTX, SUB,
                                   True)
    np.testing.assert_array_equal(v2.numpy(), tv.numpy())
    np.testing.assert_array_equal(
        tr.attr_resolve_plain(tpa, tp.tile_start, v2, NTY, NTX, SUB).numpy(),
        tg.numpy())


def _quad(x0, y0, x1, y1, z):
    """tests/test_raster.py:_quad: two counter-clockwise triangles with
    uvs spanning [0, 1]^2."""
    tris = [[[x0, y0, z], [x1, y0, z], [x0, y1, z]],
            [[x1, y1, z], [x0, y1, z], [x1, y0, z]]]
    uvs = [[[0, 0], [1, 0], [0, 1]], [[1, 1], [0, 1], [1, 0]]]
    return tris, uvs


def test_alpha_cut_front_quad_shows_back_quad():
    """tests/test_raster.py:288-319 on the port: an alpha-cut quad over an
    opaque one; kernels K + L's plain versions and the copied numpy
    reference agree on coverage, and both quads show through the 8x8
    checkerboard (depthPrepass.frag:28-31 at 64x64 mask resolution)."""
    f_tris, f_uvs = _quad(0.15, 0.15, 0.85, 0.85, 0.8)  # front, alpha
    b_tris, b_uvs = _quad(0.05, 0.05, 0.95, 0.95, 0.3)  # back, opaque
    tris = np.asarray(f_tris + b_tris, np.float32)
    normals = np.tile(np.asarray([0, 0, 1], np.float32), (4, 3, 1))
    masks = _masks(np.random.default_rng(0), 1)
    setup = tr.geometry_setup(
        torch.as_tensor(tris), torch.as_tensor(np.asarray(f_uvs + b_uvs,
                                                          np.float32)),
        *[torch.as_tensor(normals)] * 3, torch.zeros(4), torch.ones(4, dtype=bool),
        torch.as_tensor(_ortho_vp()), W, H, cull="none",
        tri_alpha_slot=torch.as_tensor([1, 1, 0, 0], dtype=torch.int32))
    nty = H // 16
    pairs = tr.build_pairs(setup, nty, NTX)
    pe, pa = tr.gather_pair_setups(setup, pairs)
    depth, vis, _ = tr.rasterize_gbuffer(pe, pa, pairs, nty, NTX,
                                         alpha_masks=torch.as_tensor(masks))
    ids = tr.winner_triangle_ids(vis, pairs, NTX).numpy()
    ref_depth, ref_ids = tr.reference_rasterize(
        setup.edges.numpy(), setup.valid.numpy(), W, H, alpha_masks=masks)
    np.testing.assert_array_equal(ids >= 0, ref_ids >= 0)
    covered = ids >= 0
    assert (ids[covered] != ref_ids[covered]).mean() < 0.01
    np.testing.assert_allclose(depth.numpy()[covered], ref_depth[covered],
                               atol=2e-3)
    assert (ids[covered] < 2).sum() > 200 and (ids[covered] >= 2).sum() > 200
    inside_front = (np.abs(np.arange(W) + 0.5 - 0.5 * W) < 0.3 * W)[None] \
        & (np.abs(np.arange(H) + 0.5 - 0.5 * H) < 0.3 * H)[:, None]
    assert (ids[inside_front] >= 2).sum() > 200  # the back through holes
    assert (ids[inside_front] < 2).sum() > 200


@pytest.mark.parametrize("expand_impl", ["kernel", "xla"])
def test_alpha_keys_match_jax_exactly(expand_impl):
    """build_pairs(tri_alpha=...) (kernel A's order_alpha keys and their
    plain version): pair_tri, segments and overflow equal the JAX
    package's exactly, as tests/test_raster.py:348-398's with_alpha case
    builds them, and alpha pairs close every bin's segment."""
    rng = np.random.default_rng(34)
    t, nty, ntx, bin_rows = 400, 8, 4, 2
    ty0 = rng.integers(0, nty, t).astype(np.int32)
    ty1 = np.minimum(ty0 + rng.integers(1, 4, t) - 1, nty - 1)
    tx0 = rng.integers(0, ntx, t).astype(np.int32)
    tx1 = np.minimum(tx0 + rng.integers(1, 3, t) - 1, ntx - 1)
    valid = rng.random(t) > 0.6
    fine = np.stack([ty0 * bin_rows + rng.integers(0, bin_rows, t),
                     ty1 * bin_rows + bin_rows - 1], axis=1)
    arrays = dict(edges=np.zeros((3, 4, t), np.float32),
                  attrs=np.zeros((jr.NATTR, 0), np.float32),
                  tile_bbox=np.stack([ty0, tx0, ty1, tx1], 1).astype(np.int32),
                  valid=valid,
                  fine_y=np.where(valid[:, None], fine, [1, 0]).astype(np.int32))
    j_setup = jr.TriangleSetup(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t_setup = tr.TriangleSetup(**{k: torch.as_tensor(v)
                                  for k, v in arrays.items()})
    tri_alpha = rng.random(t) < 0.1
    for budget in (None, 256):
        a = jr.build_pairs(j_setup, nty, ntx, bin_rows=bin_rows,
                           order_rows=True, pair_budget=budget,
                           tri_alpha=jnp.asarray(tri_alpha),
                           expand_impl=expand_impl, interpret=True)
        b = tr.build_pairs(t_setup, nty, ntx, bin_rows=bin_rows,
                           order_rows=True, pair_budget=budget,
                           tri_alpha=torch.as_tensor(tri_alpha))
        for k in ("pair_tri", "tile_start", "tile_count", "overflow"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
    assert int(b.overflow) > 0
    b = tr.build_pairs(t_setup, nty, ntx, bin_rows=bin_rows, order_rows=True,
                       tri_alpha=torch.as_tensor(tri_alpha))
    tri, starts, counts = (x.numpy() for x in (b.pair_tri, b.tile_start,
                                               b.tile_count))
    n_closing = 0
    for s, c in zip(starts, counts):
        flags = tri_alpha[tri[s:s + c]]
        assert (np.diff(flags.astype(int)) >= 0).all()  # opaque, then alpha
        n_closing += bool(flags.any() and not flags.all())
    assert n_closing > 0


@pytest.mark.parametrize("order_rows", [False, True])
def test_carry_table_matches_gather_and_jax(alpha_case, order_rows):
    """build_pairs(carry_table=...) (kernel M's plain version, then the
    sort's permutation): the same segments as without it, rows equal to
    gather_pair_setups on every live slot and zero past them, and equal
    to the JAX package's sort-carried rows (tests/test_raster.py:458)."""
    j_setup, t_setup, _, _ = alpha_case
    table, n_edge = tr.setup_row_table(t_setup, row_extents=True)
    plain = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB,
                           order_rows=order_rows)
    pairs, rows = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB,
                                 order_rows=order_rows, carry_table=table)
    for k in ("pair_tri", "tile_start", "tile_count", "overflow"):
        np.testing.assert_array_equal(getattr(pairs, k).numpy(),
                                      getattr(plain, k).numpy(), err_msg=k)
    pe, pa = tr.gather_pair_setups(t_setup, plain, row_extents=True)
    total = int(plain.tile_count.sum())
    assert rows.shape == (n_edge + 32, pairs.pair_tri.shape[0])
    np.testing.assert_array_equal(rows[:n_edge, :total].numpy(),
                                  pe[:, :total].numpy())
    np.testing.assert_array_equal(rows[n_edge:, :total].numpy(),
                                  pa[:, :total].numpy())
    assert (rows[:, total:] == 0).all()
    j_table, _ = jr.setup_row_table(j_setup, True, row_extents=True)
    np.testing.assert_array_equal(table.numpy(), np.asarray(j_table))
    _, j_rows = jr.build_pairs(j_setup, NTY, NTX, bin_rows=SUB,
                               order_rows=order_rows, carry_table=j_table,
                               interpret=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))


def test_expand_rows_plain_is_the_owner_gather():
    """Kernel M's plain version: column j is the owner's column for live
    slots and 0 past total; the wrapper checks its inputs."""
    rng = np.random.default_rng(35)
    table = torch.as_tensor(rng.random((48, 11)).astype(np.float32))
    owners = torch.as_tensor(np.sort(rng.integers(0, 10, 40)).astype(np.int32))
    total = torch.tensor([30], dtype=torch.int32)
    out = tr.expand_rows(owners, table, total, 40)
    np.testing.assert_array_equal(out[:, :30].numpy(),
                                  table.numpy()[:, owners.numpy()[:30]])
    assert (out[:, 30:] == 0).all()
    with pytest.raises(ValueError):
        tr.expand_rows(owners.long(), table, total, 40)
    with pytest.raises(ValueError):
        tr.expand_rows(owners, table, total, 41)


def test_alpha_wrappers_reject_bad_inputs(alpha_case):
    """Kernel J, K and L wrappers check the table height, the masks and
    init_depth before they pick a path."""
    _, t_setup, masks, _ = alpha_case
    m = torch.as_tensor(masks)
    tp = tr.build_pairs(t_setup, NTY, NTX, bin_rows=SUB)
    te, _ = tr.gather_pair_setups(t_setup, tp, with_attrs=False)
    with pytest.raises(ValueError):  # 16 rows with masks
        tr.rasterize_depth(te[:16].contiguous(), tp, NTY, NTX, sub=SUB,
                           alpha_masks=m)
    with pytest.raises(ValueError):  # init_depth without masks
        tr.rasterize_depth(te[:16].contiguous(), tp, NTY, NTX, sub=SUB,
                           init_depth=torch.zeros(H, W))
    with pytest.raises(ValueError):  # 9 masks
        tr.rasterize_depth(te, tp, NTY, NTX, sub=SUB,
                           alpha_masks=torch.zeros((9, 128), dtype=torch.int32))
    with pytest.raises(ValueError):  # wrong init shape
        tr.rasterize_depth(te, tp, NTY, NTX, sub=SUB, alpha_masks=m,
                           init_depth=torch.zeros(H, W + 1))
    with pytest.raises(ValueError):  # kernel K's block is 128 * sub <= 512
        tr.rasterize_winner_alpha(te, tp, m, 1, NTX, sub=8)
    with pytest.raises(ValueError):
        tr.resolve_attributes(torch.zeros(32, 8), tp.tile_start,
                              torch.zeros((H, W), dtype=torch.int64), NTY,
                              NTX, SUB)
