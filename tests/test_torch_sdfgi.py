"""The port's SDF GI against the JAX package: the mesh SDF bake, the scene
composite, the brick layout and coarse tables, the trace (the JAX kernel
in interpret mode, the port's plain version) and the filter chain.

Trace rule: `escaped` and the hit/miss decision equal on >= 99.9% of rays,
the six value channels within 1e-4 (abs + rel) where both agree. To make
the hit/miss decision visible in the output, the sky is shifted by -10:
a miss reads negative Y, a hit (albedo^2.2 * sun * visibility) never
does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.assets import procedural as jproc
from plainrenderer_tpu.assets import sdf_bake as jbake
from plainrenderer_tpu.ops import sdf_scene as jscene
from plainrenderer_tpu.ops import sdfgi as jgi
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.assets import sdf_bake as tbake
from plainrenderer_tpu_torch.ops import sdf_scene as tscene
from plainrenderer_tpu_torch.ops import sdfgi as tgi

torch.set_num_threads(1)

ALBEDO = np.asarray([[0.8, 0.2, 0.1], [0.3, 0.6, 0.9]], np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _pad16(vol, fill):
    """Pad a volume to whole bricks, at least one 32^3 window
    (frame.py:1214-1220)."""
    widths = [(0, max(32, (n + 15) // 16 * 16) - n) for n in vol.shape[:3]]
    widths += [(0, 0)] * (vol.ndim - 3)
    return np.pad(vol, widths, constant_values=fill)


def _box_volume():
    """test_sdfgi.py's 2 m box, baked by the JAX package's numpy path."""
    mesh = jproc.box_mesh(2.0, 2.0, 2.0)
    return jbake.bake_mesh_sdf(mesh.positions, mesh.indices,
                               resolution=(16, 16, 16), use_native=False)


def _box_gsdf():
    """test_sdfgi.py:_box_global_sdf."""
    return jscene.composite_global_sdf(
        [_box_volume()], np.asarray([[-1.0] * 3], np.float32),
        np.asarray([[1.0] * 3], np.float32), np.eye(4, dtype=np.float32)[None],
        ALBEDO[:1], voxel_size=0.25, margin=2.0)


@pytest.mark.parametrize("size,res", [((2.0, 2.0, 2.0), (16, 16, 16)),
                                      ((3.0, 1.0, 2.0), None)])
def test_bake_matches_numpy_bake(size, res):
    """bake_mesh_sdf (torch, CPU) against the JAX package's numpy bake
    (use_native=False) within 1e-5; the resolution rule is equal."""
    jm, tm = jproc.box_mesh(*size), tproc.box_mesh(*size)
    np.testing.assert_array_equal(jm.positions, tm.positions)
    bb = (jm.positions.min(0), jm.positions.max(0))
    assert tbake.sdf_resolution_for_aabb(*bb) == \
        jbake.sdf_resolution_for_aabb(*bb)
    want = jbake.bake_mesh_sdf(jm.positions, jm.indices, resolution=res,
                               use_native=False)
    got = tbake.bake_mesh_sdf(tm.positions, tm.indices, resolution=res,
                              device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_composite_two_boxes_bit_identical():
    """Two boxes, one rotated and scaled, composited by both packages from
    the same baked volumes: volume, albedo, origin and voxel size equal."""
    vol = _box_volume()
    c, s = np.cos(0.6), np.sin(0.6)
    moved = np.asarray([[1.5 * c, 0, 1.5 * s, 2.5], [0, 1.5, 0, -0.5],
                        [-1.5 * s, 0, 1.5 * c, 1.0], [0, 0, 0, 1]],
                       np.float32)
    args = ([vol, vol], np.asarray([[-1.0] * 3] * 2, np.float32),
            np.asarray([[1.0] * 3] * 2, np.float32),
            np.stack([np.eye(4, dtype=np.float32), moved]), ALBEDO)
    want = jscene.composite_global_sdf(*args, voxel_size=0.25, margin=1.0)
    got = tscene.composite_global_sdf(*args, voxel_size=0.25, margin=1.0)
    np.testing.assert_array_equal(got.volume, want.volume)
    np.testing.assert_array_equal(got.albedo, want.albedo)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert got.voxel_size == want.voxel_size


def test_brick_layout_and_coarse_tables_match():
    """quantize_sdf_volume, pack_albedo_volume and both coarse tables are
    exact (the coarse albedo sums each 4^3 block in XLA's order)."""
    g = _box_gsdf()
    rng = np.random.default_rng(3)
    vol = _pad16(g.volume, 1e4)
    alb = _pad16(g.albedo * rng.uniform(0.5, 1.0, g.albedo.shape)
                 .astype(np.float32), 0.5)
    jv = jgi.quantize_sdf_volume(jnp.asarray(vol), g.voxel_size)
    ja = jgi.pack_albedo_volume(jnp.asarray(alb))
    tv = tgi.quantize_sdf_volume(_t(vol), g.voxel_size)
    ta = tgi.pack_albedo_volume(_t(alb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    dims = vol.shape
    assert tgi.coarse_factor_for(dims) == jgi.coarse_factor_for(dims)
    assert tgi.coarse_factor_for((128, 128, 256)) == \
        jgi.coarse_factor_for((128, 128, 256)) == 8
    js, jal, jdims, jf = jgi.build_coarse_tables(jv, ja, dims)
    ts, tal, tdims, tf = tgi.build_coarse_tables(tv, ta, dims)
    assert (tdims, tf) == (tuple(jdims), jf)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tal.numpy(), np.asarray(jal))
    # the unpack helpers invert the packing
    np.testing.assert_array_equal(
        tgi.unpack_sdf_volume(tv, dims).numpy(),
        np.clip(np.round(vol / g.voxel_size * 8), -127, 127) / 8)


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

def _wall_case(x_wall, steps, influence, coarse):
    """test_sdfgi.py's wall scenes (:156, :316): 2048 rays at x = 2 m
    marching +x towards a wall at x_wall in a 24 m volume."""
    voxel, n = 0.25, 96
    xs = (np.arange(n) + 0.5) * voxel
    vol = np.broadcast_to((x_wall - xs)[None, None, :], (n, n, n)) \
        .astype(np.float32)
    th, tw = 16, 128
    wpos = np.stack([np.full((th, tw), 2.0), np.full((th, tw), 12.0),
                     np.full((th, tw), 12.0)]).astype(np.float32)
    normal = np.stack([np.ones((th, tw)), np.zeros((th, tw)),
                       np.zeros((th, tw))]).astype(np.float32)
    return dict(wpos=wpos, normal=normal, dirs=normal,
                valid=np.ones((th, tw), bool),
                sky=np.full((3, 32, 64), 0.5, np.float32), vol=vol,
                alb=np.full((n, n, n, 3), 0.9, np.float32),
                origin=np.zeros(3, np.float32), voxel=voxel,
                sun=[0.0, -1.0, 0.0], steps=steps, influence=influence,
                coarse=coarse)


def _box_case():
    """test_sdfgi.py:81 — rays from y = -3 straight down onto the box."""
    g = _box_gsdf()
    h, w = 16, 128
    gx, gz = np.meshgrid(np.linspace(-2.5, 2.5, w), np.linspace(-2.5, 2.5, h),
                         indexing="xy")
    zero = np.zeros_like(gx)
    return dict(wpos=np.stack([gx, zero - 3.0, gz]).astype(np.float32),
                normal=np.stack([zero, zero - 1.0, zero]).astype(np.float32),
                dirs=np.stack([zero, zero + 1.0, zero]).astype(np.float32),
                valid=np.ones((h, w), bool),
                sky=(np.ones((3, 32, 64)) * np.asarray([0.2, 0.4, 1.0])[
                    :, None, None]).astype(np.float32),
                vol=_pad16(g.volume, 100.0), alb=_pad16(g.albedo, 0.5),
                origin=g.origin, voxel=g.voxel_size, sun=[0.0, -1.0, 0.0],
                steps=12, influence=8.0, coarse=False)


def _mixed_case():
    """32x256 rays (2 x 2 tiles) around the box on random hemispheres:
    one tile fully valid, one empty, two mixed; coarse fallback on."""
    g = _box_gsdf()
    rng = np.random.default_rng(7)
    h, w = 32, 256
    radial = rng.normal(size=(3, h, w))
    radial /= np.linalg.norm(radial, axis=0)
    # surface points on a 1.6 m sphere around the box; half the surfaces
    # face the box, half face away
    normal = radial * np.where(rng.random((h, w)) < 0.5, -1.0, 1.0)
    dirs = rng.normal(size=(3, h, w))
    dirs /= np.linalg.norm(dirs, axis=0)
    dirs = normal * 1.5 + dirs
    dirs /= np.linalg.norm(dirs, axis=0)
    wpos = radial * 1.6 + rng.normal(scale=0.05, size=(3, h, w))
    valid = rng.random((h, w)) < 0.6
    valid[:16, :128] = True
    valid[:16, 128:] = False
    return dict(wpos=wpos.astype(np.float32),
                normal=normal.astype(np.float32),
                dirs=dirs.astype(np.float32), valid=valid,
                sky=rng.random((3, 32, 64)).astype(np.float32),
                vol=_pad16(g.volume, 1e4), alb=_pad16(g.albedo, 0.5),
                origin=g.origin, voxel=g.voxel_size, sun=[0.3, -0.9, 0.3],
                steps=32, influence=7.5, coarse=True)


TRACE_CASES = {
    "box": _box_case,
    "wall_inside_window": lambda: _wall_case(4.0, 48, 3.5, False),
    "wall_outside_window": lambda: _wall_case(9.0, 48, 3.5, False),
    "coarse_fallback": lambda: _wall_case(9.0, 48, 12.0, True),
    "mixed_tiles": _mixed_case,
}


def _jax_window_bricks(case):
    """The JAX kernel's window origin per tile (sdfgi.py:139-158), with
    its jnp.sum tile reductions."""
    wpos, valid = jnp.asarray(case["wpos"]), jnp.asarray(case["valid"])
    _, h, w = wpos.shape
    d, hh, ww = case["vol"].shape
    out = []
    for ty in range(h // 16):
        for tx in range(w // 128):
            sl = (slice(ty * 16, ty * 16 + 16), slice(tx * 128, tx * 128 + 128))
            v = valid[sl]
            count = jnp.maximum(jnp.sum(v.astype(jnp.float32)), 1.0)
            b = []
            for k, n in enumerate((ww, hh, d)):
                c = (jnp.sum(jnp.where(v, wpos[k][sl], 0.0)) / count
                     - case["origin"][k]) / jnp.float32(case["voxel"])
                b.append(int(jnp.clip(jnp.floor((c - 8.0) / 16).astype(
                    jnp.int32), 0, max(n // 16 - 2, 0))))
            out.append(b)
    return np.asarray(out)


@pytest.mark.parametrize("name", list(TRACE_CASES))
def test_trace_plain_matches_jax(name):
    case = TRACE_CASES[name]()
    sky = case["sky"] - 10.0
    dims = case["vol"].shape
    kw = dict(steps=case["steps"], influence=case["influence"])
    sun = (np.asarray(case["sun"], np.float32), np.ones(3, np.float32),
           np.float32(10.0))
    jv = jgi.quantize_sdf_volume(jnp.asarray(case["vol"]), case["voxel"])
    ja = jgi.pack_albedo_volume(jnp.asarray(case["alb"]))
    jy, jc, je = jgi.trace_gi(
        jnp.asarray(case["wpos"]), jnp.asarray(case["normal"]),
        jnp.asarray(case["dirs"]), jnp.asarray(case["valid"]),
        jnp.asarray(sky), jv, ja, jnp.asarray(case["origin"]),
        case["voxel"], jnp.asarray(dims, jnp.float32),
        *(jnp.asarray(s) for s in sun),
        dims_zyx=dims if case["coarse"] else None, interpret=True, **kw)
    tv = tgi.quantize_sdf_volume(_t(case["vol"]), case["voxel"])
    ta = tgi.pack_albedo_volume(_t(case["alb"]))
    ty, tc, te = tgi.trace_gi(
        _t(case["wpos"]), _t(case["normal"]), _t(case["dirs"]),
        _t(case["valid"]), _t(sky), tv, ta, _t(case["origin"]),
        case["voxel"], dims, *(_t(s) for s in sun),
        dims_zyx=dims if case["coarse"] else None, **kw)
    j_out = np.concatenate([np.asarray(jy), np.asarray(jc)])
    t_out = torch.cat([ty, tc]).numpy()
    valid = case["valid"]
    assert np.isfinite(t_out).all()
    assert (t_out[:, ~valid] == 0).all() and (te.numpy()[~valid] == 0).all()
    esc_equal = (np.asarray(je) == te.numpy()).mean()
    hit_equal = ((j_out[0] >= 0) == (t_out[0] >= 0))[valid].mean()
    both = (np.asarray(je) == te.numpy()) & ((j_out[0] >= 0)
                                             == (t_out[0] >= 0))
    close = np.abs(t_out - j_out) <= 1e-4 + 1e-4 * np.abs(j_out)
    assert esc_equal >= 0.999, esc_equal
    assert hit_equal >= 0.999, hit_equal
    assert close[:, both].all(), np.abs(t_out - j_out)[:, both].max()
    # the share of tiles whose window origin differs from the JAX kernel's
    meta = tgi.trace_meta(_t(case["origin"]), case["voxel"],
                          case["influence"], *(_t(s) for s in sun))
    t_win = torch.stack(tgi.window_bricks(
        _t(case["wpos"]), _t(case["valid"]), meta, dims), dim=1).numpy()
    assert (t_win != _jax_window_bricks(case)).any(axis=1).mean() == 0.0
    if name == "mixed_tiles":  # both hits and misses, and escapes
        assert 0.05 < (t_out[0][valid] >= 0).mean() < 0.95
        assert te.numpy()[valid].mean() > 0.01


def test_trace_plain_loop_counts():
    """trace_plain's stats count the work the rays really do (the chip run
    turns them into kernel G's operation bound)."""
    case = _mixed_case()
    dims = case["vol"].shape
    tv = tgi.quantize_sdf_volume(_t(case["vol"]), case["voxel"])
    ta = tgi.pack_albedo_volume(_t(case["alb"]))
    c_sdf, c_alb, c_dims, c_f = tgi.build_coarse_tables(tv, ta, dims)
    meta = tgi.trace_meta(_t(case["origin"]), case["voxel"], 7.5,
                          _t(case["sun"]).float(), torch.ones(3),
                          torch.tensor(10.0))
    stats = {}
    out = tgi.trace_plain(
        _t(case["wpos"]), _t(case["normal"]), _t(case["dirs"]),
        _t(case["valid"]), _t(case["sky"]).reshape(3, -1) - 10.0, tv, ta,
        c_sdf, c_alb, meta, dims=dims, coarse_dims=c_dims, coarse_f=c_f,
        steps=32, strict=False, use_coarse=True, sky_h=32, sky_w=64,
        stats=stats)
    rays = int(case["valid"].sum())
    assert stats["rays"] == rays
    assert rays <= stats["fine_steps"] <= 32 * rays
    # a ray that hits in the window or, escaped, in the coarse volume
    # marches to the sun for 1-8 (coarse: 1-6) steps, up to its first
    # occluder; the sky, shifted by -10, makes a miss's Y negative
    hits = int((out[0] >= 0)[_t(case["valid"])].sum())
    shadow = stats["shadow_steps"] + stats["coarse_shadow_steps"]
    assert 0 < hits <= shadow <= 8 * hits
    escaped = int(out[6].sum())
    assert escaped <= stats["coarse_steps"] <= 24 * escaped


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------

def _filter_inputs(h=80, w=256, seed=5):
    rng = np.random.default_rng(seed)
    normal = np.stack([rng.normal(0, 0.2, (h, w)), -np.ones((h, w)),
                       rng.normal(0, 0.2, (h, w))])
    normal[:, :, w // 2:] = np.asarray([1.0, 0.0, 0.0])[:, None, None]
    normal /= np.linalg.norm(normal, axis=0)
    depth = rng.uniform(2.0, 2.6, (h, w))
    depth[h // 3:, :] += 4.0  # a depth edge
    ys, xs = np.mgrid[0:h, 0:w]
    wpos = np.stack([xs * 0.02, -depth * 0.3, ys * 0.02 + depth])
    return dict(y_sh=rng.normal(size=(4, h, w)).astype(np.float32),
                cocg=rng.normal(size=(2, h, w)).astype(np.float32) * 0.1,
                normal=normal.astype(np.float32),
                wpos=wpos.astype(np.float32),
                lin_depth=depth.astype(np.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_neighborhood_resolve_matches_jax():
    f = _filter_inputs()
    args = (f["y_sh"], f["cocg"], f["normal"], f["lin_depth"])
    jy, jc = jgi.neighborhood_resolve(*(jnp.asarray(a) for a in args))
    ty, tc = tgi.neighborhood_resolve(*(_t(a) for a in args))
    _close(ty, jy)
    _close(tc, jc)


@pytest.mark.parametrize("seed,radius", [(0, 1.5), (1, 1.0)])
def test_spatial_filter_matches_jax_all_rotations(seed, radius):
    """All 4 rotations, picked from a device frame index (index_select)
    on the port's side and by lax.switch on the JAX side."""
    f = _filter_inputs()
    args = (f["y_sh"], f["cocg"], f["normal"], f["wpos"], f["lin_depth"])
    for frame_index in (4, 5, 6, 7):
        jy, jc = jgi.spatial_filter(*(jnp.asarray(a) for a in args),
                                    jnp.asarray(frame_index, jnp.int32),
                                    radius, 280.0, seed=seed)
        ty, tc = tgi.spatial_filter(*(_t(a) for a in args),
                                    torch.tensor(frame_index,
                                                 dtype=torch.int32),
                                    radius, 280.0, seed=seed)
        _close(ty, jy)
        _close(tc, jc)


def test_temporal_filter_matches_jax():
    f = _filter_inputs()
    rng = np.random.default_rng(9)
    hist_y = (f["y_sh"] + rng.normal(0, 0.5, f["y_sh"].shape)) \
        .astype(np.float32)
    hist_c = (f["cocg"] + rng.normal(0, 0.05, f["cocg"].shape)) \
        .astype(np.float32)
    ok = rng.random(f["lin_depth"].shape) < 0.8
    motion = rng.uniform(0, 6, f["lin_depth"].shape).astype(np.float32)
    for cut in (False, True):
        args = (f["y_sh"], f["cocg"], hist_y, hist_c, ok, motion)
        jy, jc = jgi.temporal_filter_gi(*(jnp.asarray(a) for a in args),
                                        jnp.asarray(cut))
        ty, tc = tgi.temporal_filter_gi(*(_t(a) for a in args),
                                        torch.tensor(cut))
        _close(ty, jy)
        _close(tc, jc)


def test_upscale_matches_jax():
    """A depth edge at 128x256 from 64x128: nearest-depth texels on the
    edge, bilinear elsewhere."""
    f = _filter_inputs(64, 128)
    rng = np.random.default_rng(11)
    depth_full = rng.uniform(0.01, 0.02, (128, 256)).astype(np.float32)
    depth_full[50:, 100:] = 0.002
    depth_half = depth_full[::2, ::2].copy()
    args = (f["y_sh"], f["cocg"], depth_full, depth_half)
    jy, jc = jgi.upscale_half_to_full(*(jnp.asarray(a) for a in args),
                                      0.1, 300.0)
    ty, tc = tgi.upscale_half_to_full(*(_t(a) for a in args), 0.1, 300.0)
    _close(ty, jy)
    _close(tc, jc)


def test_upscale_keeps_the_padded_width_misregistration():
    """At 1080p the half-res planes are padded to 544x1024 and resized to
    1088x1920, so x scales by 1920/1024, not 2: full-res x = 1000 reads
    half-res x = 533.1, not 499.75. The port reproduces the reference
    (ROADMAP Queue 3)."""
    hh, hw, fh, fw = 544, 1024, 1088, 1920
    xs = np.broadcast_to(np.arange(hw, dtype=np.float32), (hh, hw))
    y_sh = np.stack([xs] * 4).astype(np.float32)
    cocg = np.stack([xs] * 2).astype(np.float32)
    depth_full = np.full((fh, fw), 0.01, np.float32)
    depth_half = np.full((hh, hw), 0.01, np.float32)
    args = (y_sh, cocg, depth_full, depth_half)
    jy, _ = jgi.upscale_half_to_full(*(jnp.asarray(a) for a in args),
                                     0.1, 300.0)
    ty, _ = tgi.upscale_half_to_full(*(_t(a) for a in args), 0.1, 300.0)
    _close(ty, jy)
    read = float(ty[0, 500, 1000])
    assert abs(read - ((1000 + 0.5) * hw / fw - 0.5)) < 1e-3
    assert abs(read - 499.75) > 30.0


def test_gi_helpers_match_jax():
    """The YCoCg transforms and SH-L1 helpers of the GI encode/decode and
    the cosine ray sampling (utils/color.py, sh.py, sampling.py),
    channel-last as the JAX package's; normals near the z axis take the
    other basis."""
    from plainrenderer_tpu.utils import color as jcolor, sh as jsh
    from plainrenderer_tpu.utils import sampling as jsampling
    from plainrenderer_tpu_torch.utils import color as tcolor, sh as tsh
    from plainrenderer_tpu_torch.utils import sampling as tsampling

    rng = np.random.default_rng(12)
    rgb = rng.random((64, 3)).astype(np.float32)
    ycocg = np.asarray(jcolor.linear_to_ycocg(jnp.asarray(rgb)))
    _close(tcolor.linear_to_ycocg(_t(rgb)), ycocg, 1e-6)
    _close(tcolor.ycocg_to_linear(_t(ycocg)),
           jcolor.ycocg_to_linear(jnp.asarray(ycocg)), 1e-6)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sh = tsh.direction_to_sh_l1(_t(dirs))
    _close(sh, jsh.direction_to_sh_l1(jnp.asarray(dirs)), 1e-6)
    _close(tsh.dominant_direction_from_sh_l1(sh),
           jsh.dominant_direction_from_sh_l1(jnp.asarray(sh.numpy())), 1e-6)
    dirs[:4] = [[0, 0, 1], [0, 0, -1], [0.01, 0, 0.99995], [1, 0, 0]]
    xi = rng.random((64, 2)).astype(np.float32)
    _close(tsampling.importance_sample_cosine(_t(xi), _t(dirs)),
           jsampling.importance_sample_cosine(jnp.asarray(xi),
                                              jnp.asarray(dirs)), 1e-5)
