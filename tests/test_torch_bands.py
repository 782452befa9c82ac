"""Split-frame band mode of the port on gloo CPU ranks.

Op level, on 2 and 3 ranks (3 gives a band with two real halos), each
against the JAX function under shard_map on conftest's virtual CPU
devices (plain XLA, or interpret mode where a Pallas kernel runs):
halo_extend bit for bit; compute_bloom_banded within one f32 ulp of the
JAX package's banded bloom and bit for bit equal to the port's
single-device compute_bloom on the whole frame; the fog's band upsamples
with their halo row; the froxel band grid, banded view directions and
the dither's row offset; the atlas band slice and build_pairs with
view_row0 on bands that cross a cascade boundary, pair lists exact. The
slice as a whole, no JAX: the port's 2-band frame against its
single-device frame at tests/test_parallel.py's four settings by that
file's rule for each, and a 3-band frame likewise. Every launch of ranks
has a timeout, and a failed or hung rank makes it raise."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_band_ranks
from plainrenderer_tpu.ops import bloom as jbloom
from plainrenderer_tpu.ops import post as jpost
from plainrenderer_tpu.ops import raster as jr
from plainrenderer_tpu.ops import sky as jsky
from plainrenderer_tpu.ops import volumetrics as jvol
from plainrenderer_tpu.parallel import halo as jhalo
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch.assets import procedural as tproc
from plainrenderer_tpu_torch.ops import bloom as tbloom
from plainrenderer_tpu_torch.ops import post as tpost
from plainrenderer_tpu_torch.ops import raster as tr
from plainrenderer_tpu_torch.ops import sdf_scene as tsdf
from plainrenderer_tpu_torch.ops import sky as tsky
from plainrenderer_tpu_torch.ops import volumetrics as tvol
from plainrenderer_tpu_torch.parallel import comm, sharding
from plainrenderer_tpu_torch.render import frame as tframe
from plainrenderer_tpu_torch.render import scenebuild as tsb
from plainrenderer_tpu_torch.render.state import initial_state
from plainrenderer_tpu_torch.scene import camera as tcam

torch.set_num_threads(1)

AXIS = "bands"
TAN_HALF = math.tan(math.radians(35.0) * 0.5)
MAX_DIST = 30.0
FRAME_H, FRAME_W = 96, 128  # op-level frames: 48- and 32-row bands
FINE = (16, 12, 16)  # fog grid (D, Hf, Wf) of the op-level frame
LAUNCH = dict(device="cpu", timeout=240.0, pg_timeout=120.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _bands(x: np.ndarray, n: int) -> np.ndarray:
    """(..., H, W) -> (n, ..., H / n, W): the bands stacked."""
    bh = x.shape[-2] // n
    return np.stack([x[..., r * bh:(r + 1) * bh, :] for r in range(n)])


def _jax_bands(fn, n: int, *frames):
    """fn on every band of the frame-sized arrays under shard_map over n
    virtual devices; (n, ...) stacked results as numpy."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), (AXIS,))
    run = shard_map(lambda *xs: fn(*[x[0] for x in xs])[None], mesh=mesh,
                    in_specs=tuple(P(AXIS) for _ in frames),
                    out_specs=P(AXIS), check_vma=False)
    return np.asarray(jax.jit(run)(*[jnp.asarray(_bands(f, n))
                                     for f in frames]))


def _cases():
    """The op-level inputs, frame-sized, from one seed."""
    rng = np.random.default_rng(15)
    hdr = (rng.random((3, FRAME_H, FRAME_W)) ** 4 * 20.0).astype(np.float32)
    d, hf, wf = FINE
    return {
        "halo": [
            (hdr, 16, torch.float32),
            (rng.integers(-2 ** 31, 2 ** 31, (FRAME_H, FRAME_W),
                          dtype=np.int64).astype(np.int32), 48, torch.int32),
            (hdr[:2], 8, torch.bfloat16)],
        "bloom": (hdr, 0.02, 1.5, 6),
        "resize": ((rng.random((4, d // 4, 6, wf // 4)) > 0.5).astype(
            np.float32), FINE),
        "fog": (hdr, (rng.random((FRAME_H, FRAME_W)) * 40.0).astype(
            np.float32), (rng.random((4, d, hf, wf)) * 2.0).astype(
            np.float32), rng.random((FRAME_H, FRAME_W)).astype(np.float32),
            MAX_DIST)}


_RUNS = {}


def _band_ops(n: int):
    """The rank results of torch_band_ranks.band_ops on n gloo CPU ranks,
    one launch per n for every op-level test."""
    if n not in _RUNS:
        _RUNS[n] = comm.launch(torch_band_ranks.band_ops, n,
                               args=(_cases(),), **LAUNCH)
    return _RUNS[n]


@pytest.mark.parametrize("n", [2, 3])
def test_halo_extend_bit_equal_to_jax(n):
    """Interior borders carry the neighbour's rows, the frame's top and
    bottom edge-replicate, n clamps to the band height (48 > 32 rows at 3
    bands); f32, int32 and bf16 (gloo carries its bits as int32). The
    ranks load neither JAX nor the JAX package and talk over gloo."""
    runs = _band_ops(n)
    for r in runs:
        assert r["forbidden"] == [] and r["transport"] == "gloo"
    for i, (x, k, dtype) in enumerate(_cases()["halo"]):
        if dtype == torch.bfloat16:
            want = _jax_bands(lambda b: jhalo.halo_extend(
                b.astype(jnp.bfloat16), k, AXIS, n).astype(jnp.float32),
                n, x)
        else:
            want = _jax_bands(lambda b: jhalo.halo_extend(b, k, AXIS, n), n,
                              x)
        for r in range(n):
            got = runs[r]["halo"][i]
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.float().numpy()
                                          if dtype == torch.bfloat16
                                          else got.numpy(), want[r])


@pytest.mark.parametrize("n", [2, 3])
def test_bloom_banded_matches_jax_and_single_device(n):
    """compute_bloom_banded (6 mips, 8-row halo, mip 2 gathered): within
    one f32 ulp of the JAX package's banded bloom (XLA fuses the final
    lerp into an FMA, as for compute_bloom). Its bands put together are
    the same bit for bit at 2 and 3 bands, but not the single-device
    compute_bloom's, as the JAX package's are not either (same rows, same
    values, measured): the frame's outermost mip-1 rows come from
    edge-replicated halo rows instead of the clamped mip 1, and mips 3-5
    carry that to most rows. Rule found: |banded - single| within 10% of
    the bloom's largest effect |single - color| and its mean within 1% of
    the effect's mean (measured 7% and 0.22%)."""
    color, strength, radius, mips = _cases()["bloom"]
    want = _jax_bands(lambda c: jbloom.compute_bloom_banded(
        c, strength, radius, mips, AXIS, n,
        lambda p, k: jhalo.halo_extend(p, k, AXIS, n)), n, color)
    got = np.stack([r["bloom"].numpy() for r in _band_ops(n)])
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    frame = np.concatenate(list(got), axis=-2)
    other = np.concatenate([r["bloom"].numpy() for r in _band_ops(5 - n)],
                           axis=-2)
    np.testing.assert_array_equal(frame, other)
    whole = tbloom.compute_bloom(_t(color), strength, radius, mips).numpy()
    effect, diff = np.abs(whole - color), np.abs(frame - whole)
    assert diff.max() <= 0.1 * effect.max()
    assert diff.mean() <= 0.01 * effect.mean()
    assert effect.max() > 1e-3 and (diff == 0).any()


@pytest.mark.parametrize("n", [2, 3])
def test_fog_band_upsamples_match_jax(n):
    """The coarse-to-fine trilinear upsample with one halo row from the
    neighbours (light_scattering's and temporal_reprojection's) equal to
    the JAX package's; the quarter-resolution fog apply with its halo row
    within 1e-6 relative, as the single-device apply
    (test_torch_bloom_fog.py)."""
    runs = _band_ops(n)
    coarse, fine = _cases()["resize"]
    d, hf, wf = fine
    want = _jax_bands(lambda x: jvol._resize_coarse(
        x, (d, hf // n, wf), lambda p: jhalo.halo_extend(p, 1, AXIS, n)),
        n, coarse)
    for r in range(n):
        np.testing.assert_array_equal(runs[r]["resize"].numpy(), want[r])
    hdr, depth, integ, noise, max_dist = _cases()["fog"]
    want = _jax_bands(lambda c, z, f, u: jvol.apply_froxel_fog(
        c, z, f, max_dist, u,
        halo_fn=lambda p: jhalo.halo_extend(p, 1, AXIS, n)),
        n, hdr, depth, integ, noise)
    for r in range(n):
        np.testing.assert_allclose(runs[r]["fog"].numpy(), want[r],
                                   rtol=1e-6, atol=1e-7)


def _band_cams(n: int):
    """One camera with each band's sub-frustum leaves, for both
    packages (sharding.band_camera; the JAX package's per_band)."""
    ext = tcam.extrinsic_from_angles([0.3, -1.7, 0.2], pitch_deg=5.0,
                                     yaw_deg=20.0)
    base = {k: np.asarray(getattr(ext, k), np.float32)
            for k in ("position", "forward", "right", "up")}
    out = []
    for r in range(n):
        t = sharding.band_camera({k: _t(v) for k, v in base.items()}, r, n)
        nf = float(n)
        centre = (jnp.float32(r) + 0.5) / nf * 2.0 - 1.0
        j = dict({k: jnp.asarray(v) for k, v in base.items()},
                 ndc_y_scale=jnp.asarray(nf, jnp.float32),
                 ndc_y_offset=-centre * nf)
        out.append((j, t))
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_band_grids_view_directions_and_dither_rows_match_jax(n):
    """The froxel band grid (global-row order) bit for bit the port's
    single-device grid's rows, and within test_torch_bloom_fog.py's
    single-device tolerance of the JAX package's band grid; the band's view
    directions (its NDC y mapped into the frame) within 2e-7; the band
    camera's leaves equal the JAX package's; tonemap_pass(row_offset)
    bit for bit."""
    wf, hf, d = 16, 12 * n, 8
    aspect = 2.0
    cams = _band_cams(n)
    plain_cam = {k: v for k, v in cams[0][1].items()
                 if not k.startswith("ndc")}
    single = tvol.froxel_world_positions((wf, hf, d), plain_cam, TAN_HALF,
                                         aspect, MAX_DIST).numpy()
    rng = np.random.default_rng(5)
    for r, (jc, tc) in enumerate(cams):
        for key in ("ndc_y_scale", "ndc_y_offset"):
            assert tc[key].shape == () and float(tc[key]) == float(jc[key])
        want = np.asarray(jvol.froxel_world_positions(
            (wf, hf // n, d), jc, TAN_HALF, aspect, MAX_DIST))
        got = tvol.froxel_world_positions((wf, hf // n, d), tc, TAN_HALF,
                                          aspect, MAX_DIST).numpy()
        np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-6)
        np.testing.assert_array_equal(
            got, single[:, :, r * hf // n:(r + 1) * hf // n])
        want = np.asarray(jsky.view_directions(
            128, 32, jc["forward"], jc["up"], jc["right"], TAN_HALF, aspect,
            ndc_y_scale=jc["ndc_y_scale"], ndc_y_offset=jc["ndc_y_offset"]))
        got = tsky.view_directions(
            128, 32, tc["forward"], tc["up"], tc["right"], TAN_HALF, aspect,
            ndc_y_scale=tc["ndc_y_scale"],
            ndc_y_offset=tc["ndc_y_offset"]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        hdr = (rng.random((3, 32, 128)) * 4.0).astype(np.float32)
        np.testing.assert_array_equal(
            tpost.tonemap_pass(_t(hdr), _t(np.float32(0.048)),
                               row_offset=32 * r).numpy(),
            np.asarray(jpost.tonemap_pass(jnp.asarray(hdr),
                                          jnp.float32(0.048),
                                          row_offset=32 * r)))


@pytest.fixture(scope="module")
def atlas_setup():
    """The small atrium's atlas of 3 cascades of 256-px maps (2 x 2 bins
    of 128 px each: 6 bin rows), set up by the JAX package from its
    cascade fit and carried over (test_torch_shadow.py's atlas case)."""
    import test_torch_shadow as ts

    rs = ts.jsb.build_render_scene(ts.jproc.build_atrium_scene(
        ts.jproc.AtriumConfig(**ts.SMALL_ATRIUM), textured=False))
    j_scene = jframe.scene_to_device(rs)
    mats = ts._jax_fit()[0]
    t_count = rs.corners.shape[0]
    j_setup = jframe.shadow_atlas_setup(
        j_scene, j_scene["corners"], j_scene["corner_normals"],
        j_scene["corner_tangents"], j_scene["corner_bitangents"],
        j_scene["object_bb_min"], j_scene["object_bb_max"], mats, ts.N_CAS,
        ts.SRES, None, t_count)
    t_setup = tr.TriangleSetup(**{
        k: _t(getattr(j_setup, k))
        for k in ("edges", "attrs", "tile_bbox", "valid", "fine_y")})
    sub = tframe.shadow_bin_sub(ts.SRES)
    return j_setup, t_setup, t_count, ts.N_CAS, ts.SRES, sub


@pytest.mark.parametrize("n", [2, 4])
def test_atlas_band_slice_and_band_pairs_match_jax(atlas_setup, n):
    """_atlas_band_slice: valid flags, bin and fine-row bboxes equal; edge
    planes within 1 ulp of the largest coefficient of their plane (the
    rebase c + b * y0 rounds once; XLA may contract it into an FMA, which
    rounds once too but not always alike). build_pairs(view_row0=...) on
    the JAX slice: pair stream, starts, counts and overflow equal to the
    JAX package's (kernel A in interpret mode). The 6 bin rows (2 per
    cascade) in 2 bands of 3 rows cross a cascade boundary; in 4 bands
    of 2 (ceil) the last band is all padding, cut after the gather. The
    port's bands, rasterized and put together, meet its whole-atlas
    raster by tests/test_shadow_sharding.py's rule: coverage equal but
    for < 1e-3 of texels (edge flips from the rebase), depths within
    1e-5 where both cover."""
    j_setup, t_setup, t_count, n_cas, sres, sub = atlas_setup
    s_nty, ntx = sres // (16 * sub), sres // 128
    nb = n_cas * s_nty
    nb_d = -(-nb // n)
    budget = (n_cas * t_count) // (6 * max(n // 2, 1)) + 4 * nb_d * sub * ntx
    whole_pairs = tr.build_pairs(t_setup, nb, ntx, pair_budget=budget * n,
                                 bin_rows=sub, order_rows=True,
                                 n_views=n_cas, tile_cap=1 << 15)
    whole_edges, _ = tr.gather_pair_setups(t_setup, whole_pairs,
                                           row_extents=True,
                                           with_attrs=False)
    whole = tr.rasterize_depth(whole_edges, whole_pairs, nb, ntx, sub=sub,
                               row_skip=True).numpy()
    bands, crossing = [], 0
    for r in range(n):
        row0 = r * nb_d
        crossing += (row0 // s_nty) != ((row0 + nb_d - 1) // s_nty)
        js = jframe._atlas_band_slice(j_setup, jnp.asarray(row0, jnp.int32),
                                      nb_d, sub)
        ts_ = tframe._atlas_band_slice(t_setup, row0, nb_d, sub)
        for k in ("valid", "tile_bbox", "fine_y"):
            np.testing.assert_array_equal(getattr(ts_, k).numpy(),
                                          np.asarray(getattr(js, k)), k)
        je, te = np.asarray(js.edges), ts_.edges.numpy()
        scale = np.abs(je).max(axis=0, keepdims=True)
        assert (np.abs(te - je) <= np.spacing(scale)).all()
        jp = jr.build_pairs(js, nb_d, ntx, n_views=n_cas, tile_cap=1 << 15,
                            bin_rows=sub, order_rows=True,
                            pair_budget=budget,
                            view_row0=jnp.asarray(row0, jnp.int32),
                            rows_per_view=s_nty, interpret=True)
        j_as_t = tr.TriangleSetup(**{
            k: _t(getattr(js, k))
            for k in ("edges", "attrs", "tile_bbox", "valid", "fine_y")})
        tp = tr.build_pairs(j_as_t, nb_d, ntx, pair_budget=budget,
                            bin_rows=sub, order_rows=True, n_views=n_cas,
                            tile_cap=1 << 15, view_row0=row0,
                            rows_per_view=s_nty)
        for k in ("pair_tri", "tile_start", "tile_count", "overflow"):
            np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                          np.asarray(getattr(jp, k)), k)
        assert int(tp.overflow) == 0
        tp = tr.build_pairs(ts_, nb_d, ntx, pair_budget=budget,
                            bin_rows=sub, order_rows=True, n_views=n_cas,
                            tile_cap=1 << 15, view_row0=row0,
                            rows_per_view=s_nty)
        edges, _ = tr.gather_pair_setups(ts_, tp, row_extents=True,
                                         with_attrs=False)
        bands.append(tr.rasterize_depth(edges, tp, nb_d, ntx, sub=sub,
                                        row_skip=True).numpy())
    assert crossing > 0 or n == 4
    band_atlas = np.concatenate(bands)[:nb * sub * 16]
    assert ((band_atlas > 0) != (whole > 0)).mean() < 1e-3
    both = (band_atlas > 0) & (whole > 0)
    assert np.abs(band_atlas - whole)[both].max() < 1e-5
    assert (whole > 0).mean() > 0.05


def test_launcher_raises_on_a_failed_or_hung_rank():
    """A rank that raises makes launch() raise with its traceback; ranks
    still running at the timeout are killed and launch() raises
    TimeoutError instead of waiting for them."""
    import time

    with pytest.raises(Exception) as err:
        comm.launch(torch_band_ranks.fail_on_rank_1, 2, **LAUNCH)
    assert "rank 1 fails on purpose" in str(err.value) \
        or "ProcessRaisedException" in type(err.value).__name__
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        comm.launch(torch_band_ranks.hang_on_rank_1, 2, args=(120.0,),
                    device="cpu", timeout=8.0, pg_timeout=120.0)
    assert time.monotonic() - t0 < 30.0


# ------------------------------ whole frames ------------------------------

SMALL_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                    box_subdiv=1, column_segments=8)


def _settings(kind: str, height: int):
    """tests/test_parallel.py's four settings at 128 x height."""
    base = dict(width=128, height=height, exposure_adaption_speed=1000.0,
                shadows=tcfg.ShadowSettings(resolution=512))
    no_gi = tcfg.SDFTraceSettings(enabled=False)
    no_fog = tcfg.VolumetricsSettings(enabled=False)
    return {
        "full_stack": tcfg.RenderSettings(sdf_trace=no_gi, volumetrics=no_fog,
                                          **base),
        "fog": tcfg.RenderSettings(sdf_trace=no_gi,
                                   taa=tcfg.TAASettings(enabled=False),
                                   bloom=tcfg.BloomSettings(enabled=False),
                                   **base),
        "alpha": tcfg.RenderSettings(sdf_trace=no_gi, volumetrics=no_fog,
                                     **base),
        "gi": tcfg.RenderSettings(
            sdf_trace=tcfg.SDFTraceSettings(enabled=True, trace_steps=8),
            **base)}[kind]


def _scene(kind: str) -> dict:
    """test_parallel.py's scene for each setting, built by the port on
    the CPU: the small untextured atrium; the banner atrium (textured,
    alpha-tested); the small textured atrium with its scene SDF baked at
    16^3 per mesh."""
    if kind == "alpha":
        cfg = tproc.AtriumConfig(columns_per_row=2, floor_subdiv=2,
                                 box_count=2, box_subdiv=1,
                                 column_segments=8, banner_count=2)
        return tframe.scene_to_device(tsb.build_render_scene(
            tproc.build_atrium_scene(cfg)), device="cpu")
    if kind == "gi":
        data = tproc.build_atrium_scene(tproc.AtriumConfig(**SMALL_ATRIUM))
        rs = tsb.build_render_scene(data)
        scene = tframe.scene_to_device(rs, device="cpu")
        return tframe.attach_global_sdf(scene, tsdf.build_scene_sdf(
            rs, data, bake_resolution_cap=16, device="cpu"))
    return tframe.scene_to_device(tsb.build_render_scene(
        tproc.build_atrium_scene(tproc.AtriumConfig(**SMALL_ATRIUM),
                                 textured=False)), device="cpu")


def _camera():
    ext = tcam.extrinsic_from_angles([0.0, -1.7, 0.0], pitch_deg=5.0,
                                     yaw_deg=20.0)
    return tframe.camera_arrays(ext.position, ext.forward, ext.right,
                                ext.up, device="cpu")


def _band_vs_single(kind: str, n: int, frames: int = 2, band_h: int = 64):
    """`frames` frames on one device and on n gloo ranks (band_settings
    of the same frame): both u8 images and every rank's counters."""
    settings = _settings(kind, band_h * n)
    scene, cam = _scene(kind), _camera()
    luts = tframe.bake_static_luts(settings, device="cpu")
    state = initial_state(settings.width, settings.height, device="cpu")
    for _ in range(frames):
        single, state = tframe.render_frame(state, scene, cam, luts,
                                            1.0 / 60.0, settings,
                                            device="cpu")
    assert state.debug_counters.tolist() == [0, 0]
    runs = comm.launch(sharding.render_bands, n,
                       args=(settings, scene, cam, luts, frames), **LAUNCH)
    for r in runs:
        assert (r["debug_counters"] == 0).all()
    bands = sharding.assemble_image(torch.stack([r["image"] for r in runs]))
    return single.numpy(), bands, runs


# test_parallel.py's rule per setting: (share within 2 LSB, share of the
# seam rows within 2 LSB, share above 12 LSB or None), with its reasons
RULES = {"full_stack": (0.995, 0.99, None), "alpha": (0.995, 0.99, None),
         "fog": (0.97, 0.97, 5e-3), "gi": (0.965, 0.97, None)}


def _check(kind: str, a: np.ndarray, b: np.ndarray, n: int):
    assert a.shape == b.shape == (64 * n, 128, 3)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    within, seam_within, above12 = RULES[kind]
    assert (diff <= 2).mean() > within, (diff <= 2).mean()
    for s in range(1, n):
        seam = diff[64 * s - 1:64 * s + 1]
        assert (seam <= 2).mean() > seam_within, (s, (seam <= 2).mean())
    if above12 is not None:
        assert (diff > 12).mean() < above12, (diff > 12).mean()
    assert a.std() > 3


@pytest.mark.parametrize("kind", ["full_stack", "fog", "alpha", "gi"])
def test_two_band_frame_matches_single_device(kind):
    """2 frames of 2 bands of 64 rows against the port's single-device
    frame at test_parallel.py's settings, by that file's rule: the band
    sub-frustum moves edge functions by ulps (isolated pixels at triangle
    edges), the fog's coarse grid rounds per band and the GI history's
    reprojection shifts its bilinear weights by epsilon."""
    single, bands, _ = _band_vs_single(kind, 2)
    _check(kind, single, bands, 2)


def test_three_band_frame_matches_single_device():
    """3 bands of 64 rows (the middle band has two real halos) with GI,
    fog, TAA, bloom and the banded atlas, against the single-device
    frame by test_parallel.py's GI rule."""
    single, bands, runs = _band_vs_single("gi", 3)
    _check("gi", single, bands, 3)
    exposure = {float(r["state"].exposure) for r in runs}
    assert len(exposure) == 1  # one histogram for the frame


def test_band_heights_off_the_32_row_grid_do_not_tile_the_frame():
    """The bands tile the single-device frame only where the band height
    is a multiple of 32 rows, the JAX package's band semantics (kept):
    at 2 bands of 144 rows the GI's half-resolution band of 72 rows pads
    to 80 (the halo then carries padding rows and the upscale stretches
    80 rows over 144), and the fog's coarse grid has 4 rows per band
    where the frame has 9. The GI settings' frame then misses
    test_parallel.py's rule by far (0.709 of pixels within 2 LSB when
    measured, the rule > 0.965). This is why chip_smoke.py's band row
    runs at 1920x1024 (256-row bands), not 1920x1088 (272)."""
    single, bands, _ = _band_vs_single("gi", 2, band_h=144)
    diff = np.abs(single.astype(np.int32) - bands.astype(np.int32))
    assert (diff <= 2).mean() < 0.9, (diff <= 2).mean()
