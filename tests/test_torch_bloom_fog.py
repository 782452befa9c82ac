"""The port's bloom and froxel fog against the JAX package.

Bloom: each bf16 stencil of the pyramid bit for bit (both round every op
to bf16), the whole compute_bloom within one f32 ulp (XLA fuses the final
lerp into an FMA). Fog, on a 64x32x16 froxel grid: the hash bit for bit;
the gradient noise bit for bit with XLA's rsqrt replaced by 1/sqrt, and
within 4 ulp with it (XLA:CPU's rsqrt is not correctly rounded, torch's
is); every other stage and the 3-frame chain with the tolerance its test
states."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu import config as jcfg
from plainrenderer_tpu.ops import bloom as jbloom
from plainrenderer_tpu.ops import volumetrics as jvol
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch.ops import bloom as tbloom
from plainrenderer_tpu_torch.ops import volumetrics as tvol

torch.set_num_threads(1)

GRID = (64, 32, 16)  # froxels (x, y, slices)
COARSE = (16, 8, 4)
TAN_HALF = math.tan(math.radians(35.0) * 0.5)
MAX_DIST = 30.0


def _t(a):
    return torch.as_tensor(np.array(a))


def _hdr(rng, shape):
    return (rng.random(shape) ** 4 * 20.0).astype(np.float32)


@pytest.mark.parametrize("stage", ["down", "tent", "box"])
def test_bloom_stencils_bit_exact(stage):
    rng = np.random.default_rng(1)
    x = _hdr(rng, (3, 64, 128))
    j_fn, t_fn = {
        "down": (jbloom.downsample_13tap, tbloom.downsample_13tap),
        "tent": (lambda s: jbloom.tent9(s, 1.5),
                 lambda s: tbloom.tent9(s, 1.5)),
        "box": (lambda s: jbloom._box_upsample(s, 127, 256),
                lambda s: tbloom._box_upsample(s, 127, 256))}[stage]
    want = jax.jit(j_fn)(jnp.asarray(x).astype(jnp.bfloat16))
    got = t_fn(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_compute_bloom_matches_jax():
    """128x256 with the default 6 mips and blur radius 1.5: within one f32
    ulp of the JAX package's jitted bloom."""
    rng = np.random.default_rng(2)
    color = _hdr(rng, (3, 128, 256))
    bs = tcfg.BloomSettings()
    want = np.asarray(jax.jit(functools.partial(
        jbloom.compute_bloom, strength=bs.strength,
        blur_radius=bs.blur_radius, mip_count=bs.mip_count))(
            jnp.asarray(color)))
    got = tbloom.compute_bloom(_t(color), bs.strength, bs.blur_radius,
                               bs.mip_count).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    assert np.abs(got - color).max() > 1e-3  # the bloom does something


def test_hash_and_noise_bit_exact(monkeypatch):
    rng = np.random.default_rng(3)
    ix, iy, iz = (rng.integers(-2 ** 31, 2 ** 31, 20000).astype(np.int32)
                  for _ in range(3))
    want = np.asarray(jvol._hash3(jnp.asarray(ix), jnp.asarray(iy),
                                  jnp.asarray(iz))).astype(np.int64)
    np.testing.assert_array_equal(
        tvol._hash3(_t(ix), _t(iy), _t(iz)).numpy(), want)
    p = (rng.normal(size=(3, 16, 32, 64)) * 20.0).astype(np.float32)
    got = tvol.analytic_perlin_3d_planar(*map(_t, p)).numpy()
    approx = np.asarray(jvol.analytic_perlin_3d_planar(*map(jnp.asarray, p)))
    ulps = np.abs(got.view(np.int32) - approx.view(np.int32))
    assert ulps.max() <= 4, ulps.max()
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    exact = np.asarray(jvol.analytic_perlin_3d_planar(*map(jnp.asarray, p)))
    np.testing.assert_array_equal(got, exact)
    assert 0.2 < got.std() * 4 < 2.0  # noise, not a constant


def _cam(i=0):
    fwd = np.asarray([0.9, 0.1 + 0.01 * i, 0.4], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, -1.0, 0.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd).astype(np.float32)
    pos = np.asarray([0.3 + 0.05 * i, -1.7, 0.2], np.float32)
    return dict(position=pos, forward=fwd, right=right, up=up)


def _cams(i=0):
    c = _cam(i)
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: _t(v) for k, v in c.items()})


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_froxel_stages_match_jax():
    """Positions within 4e-6 relative; material within 2e-6 relative of its
    largest value (the noise's ulps, scaled by the density); the coarse
    shadow's trilinear upsample equal; scattering within 1e-6 relative;
    integration within 1e-4 relative (a cumsum in another order and
    exp of its sums); the per-pixel apply within 1e-6."""
    rng = np.random.default_rng(4)
    jc, tc = _cams()
    vs = tcfg.VolumetricsSettings()
    jpos = jvol.froxel_world_positions(GRID, jc, TAN_HALF, 2.0, MAX_DIST)
    tpos = tvol.froxel_world_positions(GRID, tc, TAN_HALF, 2.0, MAX_DIST)
    _close(tpos, jpos, rtol=4e-6, atol=1e-6)
    wind = np.asarray([0.01, 0.0, 0.02], np.float32)
    jmat = jvol.material_volume(jpos, vs, jnp.asarray(wind))
    tmat = tvol.material_volume(_t(np.asarray(jpos)), vs, _t(wind))
    _close(tmat, jmat, rtol=0, atol=2e-6 * float(np.abs(jmat).max()))
    shadow_c = (rng.random(COARSE[::-1]) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tvol._resize_coarse(_t(shadow_c), GRID[::-1]).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(shadow_c), GRID[::-1],
                                    "trilinear")))
    sun = np.asarray([0.3, -0.8, 0.5], np.float32)
    sun /= np.linalg.norm(sun)
    jscat = jvol.light_scattering(
        jmat, jpos, jnp.asarray(shadow_c), jc, jnp.asarray(sun),
        jnp.asarray([1.0, 0.9, 0.8]), jnp.asarray(3.0), vs.phase_g,
        ambient=vs.ambient)
    tscat = tvol.light_scattering(
        _t(np.asarray(jmat)), _t(np.asarray(jpos)), _t(shadow_c), tc,
        _t(sun), _t([1.0, 0.9, 0.8]), _t(3.0), vs.phase_g,
        ambient=vs.ambient)
    _close(tscat, jscat, rtol=1e-6, atol=1e-12)
    jint = jvol.integrate_froxels(jscat, MAX_DIST)
    tint = tvol.integrate_froxels(_t(np.asarray(jscat)), MAX_DIST)
    _close(tint, jint, rtol=1e-4, atol=1e-9)
    color = _hdr(rng, (3, 128, 256))
    depth = (rng.random((128, 256)) * 40.0).astype(np.float32)
    noise = rng.random((128, 256)).astype(np.float32)
    _close(tvol.apply_froxel_fog(_t(color), _t(depth), _t(np.asarray(jint)),
                                 MAX_DIST, _t(noise)),
           jvol.apply_froxel_fog(jnp.asarray(color), jnp.asarray(depth), jint,
                                 MAX_DIST, jnp.asarray(noise)),
           rtol=1e-6, atol=1e-7)


def test_fog_chain_three_frames_matches_jax():
    """Material -> scattering -> reprojection against the carried
    volumetric history -> integration -> apply, 3 frames with a moving
    camera (frame 0 a camera cut), each side carrying its own history:
    the history and the fogged color within 1e-4 relative every frame."""
    rng = np.random.default_rng(5)
    vs = jcfg.VolumetricsSettings()
    shape = (4,) + GRID[::-1]
    j_hist, t_hist = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    pvp = np.eye(4, dtype=np.float32)
    sun = np.asarray([0.3, -0.8, 0.5], np.float32)
    sun /= np.linalg.norm(sun)
    for i in range(3):
        jc, tc = _cams(i)
        wind = np.asarray([0.01 * i, 0.0, 0.02 * i], np.float32)
        shadow_c = (rng.random(COARSE[::-1]) > 0.3).astype(np.float32)
        color = _hdr(rng, (3, 128, 256))
        depth = (rng.random((128, 256)) * 40.0).astype(np.float32)
        noise = rng.random((128, 256)).astype(np.float32)
        outs = []
        for m, c, hist, arr in ((jvol, jc, j_hist, jnp.asarray),
                                (tvol, tc, t_hist, _t)):
            pos = m.froxel_world_positions(GRID, c, TAN_HALF, 2.0, MAX_DIST)
            cpos = m.froxel_world_positions(COARSE, c, TAN_HALF, 2.0,
                                            MAX_DIST)
            mat = m.material_volume(pos, vs, arr(wind))
            scat = m.light_scattering(mat, pos, arr(shadow_c), c, arr(sun),
                                      arr([1.0, 0.9, 0.8]), arr(3.0),
                                      vs.phase_g, ambient=vs.ambient)
            scat = m.temporal_reprojection(
                scat, hist, cpos, arr(pvp), c["position"] - 0.05,
                c["forward"], MAX_DIST, arr(i == 0))
            outs.append((scat, m.apply_froxel_fog(
                arr(color), arr(depth), m.integrate_froxels(scat, MAX_DIST),
                MAX_DIST, arr(noise))))
        (j_hist, j_out), (t_hist, t_out) = outs
        _close(t_hist, j_hist, rtol=1e-4, atol=1e-9)
        _close(t_out, j_out, rtol=1e-4, atol=1e-7)
        cam = _cam(i)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = np.stack([cam["right"], cam["up"], -cam["forward"]])
        view[:3, 3] = -view[:3, :3] @ cam["position"]
        proj = np.zeros((4, 4), np.float32)
        proj[0, 0], proj[1, 1] = 1.0 / (2.0 * TAN_HALF), -1.0 / TAN_HALF
        proj[2, 2], proj[2, 3], proj[3, 2] = 0.0, 0.1, -1.0
        pvp = (proj @ view).astype(np.float32)
    assert float(t_hist[3].mean()) > 0 and float(t_hist[:3].mean()) > 0
