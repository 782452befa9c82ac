"""The port's shading-chain passes against the JAX package, on the CPU.

Each test states its tolerance and why. Where a test compares a jitted
JAX function, note that XLA fuses multiply-adds into FMAs under jit
(measured here: 21% of jitted 3-term float32 dot products differ in the
last bit from the sequential sum that eager JAX and PyTorch both compute),
so a value built from cancelling terms differs by more than its own
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import exposure as jexp
from plainrenderer_tpu.ops import post as jpost
from plainrenderer_tpu.ops import shade as jshade
from plainrenderer_tpu.ops import sky as jsky
from plainrenderer_tpu_torch import config as tcfg
from plainrenderer_tpu_torch.ops import exposure as texp
from plainrenderer_tpu_torch.ops import post as tpost
from plainrenderer_tpu_torch.ops import shade as tshade
from plainrenderer_tpu_torch.ops import sky as tsky

torch.set_num_threads(1)


def _unit(v, axis=0):
    return (v / np.linalg.norm(v, axis=axis, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n_mat", [45, 130])
def test_material_lookup_exact(n_mat):
    """Kernel C's plain version (45 materials, tiled frame) and the
    select-sum path (130 > 128 materials): exact, as both sides only copy
    table entries."""
    rng = np.random.default_rng(0)
    h, w = 32, 256
    table = rng.random((n_mat, 8)).astype(np.float32)
    ids = rng.integers(0, n_mat, (h, w)).astype(np.float32)
    valid = rng.random((h, w)) > 0.3
    a = np.asarray(jpost.material_lookup(jnp.asarray(table), jnp.asarray(ids),
                                         jnp.asarray(valid), interpret=True))
    b = tpost.material_lookup(torch.as_tensor(table), torch.as_tensor(ids),
                              torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(a, b)


def test_material_kernel_clips_ids_like_the_tpu_kernel():
    """ids past the 128 table lanes clip to lane 127 (zero-padded past M),
    negative ids to lane 0, exactly as post.py:_material_kernel does."""
    rng = np.random.default_rng(1)
    table = rng.random((45, 8)).astype(np.float32)
    ids = np.array([[-3.0, 0.0, 44.9, 200.0] * 32] * 16, np.float32)
    valid = np.ones((16, 128), bool)
    a = np.asarray(jpost.material_lookup(jnp.asarray(table), jnp.asarray(ids),
                                         jnp.asarray(valid), interpret=True))
    b = tpost.material_lookup(torch.as_tensor(table), torch.as_tensor(ids),
                              torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(a, b)


def test_tonemap_within_one_lsb():
    """u8 output within 1 LSB: pow/exp implementations differ by ulps and
    round(c * 255) flips at exact half-LSB boundaries; the dither hash is
    integer math and identical."""
    rng = np.random.default_rng(2)
    hdr = (rng.random((3, 48, 128)) ** 4 * 8.0).astype(np.float32)
    for t in (0.0, 0.032):
        a = np.asarray(jpost.tonemap_pass(jnp.asarray(hdr), jnp.float32(t)))
        b = tpost.tonemap_pass(torch.as_tensor(hdr), torch.tensor(t)).numpy()
        assert a.shape == b.shape == (48, 128, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_histogram_exact_counts():
    """Same bins, same counts: the bin index is a monotone float32 map and
    the inputs stay away from bin edges by more than a float32 ulp."""
    rng = np.random.default_rng(3)
    color = (np.exp(rng.normal(0, 3, (3, 64, 128)))).astype(np.float32)
    for exposure in (1e-4, 8e-4):
        a = np.asarray(jexp.compute_histogram(jnp.asarray(color),
                                              jnp.float32(exposure)))
        b = texp.compute_histogram(torch.as_tensor(color),
                                   torch.tensor(exposure)).numpy()
        np.testing.assert_array_equal(a, b)
        assert a.sum() == 64 * 128


@pytest.mark.parametrize("camera_cut", [True, False])
def test_pre_expose_lights(camera_cut):
    """rtol 1e-4: a handful of float32 transcendental ops (exp, log2,
    pow) on scalars, each within a few ulps across libraries."""
    rng = np.random.default_rng(4)
    hist = (rng.integers(0, 50, 128) * 16).astype(np.float32)
    args = (np.float32(3e-4), np.float32(128000.0), np.float32(1.0),
            np.float32(2.0), np.float32(0.016))
    a = jexp.pre_expose_lights(jnp.asarray(hist), *map(jnp.asarray, args),
                               float(hist.sum()), camera_cut=camera_cut)
    b = texp.pre_expose_lights(torch.as_tensor(hist),
                               *map(torch.as_tensor, args),
                               float(hist.sum()), camera_cut=camera_cut)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4)


def test_transmission_lut_unfused_math():
    """The transmission bake against the un-fused JAX evaluation: rtol
    1e-4 (measured 5.7e-5), since without jit both sides round every
    operation in the same order and only exp/sqrt/log ulps differ."""
    with jax.disable_jit():
        a = np.asarray(jsky.bake_transmission_lut())
    b = tsky.bake_transmission_lut(tcfg.AtmosphereSettings(), "cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)


def test_lut_bakes_match_jitted_jax():
    """The three LUT bakes against the jitted JAX functions the frame
    uses: rtol 1e-4 with atol = 1e-3 x the LUT's peak. The atmosphere's
    ray/earth intersections cancel earth_radius^2 - d^2 at ~4e7 in
    float32, and jit contracts those sums into FMAs, so grazing and
    below-horizon texels carry absolute errors near 5e-4 x peak
    (measured: transmission 6e-6, multiscatter 1.4e-4, sky 5e-4)."""
    settings = tcfg.AtmosphereSettings()
    jt = np.asarray(jsky.bake_transmission_lut())
    jm = np.array(jsky.bake_multiscatter_lut())
    pairs = [(jt, tsky.bake_transmission_lut(settings, "cpu").numpy()),
             (jm, tsky.bake_multiscatter_lut(settings, "cpu").numpy())]
    sun = _unit(np.array([0.3, -0.6, 0.74]))
    pairs.append((
        np.asarray(jsky.bake_sky_lut(jnp.asarray(sun), jnp.float32(3.0),
                                     jnp.asarray(jm))),
        tsky.bake_sky_lut(torch.as_tensor(sun), torch.tensor(3.0),
                          torch.as_tensor(jm), settings).numpy()))
    for ref, got in pairs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-3 * np.abs(ref).max())


def test_apply_sky():
    """Sky composite on a random LUT and view directions: rtol 1e-4 (the
    LUT lookup weights and the resize weight matrices are the same float32
    expressions; acos/pow differ by ulps)."""
    rng = np.random.default_rng(6)
    h, w = 64, 128
    dirs = _unit(rng.normal(size=(3, h, w)))
    lut = rng.random((3, 100, 200)).astype(np.float32)
    trans = rng.random((3, 128, 128)).astype(np.float32)
    color = rng.random((3, h, w)).astype(np.float32)
    valid = rng.random((h, w)) > 0.5
    sun = _unit(np.array([0.2, -0.7, 0.6]))
    # one pixel looking straight at the sun exercises the disc
    dirs[:, 5, 7] = sun
    args = (color, valid, lut, trans, dirs, sun)
    a = np.asarray(jsky.apply_sky(*map(jnp.asarray, args), jnp.float32(3.0)))
    b = tsky.apply_sky(*map(torch.as_tensor, args), torch.tensor(3.0)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)


def test_view_directions_and_sun_color():
    """Per-pixel rays and the sun colour: rtol 1e-5, plain float32 math
    (rsqrt and one bilinear lookup)."""
    rng = np.random.default_rng(7)
    f, u, r = _unit(np.array([0.6, 0.1, 0.79])), \
        _unit(np.array([0.05, -0.99, 0.1])), _unit(np.array([0.79, 0.0, -0.6]))
    a = np.asarray(jsky.view_directions(128, 64, f, u, r, 0.3153, 2.0))
    b = tsky.view_directions(128, 64, *map(torch.as_tensor, (f, u, r)),
                             0.3153, 2.0).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    trans = rng.random((3, 128, 128)).astype(np.float32)
    sun = _unit(np.array([0.0, -0.7071, 0.7071]))
    a = np.asarray(jsky.sample_transmission_towards_sun(jnp.asarray(trans),
                                                        jnp.asarray(sun)))
    b = tsky.sample_transmission_towards_sun(torch.as_tensor(trans),
                                             torch.as_tensor(sun)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5)


@pytest.mark.parametrize("diffuse_brdf,multiscatter",
                         [(2, 0), (0, 1), (1, 2), (3, 3)])
def test_shade_forward(diffuse_brdf, multiscatter):
    """Forward shading on random G-buffer planes, each diffuse BRDF and
    multiscatter mode: rtol 1e-4 (elementwise float32 with pow/log2/sqrt,
    same operation order; measured 7e-6)."""
    rng = np.random.default_rng(8)
    planes, valid = _shade_planes(rng, 32, 64)
    kw = dict(diffuse_brdf=diffuse_brdf,
              direct_multiscatter_brdf=multiscatter)
    a = np.asarray(jshade.shade_forward(
        config=jshade.ShadingConfig(**kw), valid=jnp.asarray(valid),
        **{k: jnp.asarray(v) for k, v in planes.items()}))
    b = tshade.shade_forward(
        config=tcfg.ShadingConfig(**kw), valid=torch.as_tensor(valid),
        **{k: torch.as_tensor(v) for k, v in planes.items()}).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("diffuse_brdf,multiscatter,indirect_multiscatter",
                         [(2, 0, True), (3, 1, True), (1, 2, False)])
def test_shade_forward_sh_indirect(diffuse_brdf, multiscatter,
                                   indirect_multiscatter):
    """The SDF GI's SH-L1 indirect branch (irradiance diffuse plus the
    dominant-direction specular lobe): rtol 1e-4 as above, atol 1e-6 for
    terms clamped at 0."""
    rng = np.random.default_rng(9)
    planes, valid = _shade_planes(rng, 32, 64)
    planes["indirect_y_sh"] = rng.normal(size=(4, 32, 64)).astype(np.float32)
    planes["indirect_cocg"] = (rng.normal(size=(2, 32, 64)) * 0.1) \
        .astype(np.float32)
    kw = dict(diffuse_brdf=diffuse_brdf,
              direct_multiscatter_brdf=multiscatter,
              use_indirect_multiscatter=indirect_multiscatter)
    a = np.asarray(jshade.shade_forward(
        config=jshade.ShadingConfig(**kw), valid=jnp.asarray(valid),
        **{k: jnp.asarray(v) for k, v in planes.items()}))
    b = tshade.shade_forward(
        config=tcfg.ShadingConfig(**kw), valid=torch.as_tensor(valid),
        **{k: torch.as_tensor(v) for k, v in planes.items()}).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    ambient = tshade.shade_forward(
        config=tcfg.ShadingConfig(**kw), valid=torch.as_tensor(valid),
        **{k: torch.as_tensor(v) for k, v in planes.items()
           if not k.startswith("indirect")}).numpy()
    assert np.abs(ambient - b).max() > 1e-3


def _shade_planes(rng, h, w):
    """Random G-buffer planes and lighting inputs for shade_forward."""
    planes = dict(
        world_pos=rng.normal(size=(3, h, w)),
        geo_normal=_unit(rng.normal(size=(3, h, w))),
        tangent=_unit(rng.normal(size=(3, h, w))),
        bitangent=_unit(rng.normal(size=(3, h, w))),
        albedo_srgb_linear=rng.random((3, h, w)),
        normal_ts=np.zeros((2, h, w)),
        specular=np.stack([np.ones((h, w)), rng.random((h, w)),
                           rng.random((h, w)) * 0.3]),
        sun_direction=_unit(np.array([0.3, -0.8, 0.4])),
        sun_color=np.array([0.9, 0.8, 0.7]),
        sun_strength_exposed=np.array(5.0),
        sun_shadow=np.ones((h, w)),
        camera_position=np.array([0.0, -1.7, 0.0]))
    planes = {k: np.asarray(v, np.float32) for k, v in planes.items()}
    return planes, rng.random((h, w)) > 0.2


def test_reconstruct_world_position():
    """Bit for bit against the jitted JAX function, as the frame runs it,
    at the golden frame's padded 128x256: the port rounds each row as
    XLA:CPU's multiply-add contraction does there (XLA contracts
    differently at some other sizes)."""
    rng = np.random.default_rng(9)
    h, w = 128, 256
    depth = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    a = np.asarray(jax.jit(jshade.reconstruct_world_position,
                           static_argnums=(2, 3))(
        jnp.asarray(depth), jnp.asarray(m), w, h))
    b = tshade.reconstruct_world_position(
        torch.as_tensor(depth), torch.as_tensor(m), w, h).numpy()
    np.testing.assert_array_equal(b, a)
