"""The port's Monte Carlo BRDF bake and its sampling helpers against the
JAX package.

Rules: the bit reversal, the radical inverses and both Hammersley
sequences bit-exact (uint32 words held in int64); the GGX and cosine
samples and the geometric terms within 2 f32 ulps (relative 2.4e-7);
bake_brdf_lut at 32^2 texels x 64 samples for each diffuse_brdf within
1e-6 of the JAX bake run op by op (jax.disable_jit) and within 1e-4 of
the jitted one: under jit XLA:CPU evaluates the GGX sample's sin / cos /
sqrt chain with its fused approximations, which moves the half vectors
by up to 8.7e-5 against its own op-by-op values at grazing NoV, and the
jitted bake by up to 5.7e-5 against its op-by-op bake. sample_brdf_lut
and env_brdf_approx within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import brdf as jbrdf
from plainrenderer_tpu.ops import brdf_lut as jlut
from plainrenderer_tpu.utils import sampling as jsamp
from plainrenderer_tpu_torch.ops import brdf as tbrdf
from plainrenderer_tpu_torch.ops import brdf_lut as tlut
from plainrenderer_tpu_torch.utils import sampling as tsamp

torch.set_num_threads(1)


def _words():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    w[:8] = [0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1, 3 ** 20, 3 ** 20 * 2]
    return w.astype(np.uint32)


def test_bit_reversal_and_radical_inverses_bit_exact():
    w = _words()
    ti = torch.as_tensor(w.astype(np.int64))
    ji = jnp.asarray(w)
    np.testing.assert_array_equal(
        tsamp.reverse_bits_32(ti).numpy(),
        np.asarray(jsamp.reverse_bits_32(ji)).astype(np.int64))
    for name in ("radical_inverse_base2", "radical_inverse_base3",
                 "hammersley_2d"):
        got = getattr(tsamp, name)(ti).numpy()
        want = np.asarray(getattr(jsamp, name)(ji))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # the TAA jitter table is Hammersley (base 2, base 3) - 0.5, there
    # built in f64 and rounded once
    np.testing.assert_allclose(
        tsamp.hammersley_2d(torch.arange(8)).numpy() - 0.5,
        tsamp.taa_jitter_sequence(8), rtol=0, atol=6e-8)


@pytest.mark.parametrize("n", [64, 1000, 1024])
def test_shader_hammersley_bit_exact(n):
    got = tsamp.hammersley_2d_shader(torch.arange(n), n).numpy()
    want = np.asarray(jsamp.hammersley_2d_shader(
        jnp.arange(n, dtype=jnp.uint32), n))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_importance_samples_and_geometric_terms_match_jax():
    rng = np.random.default_rng(5)
    xi = rng.random((2000, 2)).astype(np.float32)
    rough = rng.uniform(1e-4, 1.0, 2000).astype(np.float32)
    nrm = rng.normal(size=(2000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0.0447, 0.999]]
    got = tsamp.importance_sample_ggx(torch.as_tensor(xi),
                                      torch.as_tensor(rough),
                                      torch.as_tensor(nrm)).numpy()
    want = np.asarray(jsamp.importance_sample_ggx(
        jnp.asarray(xi), jnp.asarray(rough), jnp.asarray(nrm)))
    # sin_theta = sqrt(1 - cos_theta^2) cancels near the pole and an ulp of
    # torch's sin / cos against XLA's moves a component by up to ~2e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    nov, nol = (rng.random(2000).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tbrdf.g_ggx(torch.as_tensor(rough), torch.as_tensor(nov)).numpy(),
        np.asarray(jbrdf.g_ggx(jnp.asarray(rough), jnp.asarray(nov))),
        rtol=2.4e-7)
    np.testing.assert_allclose(
        tbrdf.g_smith_uncorrelated(*(torch.as_tensor(a)
                                     for a in (rough, nov, nol))).numpy(),
        np.asarray(jbrdf.g_smith_uncorrelated(
            *(jnp.asarray(a) for a in (rough, nov, nol)))), rtol=4.8e-7)


@pytest.mark.parametrize("diffuse_brdf", [0, 1, 2, 3])
def test_bake_matches_jax(diffuse_brdf, monkeypatch):
    """32^2 x 64 in chunks of one NoV row and in one chunk: equal to each
    other, within 1e-6 of the op-by-op JAX bake and 1e-4 of the jitted
    one."""
    got = tlut.bake_brdf_lut(32, 64, diffuse_brdf, device="cpu").numpy()
    monkeypatch.setattr(tlut, "CHUNK_BYTES", 1)
    one_row = tlut.bake_brdf_lut(32, 64, diffuse_brdf, device="cpu").numpy()
    np.testing.assert_array_equal(got, one_row)
    with jax.disable_jit():
        eager = np.asarray(jlut.bake_brdf_lut(32, 64, diffuse_brdf))
    jitted = np.asarray(jlut.bake_brdf_lut(32, 64, diffuse_brdf))
    assert got.shape == (3, 32, 32)
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-4)
    assert 0.0 < got[2].mean() < 1.0 and got[1].max() <= 1.05


def test_bake_refuses_an_unknown_diffuse_brdf():
    with pytest.raises(ValueError):
        tlut.bake_brdf_lut(8, 8, 4, device="cpu")


def test_sample_lut_and_karis_approx_match_jax():
    rng = np.random.default_rng(9)
    lut = rng.random((3, 32, 32)).astype(np.float32)
    r = rng.uniform(-0.1, 1.1, (40, 50)).astype(np.float32)
    nov = rng.uniform(-0.1, 1.1, (40, 50)).astype(np.float32)
    got = tlut.sample_brdf_lut(torch.as_tensor(lut), torch.as_tensor(r),
                               torch.as_tensor(nov)).numpy()
    want = np.asarray(jlut.sample_brdf_lut(jnp.asarray(lut), jnp.asarray(r),
                                           jnp.asarray(nov)))
    assert got.shape == (3, 40, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for a, b in zip(tlut.env_brdf_approx(torch.as_tensor(r),
                                         torch.as_tensor(nov)),
                    jlut.env_brdf_approx(jnp.asarray(r), jnp.asarray(nov))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
