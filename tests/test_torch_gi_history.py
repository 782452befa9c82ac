"""The GI history path of the port against the JAX package: f16-pair
packing, motion vectors and the packed-plane history resample (the JAX
kernel in interpret mode, the port's plain version).

Resample rule: the ok channel equal on every pixel, values within 1e-6
relative to the magnitude of their four weighted taps (the bilinear sum
of |taps|): XLA may fuse the products into FMAs, the port rounds each,
and taps of mixed sign cancel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import taa as jtaa
from plainrenderer_tpu_torch.ops import taa as ttaa

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _f16_samples(rng, shape):
    """f32 values spanning f16's range: normals, subnormals, zeros of both
    signs, values that overflow to inf and ones that round to even."""
    v = rng.normal(size=shape) * np.exp(rng.uniform(-20, 12, shape))
    flat = v.reshape(-1)
    flat[:8] = [0.0, -0.0, 6e-8, -3e-6, 65504.0, 70000.0, 1.00048828125,
                1.00146484375]
    return v.astype(np.float32)


def test_pack_f16_pair_exact():
    rng = np.random.default_rng(1)
    a, b = _f16_samples(rng, (64, 128)), _f16_samples(rng, (64, 128))
    want = np.asarray(jtaa.pack_f16_pair(jnp.asarray(a), jnp.asarray(b)))
    got = ttaa.pack_f16_pair(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(ttaa.unpack_f16_pair(_t(want)),
                    jtaa.unpack_f16_pair(jnp.asarray(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the in-kernel decode: normals exact, subnormals flushed to zero
    lo, _ = ttaa.unpack_f16_pair_flush(_t(want))
    exact, _ = ttaa.unpack_f16_pair(_t(want))
    sub = (np.abs(exact.numpy()) < 2.0 ** -14)
    np.testing.assert_array_equal(lo.numpy()[~sub & np.isfinite(exact.numpy())],
                                  exact.numpy()[~sub & np.isfinite(
                                      exact.numpy())])
    assert (lo.numpy()[sub] == 0).all()


def test_compute_motion_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 48, 256
    prev_ndc = rng.uniform(-1.2, 1.2, (2, h, w)).astype(np.float32)
    valid = rng.random((h, w)) < 0.7
    cur, prev = np.asarray([0.001, -0.002], np.float32), \
        np.asarray([-0.0005, 0.0015], np.float32)
    want = jtaa.compute_motion(jnp.asarray(prev_ndc), jnp.asarray(valid),
                               jnp.asarray(cur), jnp.asarray(prev), 250, 45)
    got = ttaa.compute_motion(_t(prev_ndc), _t(valid), _t(cur), _t(prev),
                              250, 45)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n_planes,h,w", [(3, 64, 512), (1, 16, 128)])
def test_packed_planes_plain_matches_jax(n_planes, h, w):
    """Motion that pushes some tiles' mean x below 0 and others past the
    right edge, small motion elsewhere; history words with subnormal and
    negative f16 halves. On the 16x128 planes the window is the whole
    plane (min(32, h) x min(256, w))."""
    rng = np.random.default_rng(4 + h)
    a = _f16_samples(rng, (n_planes, h, w))
    b = _f16_samples(rng, (n_planes, h, w))
    b[:, ::3, ::5] = 3e-6  # subnormal f16
    planes = np.asarray(jtaa.pack_f16_pair(jnp.asarray(a), jnp.asarray(b)))
    motion = rng.normal(0, 0.002, (2, h, w)).astype(np.float32)
    motion[0, :16] -= 0.9  # first tile row: mean x far left of 0
    motion[0, -16:] += 0.9  # last tile row: far past the right edge
    motion[1, 16:32] += 0.05
    motion[0, :, :128] += np.linspace(-0.3, 0.3, 128, dtype=np.float32)
    jc, jok = jtaa.resample_packed_planes(
        jnp.asarray(planes), jnp.asarray(motion), w, h, interpret=True)
    tc, tok = ttaa.resample_packed_planes(_t(planes), _t(motion), w, h)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    jc = np.asarray(jc)
    assert tc.shape == jc.shape == (2 * n_planes, h, w)
    magnitude, _ = ttaa.resample_packed_planes(
        ttaa.pack_f16_pair(_t(np.abs(a)), _t(np.abs(b))), _t(motion), w, h)
    assert (np.abs(tc.numpy() - jc) <= 1e-6 * magnitude.numpy()).all()
    # the pushed tiles fall back (ok = 0), the others keep most pixels
    assert 0.05 < tok.numpy().mean() < 0.95
