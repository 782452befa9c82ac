"""The port's TAA against the JAX package: R11G11B10 packing, the jitter
table, motion dilation, resolve weights, the K-tap history resample (the
JAX kernel in interpret mode against the port's plain version of kernel I)
and the whole temporal filter over 3 frames for every history sampler.

Resample rule: ok equal on every pixel, values within 1e-6 of the
magnitude of their taps (the bilinear sum of |taps|, all R11G11B10 values
are >= 0): XLA may fuse the blend's products into FMAs, the port rounds
each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plainrenderer_tpu.ops import color_packing as jcp
from plainrenderer_tpu.ops import taa as jtaa
from plainrenderer_tpu.render import frame as jframe
from plainrenderer_tpu_torch.ops import color_packing as tcp
from plainrenderer_tpu_torch.ops import taa as ttaa
from plainrenderer_tpu_torch.utils.sampling import taa_jitter_sequence
from test_torch_cuda import _window_edge_coords

torch.set_num_threads(1)
_JAX_RESAMPLE_HISTORY_TAPS = jtaa.resample_history_taps


def _t(a):
    return torch.as_tensor(np.array(a))


def test_r11g11b10_bit_exact():
    """Seeded values over the format's range plus negatives, NaN, +-inf,
    values above 64512, values under the flush threshold and zeros."""
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(3, 64, 128))
         * np.exp(rng.uniform(-22, 12, (3, 64, 128)))).astype(np.float32)
    flat = v.reshape(-1)
    flat[:12] = [np.nan, np.inf, -np.inf, 70000.0, 64512.0, 65535.0, 0.0,
                 -0.0, 3e-5, 6e-5, 1e-30, -5.0]
    want = np.asarray(jcp.pack_r11g11b10(jnp.asarray(v)))
    got = tcp.pack_r11g11b10(_t(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tcp.unpack_r11g11b10(_t(want)).numpy(),
        np.asarray(jcp.unpack_r11g11b10(jnp.asarray(want))))
    words = rng.integers(-2 ** 31, 2 ** 31, (64, 128), dtype=np.int64) \
        .astype(np.int32)
    np.testing.assert_array_equal(
        tcp.unpack_r11g11b10(_t(words)).numpy(),
        np.asarray(jcp.unpack_r11g11b10(jnp.asarray(words))))


def test_jitter_table_equal():
    np.testing.assert_array_equal(taa_jitter_sequence(8) * 2.0,
                                  np.asarray(jframe._JITTER_TABLE))


def test_dilate_motion_and_resolve_weights_match_jax():
    rng = np.random.default_rng(5)
    motion = rng.normal(0, 0.01, (2, 32, 128)).astype(np.float32)
    depth = rng.random((32, 128)).astype(np.float32)
    depth[::4] = 0.5  # ties keep the first maximum
    np.testing.assert_array_equal(
        ttaa.dilate_motion(_t(motion), _t(depth)).numpy(),
        np.asarray(jtaa.dilate_motion(jnp.asarray(motion),
                                      jnp.asarray(depth))))
    for jit in np.asarray(jframe._JITTER_TABLE):
        np.testing.assert_allclose(
            ttaa.resolve_weights(_t(jit)).numpy(),
            np.asarray(jtaa.resolve_weights(jnp.asarray(jit))),
            rtol=1e-6, atol=0)


def _history(rng, h, w):
    rgb = (rng.random((3, h, w)) * np.exp(rng.uniform(-6, 6, (3, h, w))))
    return tcp.pack_r11g11b10(_t(rgb.astype(np.float32)))


def _coords(rng, h, w, n_taps):
    """Absolute coords around each pixel; the first tile row pushed far
    left, the last one past the right edge, a band of rows off the top
    and a ramp that splits a tile across the window edge."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    motion = rng.normal(0, 1.5, (2, h, w)).astype(np.float32)
    motion[0, :16] -= 0.9 * w
    motion[0, -16:] += 0.9 * w
    motion[1, 16:32] -= 40.0
    motion[0, :, :128] += np.linspace(-90, 90, 128, dtype=np.float32)
    taps = [np.stack([xs + motion[0] + rng.uniform(-2, 2),
                      ys + motion[1] + rng.uniform(-2, 2)])
            for _ in range(n_taps)]
    return np.concatenate(taps).astype(np.float32)


@pytest.mark.parametrize("n_taps,h,w", [(1, 64, 256), (1, 64, 512),
                                         (16, 16, 128)])
def test_history_taps_plain_matches_jax(n_taps, h, w):
    """K = 1: windows of 32 rows placed per tile row, and at 512 columns
    the window (256) also moves in x. K = 16 on one 16x128 tile, where the
    window is the plane: the JAX kernel's interpret-mode trace and compile
    grow with K times the window's words (~60 s at K = 16 on 64x256,
    ~15 s here), and the same compiled kernel serves tech 1 of
    test_temporal_filter_matches_jax."""
    rng = np.random.default_rng(11 + n_taps + w)
    hist = _history(rng, h, w)
    coords = _coords(rng, h, w, n_taps)
    j_rgb, j_ok = _jax_taps(n_taps, h, w)(jnp.asarray(hist.numpy()),
                                          jnp.asarray(coords))
    t_rgb, t_ok = ttaa.resample_history_taps(hist, _t(coords))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert 0.05 < float(t_ok.float().mean()) < 0.95
    magnitude = ttaa.history_taps_plain(hist, _t(coords))[:3 * n_taps]
    assert (np.abs(t_rgb.numpy() - np.asarray(j_rgb))
            <= 1e-6 * magnitude.numpy()).all()


@pytest.mark.parametrize("n_taps,h,w", [(1, 64, 512), (16, 16, 128)])
def test_history_taps_plain_matches_jax_at_window_edges(n_taps, h, w):
    """Kernel I's plain version against the JAX kernel (interpret mode) on
    coords at its windows' clamp edges (test_torch_cuda.py:
    _window_edge_coords: the footprint clamped at 0 and at win - 2, fx
    and fy exactly 0 and 1, the 2.5-texel margin exactly and one f32 step
    inside, far outside), with the shapes of
    test_history_taps_plain_matches_jax so the compiled kernels are
    shared. Its rule: ok equal, values within 1e-6 of the taps'
    magnitude."""
    rng = np.random.default_rng(71 + n_taps)
    hist = _history(rng, h, w)
    coords = _window_edge_coords(rng, h, w, n_taps)
    j_rgb, j_ok = _jax_taps(n_taps, h, w)(jnp.asarray(hist.numpy()),
                                          jnp.asarray(coords))
    t_rgb, t_ok = ttaa.resample_history_taps(hist, _t(coords))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    magnitude = ttaa.history_taps_plain(hist, _t(coords))[:3 * n_taps]
    assert (np.abs(t_rgb.numpy() - np.asarray(j_rgb))
            <= 1e-6 * magnitude.numpy()).all()
    # the edges are hit: taps clamped on both sides of the window, and tap
    # 0 exactly on the margin
    by, bx = ttaa._tile_window(_t(coords[0]), h, w)
    sx = coords[0::2] - bx.numpy()
    assert (sx < 0.5).any() and (sx > min(256, w) - 1.5).any()
    assert (sx[0] == 2.5).any()


def _r11_steps(a, b):
    """Per-channel distance in R11G11B10 steps of two packed planes."""
    fields = [(0, 0x7FF), (11, 0x7FF), (22, 0x3FF)]
    return np.stack([np.abs(((a >> s) & m).astype(np.int64)
                            - ((b >> s) & m).astype(np.int64))
                     for s, m in fields])


@functools.lru_cache(maxsize=None)
def _jax_taps(n_taps, h, w):
    """The JAX kernel in interpret mode, jitted once per (K, H, W): its
    interpret-mode compile grows with K and the window's rows (~2 s per
    tap at 32x256) and an eager call recompiles every time."""
    del n_taps, h, w  # the cache key
    return jax.jit(functools.partial(_JAX_RESAMPLE_HISTORY_TAPS,
                                     interpret=True))


def _shared_jax_taps(history_packed, coords, interpret=False):
    assert interpret
    return _jax_taps(coords.shape[0] // 2, *history_packed.shape)(
        history_packed, coords)


FILTER_CASES = [dict(history_sampling_tech=t) for t in range(5)] + [
    dict(history_sampling_tech=4, use_clipping=False,
         use_motion_dilation=False, use_tonemapping=False)]


@pytest.mark.parametrize("kw", FILTER_CASES,
                         ids=["tech0", "tech1", "tech2", "tech3", "tech4",
                              "tech4-plain"])
def test_temporal_filter_matches_jax(kw, monkeypatch):
    """3 frames carrying each side's own packed history, frame 0 a camera
    cut, on one 16x128 tile (the window is the whole plane; the window's
    placement is test_history_taps_plain_matches_jax's). JAX runs eagerly
    with its history kernel jitted in interpret mode. The packed words
    equal on >= 99.9% and within one R11G11B10 step elsewhere, the output
    within 1e-4 relative on >= 99%. A static image with 10% noise per
    frame and a bright (HDR 20) block: the inverse tonemap divides by
    1 - luma, small there, so an ulp upstream can move a packed word by
    one step, and a carried step moves the next output by up to ~2%."""
    monkeypatch.setattr(jtaa, "resample_history_taps", _shared_jax_taps)
    rng = np.random.default_rng(21)
    h, w = 16, 128
    j_hist = jnp.zeros((h, w), jnp.int32)
    t_hist = torch.zeros((h, w), dtype=torch.int32)
    table = np.asarray(jframe._JITTER_TABLE)
    base = rng.random((3, h, w)) ** 3 * 8.0
    base[:, 4:8, 40:60] = 20.0
    for i in range(3):
        color = (base * (1 + 0.1 * rng.random((3, h, w)))).astype(np.float32)
        motion = rng.normal(0, 0.01, (2, h, w)).astype(np.float32)
        motion[0, :, 100:] += 0.3  # reprojects off the frame
        depth = rng.random((h, w)).astype(np.float32)
        jit = table[i]
        j_out, j_hist = jtaa.temporal_filter(
            jnp.asarray(color), j_hist, jnp.asarray(motion),
            jnp.asarray(depth), jnp.asarray(jit), jnp.asarray(i == 0), w, h,
            interpret=True, **kw)
        t_out, t_hist = ttaa.temporal_filter(
            _t(color), t_hist, _t(motion), _t(depth), _t(jit),
            torch.tensor(i == 0), w, h, **kw)
    steps = _r11_steps(t_hist.numpy(), np.asarray(j_hist))
    equal = (steps == 0).all(axis=0).mean()
    assert equal >= 0.999, equal
    assert steps.max() <= 1, steps.max()
    close = np.isclose(t_out.numpy(), np.asarray(j_out), rtol=1e-4,
                       atol=1e-6).all(axis=0)
    assert close.mean() >= 0.99, close.mean()
