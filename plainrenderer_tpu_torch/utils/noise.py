"""Noise generation (plainrenderer_tpu/utils/noise.py, Noise.cpp): white
noise, void-and-cluster blue noise and tileable Perlin noise in 2D and
3D, host numpy.

Copies of the JAX package's host-side generators, drawing from numpy's
default_rng(seed) in the same order, so the port's arrays are
bit-identical to the reference's without importing it.
"""

from __future__ import annotations

import numpy as np


def generate_white_noise(resolution: tuple[int, int],
                         seed: int = 0) -> np.ndarray:
    """Noise.cpp:36-43 — uint8 white noise."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=resolution, dtype=np.uint8)


def _toroidal_gaussian_kernel(res: tuple[int, int],
                              sigma: float = 1.9) -> np.ndarray:
    """Noise.cpp:80-86 — gaussian of the toroidal distance, as a full map."""
    h, w = res
    y = np.arange(h)
    x = np.arange(w)
    dy = np.minimum(y, h - y)[:, None]
    dx = np.minimum(x, w - x)[None, :]
    r2 = (dx * dx + dy * dy).astype(np.float64)
    return np.exp(-r2 / (2.0 * sigma * sigma))


def _influence(binary: np.ndarray, kernel_fft: np.ndarray) -> np.ndarray:
    """Circular convolution of the binary pattern with the Gaussian kernel
    (the reference's per-pixel influence LUT, Noise.cpp:104-131)."""
    return np.real(np.fft.ifft2(np.fft.fft2(binary.astype(np.float64))
                                * kernel_fft))


def generate_blue_noise(resolution: tuple[int, int] = (32, 32),
                        seed: int = 0) -> np.ndarray:
    """Noise.cpp:232+ — void-and-cluster blue noise, returns uint8 (H, W)."""
    h, w = resolution
    n = h * w
    rng = np.random.default_rng(seed)
    kernel_fft = np.fft.fft2(_toroidal_gaussian_kernel(resolution))

    # prototype binary pattern: ~10% minority pixels, relaxed to blue noise
    minority_count = max(1, n // 10)
    binary = np.zeros((h, w), bool)
    flat_choice = rng.choice(n, size=minority_count, replace=False)
    binary.reshape(-1)[flat_choice] = True

    # relax: swap tightest cluster -> biggest void until stable (bounded)
    for _ in range(n):
        infl = _influence(binary, kernel_fft)
        cluster = np.where(binary, infl, -np.inf)
        tightest = np.unravel_index(np.argmax(cluster), binary.shape)
        binary[tightest] = False
        infl = _influence(binary, kernel_fft)
        void = np.where(~binary, infl, np.inf)
        biggest = np.unravel_index(np.argmin(void), binary.shape)
        binary[biggest] = True
        if biggest == tightest:
            break

    rank = np.zeros((h, w), np.int32)

    # phase 1: rank initial minority pixels from minority_count-1 down to 0
    pattern = binary.copy()
    for r in range(minority_count - 1, -1, -1):
        infl = _influence(pattern, kernel_fft)
        cluster = np.where(pattern, infl, -np.inf)
        tightest = np.unravel_index(np.argmax(cluster), pattern.shape)
        pattern[tightest] = False
        rank[tightest] = r

    # phase 2 + 3: insert into biggest void, rank upward
    pattern = binary.copy()
    for r in range(minority_count, n):
        if r < n // 2:
            infl = _influence(pattern, kernel_fft)
            void = np.where(~pattern, infl, np.inf)
            target = np.unravel_index(np.argmin(void), pattern.shape)
        else:
            # majority phase: operate on the inverse pattern's clusters
            infl = _influence(~pattern, kernel_fft)
            cluster = np.where(~pattern, infl, -np.inf)
            target = np.unravel_index(np.argmax(cluster), pattern.shape)
        pattern[target] = True
        rank[target] = r

    return (rank.astype(np.float64) * 256.0 / n).astype(np.uint8)


def _smoothstep(t):
    """Noise.cpp PerlinNoiseHelperFunctions::smoothstep — 6t^5-15t^4+10t^3."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def generate_perlin_2d(resolution: tuple[int, int], cell_count: int = 8,
                       seed: int = 0) -> np.ndarray:
    """Noise.cpp generate2DPerlinNoise — tileable gradient noise in [0, 1],
    (H, W) f32."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(0, 2 * np.pi, size=(cell_count, cell_count))
    grads = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    h, w = resolution
    ys = (np.arange(h) + 0.5) / h * cell_count
    xs = (np.arange(w) + 0.5) / w * cell_count
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    y0 = np.floor(gy).astype(int)
    x0 = np.floor(gx).astype(int)
    fy = gy - y0
    fx = gx - x0
    total = np.zeros((h, w))
    for oy in (0, 1):
        for ox in (0, 1):
            g = grads[(y0 + oy) % cell_count, (x0 + ox) % cell_count]
            d = np.stack([fx - ox, fy - oy], axis=-1)
            dot = (g[..., 0] * d[..., 0] + g[..., 1] * d[..., 1])
            wy = _smoothstep(fy) if oy else 1.0 - _smoothstep(fy)
            wx = _smoothstep(fx) if ox else 1.0 - _smoothstep(fx)
            total += dot * wy * wx
    # normalised by the n-dimensional Perlin maximum sqrt(n) / 2 (Noise.cpp
    # computePerlineAbsMax), remapped to [0, 1]
    total /= np.sqrt(2.0) / 2.0
    return (total * 0.5 + 0.5).astype(np.float32)


def generate_perlin_3d(resolution: tuple[int, int, int], cell_count: int = 8,
                       seed: int = 0) -> np.ndarray:
    """Noise.cpp:422 generate3DPerlinNoise — tileable 3D gradient noise in
    [0, 1], (D, H, W) f32 (the froxel fog's density, Volumetrics.cpp:69-86)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(cell_count, cell_count, cell_count, 3))
    g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    d, h, w = resolution
    zs = (np.arange(d) + 0.5) / d * cell_count
    ys = (np.arange(h) + 0.5) / h * cell_count
    xs = (np.arange(w) + 0.5) / w * cell_count
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    z0 = np.floor(gz).astype(int)
    y0 = np.floor(gy).astype(int)
    x0 = np.floor(gx).astype(int)
    fz, fy, fx = gz - z0, gy - y0, gx - x0
    total = np.zeros((d, h, w))
    for oz in (0, 1):
        for oy in (0, 1):
            for ox in (0, 1):
                gv = g[(z0 + oz) % cell_count, (y0 + oy) % cell_count,
                       (x0 + ox) % cell_count]
                dot = (gv[..., 0] * (fx - ox) + gv[..., 1] * (fy - oy)
                       + gv[..., 2] * (fz - oz))
                wz = _smoothstep(fz) if oz else 1.0 - _smoothstep(fz)
                wy = _smoothstep(fy) if oy else 1.0 - _smoothstep(fy)
                wx = _smoothstep(fx) if ox else 1.0 - _smoothstep(fx)
                total += dot * wz * wy * wx
    total /= np.sqrt(3.0) / 2.0
    return (total * 0.5 + 0.5).astype(np.float32)
