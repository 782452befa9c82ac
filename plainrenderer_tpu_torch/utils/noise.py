"""Void-and-cluster blue noise (plainrenderer_tpu/utils/noise.py, numpy).

A copy of the JAX package's host-side generator, so the port's blue-noise
tiles are bit-identical to the reference's without importing it.
"""

from __future__ import annotations

import numpy as np


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
