"""ACES tonemap curves (plainrenderer_tpu/utils/tonemap.py;
tonemapping.inc): the Narkowicz approximation and the fitted RRT + ODT,
channel-last and channel-planar."""

from __future__ import annotations

import torch

# tonemapping.inc:17-22 / :25-30 — out = M @ color
_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def aces_film_approximate(x: torch.Tensor) -> torch.Tensor:
    """tonemapping.inc:5-13 — Narkowicz ACES fit, clamped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _rrt_odt_fit(v: torch.Tensor) -> torch.Tensor:
    """tonemapping.inc:32-37."""
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def _mat3(m, r, g, b):
    return (m[0][0] * r + m[0][1] * g + m[0][2] * b,
            m[1][0] * r + m[1][1] * g + m[1][2] * b,
            m[2][0] * r + m[2][1] * g + m[2][2] * b)


def aces_fitted(color: torch.Tensor) -> torch.Tensor:
    """tonemapping.inc:40-49 — fitted ACES RRT + ODT, color (..., 3)."""
    return aces_fitted_planar(torch.movedim(color, -1, 0)).movedim(0, -1)


def aces_fitted_planar(color: torch.Tensor) -> torch.Tensor:
    """tonemapping.inc:40-49 for channel-planar (3, H, W) input, as
    explicit scalar multiply-adds in the JAX package's order."""
    r, g, b = _mat3(_ACES_INPUT, color[0], color[1], color[2])
    r, g, b = _rrt_odt_fit(r), _rrt_odt_fit(g), _rrt_odt_fit(b)
    r, g, b = _mat3(_ACES_OUTPUT, r, g, b)
    return torch.clamp(torch.stack([r, g, b]), 0.0, 1.0)
