"""Hemisphere sampling and the TAA jitter sequence
(plainrenderer_tpu/utils/sampling.py, the parts the GI ray generation and
TAA use; sampling.inc:12-42, TAA.cpp:168-179). Channel-last, as the JAX
package's."""

from __future__ import annotations

import math

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def build_orthonormal_basis(n: torch.Tensor):
    """sampling.inc:12-15 — tangent/bitangent frame around normal n (..., 3)."""
    # up = (0, 0, 1) unless n is near the z axis, then (1, 0, 0); built
    # from the mask (a constant copied to the card would wait for it)
    z_up = (torch.abs(n[..., 2:3]) < 0.999).to(n.dtype)
    up = torch.cat([1.0 - z_up, torch.zeros_like(z_up), z_up], dim=-1)
    tangent = _cross(up, n)
    tangent = tangent / torch.clamp_min(
        torch.linalg.vector_norm(tangent, dim=-1, keepdim=True), 1e-20)
    bitangent = _cross(n, tangent)
    return tangent, bitangent


def _to_world(sample_hemi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    tangent, bitangent = build_orthonormal_basis(n)
    return (sample_hemi[..., 0:1] * tangent
            + sample_hemi[..., 1:2] * bitangent
            + sample_hemi[..., 2:3] * n)


def importance_sample_cosine(xi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """sampling.inc:25-42 — cosine-weighted hemisphere sample around n.
    xi (..., 2) in [0, 1); returns (..., 3)."""
    phi = 2.0 * math.pi * xi[..., 1]
    cos_theta = torch.sqrt(xi[..., 0])
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - xi[..., 0], 0.0))
    hemi = torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)
    return _to_world(hemi, n)


def taa_jitter_sequence(length: int = 8) -> np.ndarray:
    """TAA.cpp:168-179 — per-frame subpixel jitter in [-0.5, 0.5)^2:
    Hammersley (base 2, base 3) shifted by -0.5, (length, 2) f32 numpy."""
    b2 = np.zeros(length)
    b3 = np.zeros(length)
    for i in range(length):
        v, f, r2 = i, 0.5, 0.0
        while v:
            r2 += f * (v & 1)
            v >>= 1
            f *= 0.5
        b2[i] = r2
        v, f, rev = i, 1.0 / 3.0, 0
        while v:
            rev = rev * 3 + v % 3
            v //= 3
            f *= 1.0 / 3.0
        # the reversed base-3 digits over the same digit count
        b3[i] = rev * (f * 3.0) if i else 0.0
    return np.stack([b2, b3], axis=-1).astype(np.float32) - 0.5
