"""Low-discrepancy sequences, hemisphere importance sampling and the TAA
jitter sequence (plainrenderer_tpu/utils/sampling.py; MathUtils.cpp:27-78,
sampling.inc:4-55, TAA.cpp:168-179). Channel-last, as the JAX package's.

The bit reversal and the radical inverses are integer-exact on int64
tensors holding uint32 values (torch has no uint32 shifts on every
device): every step is masked back to 32 bits, so the words equal the
JAX package's uint32 words."""

from __future__ import annotations

import math

import numpy as np
import torch


_U32 = 0xFFFFFFFF


def reverse_bits_32(x: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:36-44 — bit-reverse a uint32, held in int64."""
    v = x.to(torch.int64) & _U32
    v = ((v << 16) | (v >> 16)) & _U32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def radical_inverse_base2(i: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:46-50 / sampling.inc:44-51: f32."""
    return reverse_bits_32(i).to(torch.float32) * 2.3283064365386963e-10


def radical_inverse_base3(i: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:52-78 — digit reversal in base 3 over 21 masked steps
    (3^21 > 2^32), the reversed digits wrapping at 32 bits and the scale a
    running f32 product of 1/3, as the JAX package computes them."""
    current = i.to(torch.int64) & _U32
    reversed_digits = torch.zeros_like(current)
    scale = torch.ones(current.shape, dtype=torch.float32,
                       device=current.device)
    for _ in range(21):
        active = current > 0
        nxt = current // 3
        digit = current - nxt * 3
        reversed_digits = torch.where(
            active, (reversed_digits * 3 + digit) & _U32, reversed_digits)
        scale = torch.where(active, scale * (1.0 / 3.0), scale)
        current = nxt
    return reversed_digits.to(torch.float32) * scale


def hammersley_2d(i: torch.Tensor) -> torch.Tensor:
    """MathUtils.cpp:31-34 — (radicalInverseBase2(i),
    radicalInverseBase3(i)), the CPU-side variant of the TAA jitter:
    (..., 2) f32."""
    return torch.stack([radical_inverse_base2(i), radical_inverse_base3(i)],
                       dim=-1)


def hammersley_2d_shader(i: torch.Tensor, n: int) -> torch.Tensor:
    """sampling.inc:53-55 — (i / N, radicalInverse_VdC(i)), brdfLut.comp's
    sequence: (..., 2) f32. i / N is a true f32 division (a Python divisor
    would multiply by its rounded reciprocal on the card)."""
    fi = i.to(torch.float32)
    return torch.stack([fi / torch.full_like(fi, float(n)),
                        radical_inverse_base2(i)], dim=-1)


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


def importance_sample_ggx(xi: torch.Tensor, roughness, n: torch.Tensor):
    """sampling.inc:4-23 — GGX NDF importance sample around normal n: xi
    (..., 2) in [0, 1), roughness broadcast against xi[..., 0]; returns a
    world-space half vector (..., 3)."""
    r2 = roughness * roughness
    cos_theta = torch.sqrt((1.0 - xi[..., 1])
                           / (1.0 + (r2 * r2 - 1.0) * xi[..., 1]))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * xi[..., 0]
    hemi = torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)
    return _to_world(hemi, n)


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
