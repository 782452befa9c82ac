"""Quantized vertex attribute types (plainrenderer_tpu/assets/compressed.py).

A copy of the JAX package's host-side module: unorm16, snorm16 and
R10G10B10A2 encode and decode in numpy (Plain/src/Common/
CompressedTypes.cpp). The .plain loader decodes at scene-load time into
planar f32 arrays for the geometry stage; the same bytes give the same
bits as the JAX package's (tests/test_torch_assets.py).
"""

from __future__ import annotations

import numpy as np


def float_to_unorm16(f: np.ndarray) -> np.ndarray:
    """CompressedTypes.cpp:4-10."""
    return (np.clip(f, 0.0, 1.0) * 65535.0).astype(np.uint16)


def float_to_snorm16(f: np.ndarray) -> np.ndarray:
    """CompressedTypes.cpp:12-21 — remap [-1,1] -> [int16 min, max]."""
    remapped = np.clip(f, -1.0, 1.0) * 0.5 + 0.5
    return (remapped * 65535.0 - 32768.0).astype(np.int16)


def vec3_to_r10g10b10a2(v: np.ndarray) -> np.ndarray:
    """CompressedTypes.cpp:23-43 — pack (..., 3) unit vectors into uint32.

    Per channel: clamp to [-1,1], remap to [0,1], scale into [-510, 511],
    truncate, mask to 10 bits; x lands in bits 20-29, y in 10-19, z in 0-9
    (the reference's ``(2 - i) * 10`` shift).
    """
    v = np.asarray(v, np.float32)
    out = np.zeros(v.shape[:-1], np.uint32)
    for i in range(3):
        clamped = np.clip(v[..., i], -1.0, 1.0)
        remapped = clamped * 0.5 + 0.5
        bits = (remapped * 1021.0 - 510.0).astype(np.int32)
        bits &= 1023
        out |= bits.astype(np.uint32) << np.uint32((2 - i) * 10)
    return out


def r10g10b10a2_to_vec3(packed: np.ndarray) -> np.ndarray:
    """Inverse of vec3_to_r10g10b10a2 (max quantization error ~2/1021)."""
    packed = np.asarray(packed, np.uint32)
    channels = []
    for i in range(3):
        bits = (packed >> np.uint32((2 - i) * 10)) & np.uint32(1023)
        signed = bits.astype(np.int32)
        signed = np.where(signed > 511, signed - 1024, signed)
        remapped = (signed.astype(np.float32) + 510.0) / 1021.0
        channels.append(remapped * 2.0 - 1.0)
    return np.stack(channels, axis=-1)
