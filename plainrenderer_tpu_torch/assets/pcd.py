"""Kodak PhotoCD (PCD) without PIL: the 768 x 512 base image, as Pillow
12.1's PcdImagePlugin.py and libImaging/PcdDecode.c read it.

PIL takes a file whose bytes at 2048 start "PCD_"; the base image sits at
96 * 2048 as 256 chunks of two 768-byte luma rows, then 384 Cb and 384 Cr
samples shared by each 2 x 2 block. UnpackYCC.c converts PhotoYCC to RGB
with integer tables t(c) = int(k * (c - offset) + 0.5) (truncated toward
zero): R = L(y) + CR(cr), G = L(y) + GR(cr) + GB(cb), B = L(y) + CB(cb),
clipped to 0-255, where L is 1.3584 y, CR 1.8215 (cr - 137), GR -0.9271
(cr - 137), GB -0.4303 (cb - 156) and CB 2.2179 (cb - 156). The low two
bits of the byte at 2048 + 1538 rotate the result: 1 by 90 degrees
counter-clockwise, 3 by 270.

A base image is 589,824 bytes behind a 196,608-byte header, so the
smallest PCD file is about 786 KB.
"""

from __future__ import annotations

import numpy as np

from . import modes

W, H = 768, 512
OFFSET = 96 * 2048


def _table(k: float, offset: int) -> np.ndarray:
    return np.trunc(k * (np.arange(256) - offset) + 0.5).astype(np.int64)


def looks_like_pcd(buf: bytes) -> bool:
    """PcdImageFile._open's check (1539 bytes from 2048, "PCD_")."""
    return len(buf) >= 2048 + 1539 and buf[2048:2052] == b"PCD_"


def read_pcd(buf: bytes, where: str = "<pcd>") -> np.ndarray:
    if not looks_like_pcd(buf):
        raise modes.NotThisFormat("not a PCD file")
    orientation = buf[2048 + 1538] & 3
    need = H // 2 * 3 * W
    if len(buf) - OFFSET < need:
        raise ValueError(f"PCD base image truncated: {where}")
    chunks = np.frombuffer(buf, np.uint8, need, OFFSET).reshape(H // 2,
                                                                 3 * W)
    y = chunks[:, :2 * W].reshape(H, W).astype(np.int64)
    cb = np.repeat(np.repeat(chunks[:, 2 * W:2 * W + W // 2], 2, 0), 2, 1)
    cr = np.repeat(np.repeat(chunks[:, 2 * W + W // 2:], 2, 0), 2, 1)
    lum = _table(1.3584, 0)[y]
    rgb = np.stack([lum + _table(1.8215, 137)[cr],
                    lum + _table(-0.9271, 137)[cr] + _table(-0.4303, 156)[cb],
                    lum + _table(2.2179, 156)[cb]], -1)
    out = modes.to_rgba("RGB", np.clip(rgb, 0, 255).astype(np.uint8))
    if orientation == 1:
        out = np.rot90(out, 1)
    elif orientation == 3:
        out = np.rot90(out, 3)
    return np.ascontiguousarray(out)
