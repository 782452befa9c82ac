"""Per-mesh signed-distance-field baking (plainrenderer_tpu/assets/sdf_bake.py).

Exact point-to-triangle distance for every voxel (the quantity the
reference's 225-ray DDA approximates, SceneSDF.cpp:345-504), signed by the
generalized winding number thresholded at 0.5 (the backface-majority
rule). The reference's output contract holds:

  - resolution per axis: nextPow2(extent / 0.25 m) clamped to [16, 64]
    (SceneSDF.cpp:120-131), from the UNPADDED mesh AABB;
  - volume domain: the AABB padded by 7.5% / min 0.5 m
    (sdfUtilities.cpp:5-18);
  - voxel centers ((idx + 0.5) / res - 0.5) * extent + center;
  - array shape (rz, ry, rx), negative inside.

bake_mesh_sdf is the counterpart of the JAX package's use_jax=True path:
the dense voxel x triangle evaluation runs as PyTorch tensor code on
`device` (the card by default). The JAX package's C++ baker
(native/sdf_bake.cc) has no counterpart here yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import device as device_mod
from ..scene.aabb import pad_sdf_bounding_box

MAX_SDF_RES = 64
MIN_SDF_RES = 16
TARGET_TEXEL_PER_METER = 0.25


def next_power_of_two(x: int) -> int:
    """SceneSDF.cpp:42-52."""
    if x <= 1:
        return 1
    return 1 << (int(x - 1).bit_length())


def sdf_resolution_for_aabb(bb_min, bb_max) -> tuple[int, int, int]:
    """SceneSDF.cpp:120-131 — per-axis nextPow2(extent/0.25) in [16, 64]."""
    extent = np.asarray(bb_max, np.float64) - np.asarray(bb_min, np.float64)
    res = []
    for component in range(3):
        target = extent[component] / TARGET_TEXEL_PER_METER
        r = next_power_of_two(int(target))
        res.append(int(np.clip(r, MIN_SDF_RES, MAX_SDF_RES)))
    return tuple(res)


def _voxel_centers(resolution, bb_min, bb_max) -> np.ndarray:
    """Voxel centers over the padded volume, (rz*ry*rx, 3) f32, x-fastest."""
    rx, ry, rz = resolution
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    extent = bb_max - bb_min
    center = 0.5 * (bb_min + bb_max)
    xs = (np.arange(rx, dtype=np.float32) + 0.5) / rx - 0.5
    ys = (np.arange(ry, dtype=np.float32) + 0.5) / ry - 0.5
    zs = (np.arange(rz, dtype=np.float32) + 0.5) / rz - 0.5
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return pts * extent + center


def _chunked_sdf(points, v0, v1, v2) -> torch.Tensor:
    """Signed distance of (P, 3) points to the triangle soup, in chunks
    that keep the (P_c, T) intermediates at ~2^24 elements."""
    n_tri = v0.shape[0]
    chunk = max(64, int(2 ** 24 // max(n_tri, 1)))
    outs = [_sdf_block(points[s:s + chunk], v0, v1, v2)
            for s in range(0, points.shape[0], chunk)]
    return torch.cat(outs)


def _dot(a, b):
    return (a * b).sum(-1)


def _sdf_block(p, a, b, c) -> torch.Tensor:
    """Exact signed distance for a block of points (iquilezles distance +
    winding-number sign). p: (P, 3); a/b/c: (T, 3). Returns (P,)."""
    p = p[:, None, :]
    a = a[None, :, :]
    b = b[None, :, :]
    c = c[None, :, :]

    def cross(u, v):
        u, v = torch.broadcast_tensors(u, v)
        return torch.linalg.cross(u, v, dim=-1)

    ba = b - a
    cb = c - b
    ac = a - c
    pa = p - a
    pb = p - b
    pc = p - c
    nor = cross(ba, ac)

    # edge-region test (same structure as SceneSDF.cpp:55-95)
    s1 = torch.sign(_dot(cross(ba, nor), pa))
    s2 = torch.sign(_dot(cross(cb, nor), pb))
    s3 = torch.sign(_dot(cross(ac, nor), pc))
    outside_edge = (s1 + s2 + s3) < 2.0

    def seg_dist2(edge, rel):
        t = torch.clamp(_dot(rel, edge)
                        / torch.clamp_min(_dot(edge, edge), 1e-20), 0.0, 1.0)
        d = rel - edge * t[..., None]
        return _dot(d, d)

    d_edge = torch.minimum(
        torch.minimum(seg_dist2(ba, pa), seg_dist2(cb, pb)),
        seg_dist2(ac, pc))
    d_face = _dot(nor, pa) ** 2 / torch.clamp_min(_dot(nor, nor), 1e-20)
    d2 = torch.where(outside_edge, d_edge, d_face)  # (P, T)
    unsigned = torch.sqrt(torch.clamp_min(d2.amin(dim=1), 0.0))

    # generalized winding number (sign): sum of signed solid angles / 4pi
    ra, rb, rc = a - p, b - p, c - p
    la = torch.sqrt(torch.clamp_min(_dot(ra, ra), 1e-30))
    lb = torch.sqrt(torch.clamp_min(_dot(rb, rb), 1e-30))
    lc = torch.sqrt(torch.clamp_min(_dot(rc, rc), 1e-30))
    num = _dot(ra, cross(rb, rc))
    den = (la * lb * lc + _dot(ra, rb) * lc + _dot(rb, rc) * la
           + _dot(rc, ra) * lb)
    omega = 2.0 * torch.atan2(num, den)
    winding = omega.sum(dim=1) / (4.0 * math.pi)
    # reference sign rule: majority backface hits -> inside
    # (SceneSDF.cpp:495-499)
    inside = torch.abs(winding) > 0.5
    return torch.where(inside, -unsigned, unsigned)


def bake_mesh_sdf(positions: np.ndarray, indices: np.ndarray,
                  bb_min=None, bb_max=None, resolution=None,
                  device="cuda") -> np.ndarray:
    """Bake one mesh's SDF volume on `device`. Returns (rz, ry, rx) f32.

    positions: (V, 3) f32; indices: (I,) or (I/3, 3) int. bb_min/bb_max
    default to the mesh AABB (the UNPADDED box, SceneSDF.cpp:115-118;
    padding happens here)."""
    dev = device_mod.resolve(device)
    positions = np.asarray(positions, np.float32)
    tri = np.asarray(indices).reshape(-1, 3).astype(np.int64)
    if bb_min is None:
        bb_min = positions.min(axis=0)
        bb_max = positions.max(axis=0)
    if resolution is None:
        resolution = sdf_resolution_for_aabb(bb_min, bb_max)
    rx, ry, rz = resolution
    pad_min, pad_max = pad_sdf_bounding_box(bb_min, bb_max)

    points = torch.as_tensor(_voxel_centers(resolution, pad_min, pad_max),
                             device=dev)
    v = [torch.as_tensor(np.ascontiguousarray(positions[tri[:, k]]),
                         device=dev) for k in range(3)]
    sd = _chunked_sdf(points, *v)
    return sd.cpu().numpy().astype(np.float32).reshape(rz, ry, rx)
