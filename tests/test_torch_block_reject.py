"""The block test of kernels E, B, J and K (ops/raster.py:block_may_cover).

The CUDA kernels skip a 16 x 16 block of pixel centres for a pair when the
pair's edge planes (and, in kernels B and K, its z range) rule out every
pixel of the block at its extreme corner. That skip may never drop a
pixel the plain versions cover, or the atlas and the G-buffer would
differ from them. Here, on the CPU: one pair per bin, its coverage from
depth_plain (kernel E's plain version) and from gbuffer_plain (kernel B's,
which adds 0 < z <= 1), against block_may_cover for every 16 x 16 block of
the bin; and the same pairs as the 32-row alpha table of kernels J
(depth_plain with masks) and K (winner_alpha_plain). Pairs are random
triangles and adversarial planes: edges through pixel centres, +-0, huge
and tiny coefficients, NaN and +-inf. A block whose every corner is
clearly outside one edge (in float64) must be rejected.
"""

import numpy as np
import pytest
import torch

from plainrenderer_tpu_torch.assets import textures
from plainrenderer_tpu_torch.ops import raster

torch.set_num_threads(1)

NTY, NTX = 32, 4  # 128 bins of 16 x 128: one pair each
BLK = 16


def _tri_planes(v):
    """Edge planes (a, b, c) of the triangle v (3, 2) in pixel coords, each
    >= 0 inside (float64, (3, 3))."""
    out = []
    for i in range(3):
        (x0, y0), (x1, y1) = v[i], v[(i + 1) % 3]
        pl = np.array([y0 - y1, x1 - x0, x0 * y1 - x1 * y0])
        if pl @ np.array([*v[(i + 2) % 3], 1.0]) < 0:
            pl = -pl
        out.append(pl)
    return np.stack(out)


def _origin(i):
    ty, tx = divmod(i, NTX)
    return np.array([tx * 128.0, ty * 16.0])


def _random_tri(rng, i):
    c = _origin(i) + rng.uniform([0, 0], [128, 16])
    return c + rng.uniform(0.3, 60.0) * rng.normal(size=(3, 2))


def _planes(kind, rng):
    """(edges (NTY * NTX, 3, 3), z (NTY * NTX, 3)) float64 for one kind."""
    n = NTY * NTX
    edges = np.stack([_tri_planes(_random_tri(rng, i)) for i in range(n)])
    # z planes around each bin's origin, mostly inside (0, 1] on the bin
    org = np.stack([_origin(i) for i in range(n)])
    z = np.stack([rng.uniform(-3e-3, 3e-3, n), rng.uniform(-3e-2, 3e-2, n),
                  rng.uniform(-0.2, 1.2, n)], -1)
    z[:, 2] -= z[:, 0] * org[:, 0] + z[:, 1] * org[:, 1]
    if kind == "centres":  # vertices on pixel centres: edges with e == 0
        for i in range(n):
            o = _origin(i) + 0.5
            p = o + rng.integers(0, [120, 14])
            d = rng.integers(-6, 7, (2, 2)).astype(np.float64)
            v = np.stack([p, p + [d[0, 0], 0.0], p + [0.0, d[1, 1]]]) \
                if i % 2 else np.stack([p, p + d[0], p + d[1]])
            e1, e2 = v[1] - v[0], v[2] - v[0]
            if abs(e1[0] * e2[1] - e1[1] * e2[0]) < 1:
                v = np.stack([p, p + [5.0, 0.0], p + [5.0, 5.0]])
            edges[i] = _tri_planes(v)
        z[:, :2] = 0.0
        z[::3, 2] = 0.0  # z == 0 exactly: not covered in kernel B
        z[1::3, 2] = 1.0  # z == 1 exactly: covered
    elif kind == "zeros":  # +-0 coefficients
        for i in range(n):
            a, b = rng.choice([0.0, -0.0], 2)
            which = i % 3
            edges[i, which, 0] = a
            edges[i, (which + 1) % 3, 1] = b
        z[::2, 0] = -0.0
        z[1::2, 1] = 0.0
    elif kind == "extreme":  # huge and tiny coefficients
        scale = rng.choice([1e30, 3e38, 1e-30, 1e-38, 1e-45, 1.0],
                           (n, 3, 3))
        edges = edges * scale
        z = z * rng.choice([1e30, 1e-30, 1e-45, 1.0, 1.0, 1.0], (n, 3))
    elif kind == "nonfinite":  # NaN and +-inf
        vals = np.array([np.nan, np.inf, -np.inf])
        for i in range(n):
            if i % 2:
                edges[i, rng.integers(0, 3), rng.integers(0, 3)] = \
                    vals[rng.integers(0, 3)]
            if i % 4 < 2:
                z[i, rng.integers(0, 3)] = vals[rng.integers(0, 3)]
    return edges, z


def _pair_table(edges, z):
    """One pair per bin: pair_edges (16, P) and its PairLists."""
    n = edges.shape[0]
    pe = np.zeros((16, n), np.float64)
    for p in range(3):
        pe[4 * p:4 * p + 3] = edges[:, p].T
    pe[12:15] = z.T
    with np.errstate(all="ignore"):
        pe = torch.as_tensor(pe.astype(np.float32))
    ar = torch.arange(n, dtype=torch.int32)
    return pe, raster.PairLists(
        pair_tri=ar, tile_start=ar,
        tile_count=torch.ones(n, dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.int32))


def _blocks(covered):
    """(H, W) bool -> (bins, 8) bool: any pixel of each 16 x 16 block."""
    return covered.reshape(NTY, BLK, NTX, 128 // BLK, BLK).permute(
        0, 2, 3, 1, 4).reshape(NTY * NTX, 128 // BLK, BLK * BLK).any(-1)


def _may(pe, with_z):
    """block_may_cover of each bin's pair against each of its blocks."""
    n = pe.shape[1]
    bins = torch.arange(n)
    x0 = (bins % NTX * 128)[:, None] + torch.arange(0, 128, BLK)[None]
    y0 = (bins // NTX * 16)[:, None].expand_as(x0)
    e = pe[[0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(3, 3, n)[..., None]
    z = pe[12:15, :, None] if with_z else None
    return raster.block_may_cover(e, x0, y0, BLK, BLK, z=z)


def _covered(pe, pairs, with_z):
    """Pixels the pair of their bin covers in the plain versions: kernel
    E's (edges) or kernel B's (edges and 0 < z <= 1)."""
    if not with_z:
        bits = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count,
                                  NTY, NTX, 1, False).view(torch.int32)
        return bits != 0
    attrs = torch.zeros((raster.NATTR + 1, pe.shape[1]))
    _, vis, _ = raster.gbuffer_plain(pe, attrs, pairs.tile_start,
                                     pairs.tile_count, NTY, NTX, 1, False)
    return vis >= 0


@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("kind", ["random", "centres", "zeros", "extreme",
                                  "nonfinite"])
def test_block_test_never_rejects_a_covered_block(kind, with_z):
    rng = np.random.default_rng(["random", "centres", "zeros", "extreme",
                                 "nonfinite"].index(kind) + 10 * with_z)
    pe, pairs = _pair_table(*_planes(kind, rng))
    covered = _blocks(_covered(pe, pairs, with_z))
    may = _may(pe, with_z)
    assert int(covered.sum()) > 20  # the pairs do cover pixels
    missed = covered & ~may
    assert not bool(missed.any()), (
        f"{int(missed.sum())} covered blocks rejected, first at bin "
        f"{int(missed.nonzero()[0, 0])}")
    assert bool((~may).any())  # and the test does reject blocks


def _alpha_table(pe, kind, rng):
    """The pairs of pe as the 32-row alpha table with 2 masks (an 8 x 8
    checkerboard and random texels): planes 4-6 wrap the masks every few
    pixels, slots 0-2 (0: opaque); the nonfinite kind also puts NaN and
    +-inf into a uv coefficient of every third pair."""
    n = pe.shape[1]
    pa = np.zeros((32, n))
    pa[:16] = pe.numpy()
    pa[16] = rng.uniform(-0.03, 0.03, n)
    pa[17] = rng.uniform(-0.03, 0.03, n)
    pa[18] = rng.uniform(-4, 4, n)
    pa[20] = rng.uniform(-0.03, 0.03, n)
    pa[21] = rng.uniform(-0.03, 0.03, n)
    pa[22] = rng.uniform(-4, 4, n)
    pa[24:27] = np.array([0.0, 0.0, 1.0])[:, None]
    pa[30] = rng.integers(0, 3, n)
    if kind == "nonfinite":
        for i in range(0, n, 3):
            pa[rng.choice([16, 17, 18, 20, 21, 22, 24, 25, 26]), i] = \
                rng.choice([np.nan, np.inf, -np.inf])
    yy, xx = np.mgrid[0:64, 0:64]
    masks = np.stack([
        textures.build_alpha_mask((((yy // 8) + (xx // 8)) % 2)
                                  .astype(np.float32)),
        textures.build_alpha_mask((rng.random((64, 64)) > 0.4)
                                  .astype(np.float32))])
    with np.errstate(all="ignore"):
        return torch.as_tensor(pa.astype(np.float32)), torch.as_tensor(masks)


@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("kind", ["random", "centres", "zeros", "extreme",
                                  "nonfinite"])
def test_block_test_never_rejects_an_alpha_covered_block(kind, with_z):
    """Kernels J (edges only: depth_plain with masks) and K (edges and z:
    winner_alpha_plain) on the 32-row alpha table: the alpha test only
    removes pixels, so a block the edges (and z) rule out stays out."""
    rng = np.random.default_rng(["random", "centres", "zeros", "extreme",
                                 "nonfinite"].index(kind) + 10 * with_z + 20)
    pe, pairs = _pair_table(*_planes(kind, rng))
    pa, masks = _alpha_table(pe, kind, rng)
    if with_z:
        _, vis = raster.winner_alpha_plain(pa, pairs.tile_start,
                                           pairs.tile_count, masks, NTY, NTX,
                                           1, False)
        covered = _blocks(vis >= 0)
    else:
        bits = raster.depth_plain(pa, pairs.tile_start, pairs.tile_count,
                                  NTY, NTX, 1, False,
                                  masks=masks).view(torch.int32)
        covered = _blocks(bits != 0)
    may = _may(pa, with_z)
    assert int(covered.sum()) > 10  # the masks drop some of the > 20
    missed = covered & ~may
    assert not bool(missed.any()), (
        f"{int(missed.sum())} covered blocks rejected, first at bin "
        f"{int(missed.nonzero()[0, 0])}")
    assert bool((~may).any())


@pytest.mark.parametrize("with_z", [False, True])
def test_block_test_rejects_blocks_outside_an_edge(with_z):
    """Blocks whose four corners lie clearly outside one edge (float64,
    by more than 1e-3 of the plane's scale) are rejected; so are those
    whose z is clearly out of (0, 1] at every corner."""
    rng = np.random.default_rng(5 + with_z)
    edges, z = _planes("random", rng)
    pe, _ = _pair_table(edges, z)
    may = _may(pe, with_z)
    n = edges.shape[0]
    x0 = (np.arange(n) % NTX * 128)[:, None] + np.arange(0, 128, BLK)
    y0 = np.repeat((np.arange(n) // NTX * 16)[:, None], 128 // BLK, 1)
    corners = [(x0 + dx + 0.5, y0 + dy + 0.5) for dx in (0, BLK - 1)
               for dy in (0, BLK - 1)]

    def at(pl, x, y):
        return pl[:, 0, None] * x + pl[:, 1, None] * y + pl[:, 2, None]

    scale = np.abs(edges).max(-1)  # (n, 3)
    outside = np.zeros(x0.shape, bool)
    for p in range(3):
        vals = np.stack([at(edges[:, p], x, y) for x, y in corners])
        outside |= vals.max(0) < -1e-3 * scale[:, p, None]
    if with_z:
        zs = np.stack([at(z, x, y) for x, y in corners])
        outside |= (zs.max(0) < -1e-6) | (zs.min(0) > 1 + 1e-6)
    assert outside.mean() > 0.3
    assert not bool(may.numpy()[outside].any())
    assert bool(may.numpy()[~outside].any())
