"""Kernel L's plain mirror, held bit for bit to the per-pixel path it
replaces (plain PyTorch, no JAX).

Kernel L rounds every pair's attribute rows once into a pair-major table
(ops/raster.py:attr_table_plain) and reads each winner's record
(attr_resolve_table_plain); the channels must equal attr_resolve_plain's,
which rounds per pixel. The JAX comparison of the plain version stays in
tests/test_torch_alpha.py.
"""

import numpy as np
import pytest
import torch

from plainrenderer_tpu_torch.ops import raster

torch.set_num_threads(1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _pair_attrs(rng, rows, n_pairs):
    """Attribute rows with values that split-round with a nonzero low part,
    some exact bf16 values and zeros."""
    a = rng.normal(size=(rows, n_pairs)) * np.exp(rng.uniform(-6, 6,
                                                              (rows,
                                                               n_pairs)))
    a[:, ::7] = np.round(a[:, ::7])
    a[rows - 2:] = 0.0  # the padding rows
    a[0] = np.abs(a[0]) + 0.5  # the 1/w plane: w > 0 over the screen
    return torch.as_tensor(a.astype(np.float32))


@pytest.mark.parametrize("rows", [32, 40])
def test_attr_table_is_the_split_rounded_rows(rows):
    pa = _pair_attrs(np.random.default_rng(5), rows, 300)
    table = raster.attr_table_plain(pa)
    n_attr = raster.NATTR_PREV if rows == 40 else raster.NATTR
    assert table.shape == (300, rows)
    assert torch.equal(_bits(table[:, :n_attr].T),
                       _bits(raster._split_round(pa[:n_attr])))
    assert not bool(table[:, n_attr:].any())


@pytest.mark.parametrize("sub,rows,lead", [(1, 32, 0), (2, 32, 37),
                                           (3, 40, 5), (4, 40, 100)])
def test_attr_resolve_table_is_attr_resolve_plain(sub, rows, lead):
    """Per-pixel vis with uncovered pixels, several winners per bin, bins
    whose segments start off the 128-pair grid (lead), and slots that the
    n_pairs - 1 clamp catches."""
    rng = np.random.default_rng(11 + sub)
    nty, ntx = 2, 3
    n_bins = nty * ntx
    counts = rng.integers(1, 60, n_bins)
    starts = lead + np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_pairs = int(starts[-1] + counts[-1])
    pa = _pair_attrs(rng, rows, n_pairs)
    h, w = nty * sub * 16, ntx * 128
    bin_of = (np.arange(h)[:, None] // (16 * sub)) * ntx \
        + np.arange(w)[None] // 128
    lead_px = (starts % 128)[bin_of]
    vis = lead_px + rng.integers(0, counts[bin_of] + 2)  # past the end too
    vis[rng.random((h, w)) < 0.3] = -1
    vis[:16, :64] = -1  # a whole uncovered corner
    vis = torch.as_tensor(vis.astype(np.int32))
    tile_start = torch.as_tensor(starts.astype(np.int32))
    ref = raster.attr_resolve_plain(pa, tile_start, vis, nty, ntx, sub)
    got = raster.attr_resolve_table_plain(raster.attr_table_plain(pa),
                                          tile_start, vis, nty, ntx, sub)
    assert got.shape == ref.shape == (15 if rows == 40 else 13, h, w)
    assert torch.equal(_bits(got), _bits(ref))
    via_wrapper = raster.resolve_attributes(pa, tile_start, vis, nty, ntx,
                                            sub)
    assert torch.equal(_bits(via_wrapper), _bits(ref))
    assert bool((ref[:, vis < 0] == 0).all())
    assert float((vis >= 0).float().mean()) > 0.5
