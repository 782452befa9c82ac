"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where torch sees no CUDA device (the decision is
made in the fixture, never at import). Run on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Kernels A and C must equal their plain versions exactly; kernel B's
visibility too (both evaluate a*x + (b*y + c) with separately rounded
multiplies and adds), its channels within 1e-4 (rsqrt may differ by an
ulp between the kernel and PyTorch's CUDA rsqrt).
"""

import numpy as np
import pytest
import torch

from plainrenderer_tpu_torch import native
from plainrenderer_tpu_torch.ops import post, raster

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _random_setup(rng, n, width, height, bin_rows, device):
    """Random screen triangles through the port's own geometry stage."""
    cx, cy = rng.uniform(0.05, 0.95, (2, n))
    size = rng.uniform(0.01, 0.3, n)
    z = rng.uniform(0.05, 0.99, n)
    tris = np.stack([np.stack([cx - size, cy - size, z], -1),
                     np.stack([cx + size, cy - size, z], -1),
                     np.stack([cx, cy + size, z], -1)], 1).astype(np.float32)
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0] = vp[1, 1] = 2.0
    vp[0, 3] = vp[1, 3] = -1.0
    unit = rng.normal(size=(n, 3, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    arrays = [tris, rng.random((n, 3, 2)).astype(np.float32), unit, unit,
              unit, rng.integers(0, 40, n).astype(np.float32),
              np.ones(n, bool), vp]
    t = [torch.as_tensor(a, device=device) for a in arrays]
    return raster.geometry_setup(*t, width, height, cull="none",
                                 bin_rows=bin_rows)


@pytest.mark.parametrize("order_rows,bin_rows,budget",
                         [(False, 1, None), (True, 2, None), (True, 2, 512)])
def test_expand_keys_kernel_equals_plain(cuda, order_rows, bin_rows, budget):
    rng = np.random.default_rng(11)
    setup = _random_setup(rng, 3000, 512, 256, bin_rows, cuda)
    nty, ntx = 256 // (16 * bin_rows), 512 // 128
    ki = raster.pair_key_inputs(setup, nty, ntx, budget, bin_rows,
                                order_rows)
    before = native.launch_counts()["expand_keys"]
    keys, owners = raster.expand_keys(ki)
    assert native.launch_counts()["expand_keys"] == before + 1
    keys_p, owners_p = raster.expand_keys_plain(ki)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)
    torch.testing.assert_close(owners, owners_p, rtol=0, atol=0)


@pytest.mark.parametrize("sub,row_skip", [(1, False), (2, True), (4, True)])
def test_gbuffer_kernel_equals_plain(cuda, sub, row_skip):
    rng = np.random.default_rng(12)
    width, height = 384, 256
    setup = _random_setup(rng, 400, width, height, sub, cuda)
    nty, ntx = height // (16 * sub), width // 128
    pairs = raster.build_pairs(setup, nty, ntx, bin_rows=sub,
                               order_rows=row_skip)
    pe, pa = raster.gather_pair_setups(setup, pairs, row_extents=row_skip)
    depth, vis, gbuf = raster.rasterize_gbuffer(pe, pa, pairs, nty, ntx,
                                                sub=sub, row_skip=row_skip)
    depth_p, vis_p, gbuf_p = raster.gbuffer_plain(
        pe, pa, pairs.tile_start, pairs.tile_count, nty, ntx, sub, row_skip)
    assert (vis >= 0).float().mean() > 0.5
    torch.testing.assert_close(vis, vis_p, rtol=0, atol=0)
    torch.testing.assert_close(depth, depth_p, rtol=0, atol=0)
    torch.testing.assert_close(gbuf, gbuf_p, rtol=0, atol=1e-4)


def test_gbuffer_kernel_empty_bins(cuda):
    """No pairs at all: every pixel uncovered, all channels 0."""
    pairs = raster.PairLists(
        pair_tri=torch.zeros(256, dtype=torch.int32, device=cuda),
        tile_start=torch.zeros(8, dtype=torch.int32, device=cuda),
        tile_count=torch.zeros(8, dtype=torch.int32, device=cuda),
        overflow=torch.zeros((), dtype=torch.int32, device=cuda))
    depth, vis, gbuf = raster.rasterize_gbuffer(
        torch.zeros((16, 256), device=cuda),
        torch.zeros((32, 256), device=cuda), pairs, 4, 2, sub=1)
    assert (vis == -1).all() and (depth == 0).all() and (gbuf == 0).all()


def test_material_kernel_equals_plain(cuda):
    rng = np.random.default_rng(13)
    table = post.material_table_lanes(
        torch.as_tensor(rng.random((45, 8)).astype(np.float32), device=cuda))
    ids = torch.as_tensor(rng.uniform(-5, 200, (64, 256)).astype(np.float32),
                          device=cuda)
    valid = torch.as_tensor(rng.random((64, 256)) > 0.3, device=cuda)
    out = post.material_kernel(table, ids, valid)
    torch.testing.assert_close(out, post.material_plain(table, ids, valid),
                               rtol=0, atol=0)


def test_wrappers_refuse_mixed_devices(cuda):
    table = torch.zeros((8, 128), device=cuda)
    with pytest.raises(ValueError):
        post.material_kernel(table, torch.zeros((16, 128)),
                             torch.zeros((16, 128), dtype=torch.bool))
