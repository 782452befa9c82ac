"""The exact rules that kernels D and F use in place of slower arithmetic,
held to the arithmetic they replace (plain PyTorch and numpy, no JAX).

Kernel D unpacks texel bytes through ops/texture.byte_table and addresses
a window's taps through ops/texture.window_bricks; sample_plain uses both,
so tests/test_torch_texture.py and tests/test_torch_texture_filter.py hold
them to the JAX package. Here: the table is the correctly rounded division
(a multiply by fl(1/255) is not), and the brick table gives the same word
as wrapping every tap's brick on the level's torus (torch.remainder), for
every texel of the window.
"""

import numpy as np
import pytest
import torch

from plainrenderer_tpu_torch.ops import texture

torch.set_num_threads(1)


def test_byte_table_is_the_correctly_rounded_division():
    b = np.arange(256, dtype=np.float32)
    table = texture.byte_table().numpy()
    assert table.dtype == np.float32
    # numpy's f32 division is IEEE: correctly rounded
    np.testing.assert_array_equal(table, b / np.float32(255.0))
    exact = b.astype(np.float64) / 255.0
    assert (np.abs(table - exact) <= np.spacing(table) / 2).all()


def test_byte_table_is_not_a_multiply_by_the_reciprocal():
    b = np.arange(256, dtype=np.float32)
    product = b * np.float32(1.0 / 255.0)
    assert int((product != texture.byte_table().numpy()).sum()) == 126


def _torus_words(base, nbx, nby, bx0, by0, xi, yi):
    """Every tap's word with its brick wrapped on the torus, as
    ops/texture.py addressed taps before window_bricks."""
    g = (lambda x: x[:, None, None])
    by = torch.remainder(g(by0) + (yi >> 3), g(torch.clamp(nby, min=1)))
    bx = torch.remainder(g(bx0) + (xi >> 7), g(torch.clamp(nbx, min=1)))
    bidx = g(base) + by * g(nbx) + bx
    return (bidx * 8 + (yi & 7)) * 128 + (xi & 127)


# (level width, level height, window origin range in bricks): levels
# larger and smaller than the 24x256 window and of its size, one brick
# column (lw <= 128), one brick in all, rows shorter than a brick (lh < 8),
# and origins far on both sides
LEVELS = {
    "large": (2048, 1024, 40),
    "wide": (4096, 16, 9),
    "tall": (128, 512, 70),
    "narrow": (64, 64, 12),
    "tiny": (16, 4, 5),
    "one_texel_row": (256, 1, 3),
    "odd": (384, 40, 11),
    "window_size": (256, 24, 4),
    "one_brick": (128, 8, 6),
}


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_window_bricks_address_like_the_torus(level):
    lw, lh, spread = LEVELS[level]
    rng = np.random.default_rng(sorted(LEVELS).index(level))
    n = 64
    nbx = torch.full((n,), (lw + 127) // 128, dtype=torch.int64)
    nby = torch.full((n,), (lh + 7) // 8, dtype=torch.int64)
    base = torch.as_tensor(rng.integers(0, 5000, n))
    bx0 = torch.as_tensor(rng.integers(-spread, spread + 1, n))
    by0 = torch.as_tensor(rng.integers(-spread, spread + 1, n))
    bx0[:4] = torch.tensor([-1, 0, -spread, spread])
    by0[:4] = torch.tensor([0, -1, spread, -spread])
    yi, xi = torch.meshgrid(torch.arange(texture.WIN_H),
                            torch.arange(texture.WIN_W), indexing="ij")
    bricks = texture.window_bricks(base, nbx, nby, bx0, by0)
    assert bricks.shape == (n, 6)
    slot = ((yi >> 3) * texture.WIN_BX + (xi >> 7)).reshape(1, -1)
    words = (torch.gather(bricks, 1, slot.expand(n, -1)).reshape(
        n, *yi.shape) * 8 + (yi & 7)) * 128 + (xi & 127)
    torus = _torus_words(base, nbx, nby, bx0, by0, xi, yi)
    assert torch.equal(words, torus)
    # every brick lies in the level: base .. base + nbx * nby - 1
    b = bricks - base[:, None]
    assert bool(((b >= 0) & (b < nbx[:, None] * nby[:, None])).all())


def test_window_bricks_int32_and_batched():
    """int32 inputs of any batch shape, as sample_plain passes per tile."""
    base = torch.tensor([[0, 7], [100, 3]], dtype=torch.int32)
    nbx = torch.tensor([[2, 1], [16, 0]], dtype=torch.int32)
    nby = torch.tensor([[3, 1], [128, 2]], dtype=torch.int32)
    bx0 = torch.tensor([[-1, 5], [15, -2]], dtype=torch.int32)
    by0 = torch.tensor([[2, -3], [127, 1]], dtype=torch.int32)
    bricks = texture.window_bricks(base, nbx, nby, bx0, by0)
    assert bricks.shape == (2, 2, 6) and bricks.dtype == torch.int32
    expect = [[base[a, c] + ((by0[a, c] + i) % max(nby[a, c], 1)) * nbx[a, c]
               + (bx0[a, c] + j) % max(nbx[a, c], 1)
               for i in range(3) for j in range(2)]
              for a in range(2) for c in range(2)]
    assert bricks.reshape(4, 6).tolist() == [[int(e) for e in row]
                                             for row in expect]
