"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where torch sees no CUDA device (the decision is
made in the fixture, never at import). Run on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Kernels A, C and E must equal their plain versions exactly; kernel B's
visibility too (both evaluate a*x + (b*y + c) with separately rounded
multiplies and adds), its channels within 1e-4 (rsqrt may differ by an
ulp between the kernel and PyTorch's CUDA rsqrt). Kernel D: the ok
channel equal, values within 1e-5 where ok; kernel F: >= 99.9% of pixels
equal, the rest within 1/taps (the CPU tests' rules against the JAX
package). Kernel G: escaped and the hit/miss decision equal on >= 99.9%
of rays, values within 1e-4 (abs + rel) where both agree (powf / rsqrtf
may differ by an ulp from torch.pow / torch.rsqrt); kernels H and I: ok
equal on every pixel, values within 1e-6 relative. The alpha-tested
kernels: J (both bodies), K and M equal their plain versions exactly (the
mask bit is a discrete function of u, so the uv math is rounded step by
step on both sides), L's channels within kernel B's 1e-4. The dynamic
scene's branches: B and L with the 40-row pair table (15 channels, the
previous NDC within the same 1e-4), D under trilinear, anisotropic and
both filters (its rule above), M at the main view's 56 rows (exact).
Kernels D and F also run on hand-made edge cases (_texture_edge_inputs,
_shadow_world) and F at 1 and 16 taps and 1 and 4 cascades.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from plainrenderer_tpu_torch import config, native
from plainrenderer_tpu_torch.assets import procedural, sdf_bake, textures
from plainrenderer_tpu_torch.ops import color_packing, post, raster
from plainrenderer_tpu_torch.ops import sdf_scene, sdfgi
from plainrenderer_tpu_torch.ops import shadow, taa, texture
from plainrenderer_tpu_torch.render import frame, scenebuild
from plainrenderer_tpu_torch.render.state import FrameState, initial_state
from plainrenderer_tpu_torch.scene import camera as cam_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _prev_args(rng, tris, device):
    """A dynamic scene's setup keywords: the corners moved by up to 0.02
    and a previous view-projection with a perspective w row."""
    prev_vp = np.eye(4, dtype=np.float32)
    prev_vp[0, 0] = prev_vp[1, 1] = 2.0
    prev_vp[0, 3], prev_vp[1, 3], prev_vp[3, 2] = -0.98, -1.0, 0.5
    prev = (tris + rng.uniform(-0.02, 0.02, tris.shape)).astype(np.float32)
    return dict(prev_view_proj=torch.as_tensor(prev_vp, device=device),
                prev_corners=torch.as_tensor(prev, device=device))


def _random_setup(rng, n, width, height, bin_rows, device, prev=False):
    """Random screen triangles through the port's own geometry stage (with
    prev, a dynamic scene's previous-frame clip planes too)."""
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
    return raster.geometry_setup(
        *t, width, height, cull="none", bin_rows=bin_rows,
        **(_prev_args(rng, tris, device) if prev else {}))


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


def _edge_case_attrs(rng, n_pairs, prev, device):
    """Attribute rows for hand-made pairs: random planes with 1/w and the
    previous clip w near 1, so every channel is finite."""
    attrs = rng.uniform(-1, 1, (40 if prev else 32, n_pairs)) * 1e-2
    attrs[2] = 1.0  # the 1/w plane's constant
    if prev:
        attrs[38] = 1.0  # the previous clip w plane's constant
    return torch.as_tensor(attrs.astype(np.float32), device=device)


@pytest.mark.parametrize("sub,row_skip,prev,case",
                         [(1, False, False, "random"),
                          (2, True, False, "random"),
                          (4, True, False, "random"),
                          (2, True, True, "random"),
                          (2, True, False, "edges"),
                          (1, False, True, "edges")])
def test_gbuffer_kernel_equals_plain(cuda, sub, row_skip, prev, case):
    """Kernel B; with prev, a dynamic scene's 40-row pair table and its 15
    channels. The edges case: kernel E's hand-made pair lists (bins of
    more than its CHUNK pairs, whose slices merge before the resolve;
    one-pixel triangles; a pair spanning a bin; edges exactly 0 at pixel
    centres; NaN and inf coefficients in the edges and in z)."""
    rng = np.random.default_rng(12)
    width, height = 384 if case == "random" else 512, 256
    nty, ntx = height // (16 * sub), width // 128
    if case == "random":
        setup = _random_setup(rng, 400, width, height, sub, cuda, prev=prev)
        pairs = raster.build_pairs(setup, nty, ntx, bin_rows=sub,
                                   order_rows=row_skip)
        pe, pa = raster.gather_pair_setups(setup, pairs,
                                           row_extents=row_skip)
    else:
        pe, pairs = _depth_edge_cases(cuda, rng, nty, ntx, sub)
        pa = _edge_case_attrs(rng, pe.shape[1], prev, cuda)
        assert int(pairs.tile_count.max()) > 2 * 256
    depth, vis, gbuf = raster.rasterize_gbuffer(pe, pa, pairs, nty, ntx,
                                                sub=sub, row_skip=row_skip)
    depth_p, vis_p, gbuf_p = raster.gbuffer_plain(
        pe, pa, pairs.tile_start, pairs.tile_count, nty, ntx, sub, row_skip)
    assert (vis >= 0).float().mean() > 0.5
    assert gbuf.shape[0] == (15 if prev else 13) and pa.shape[0] == (
        40 if prev else 32)
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


def _atlas_setup(device, sres=512):
    """The small atrium's 3-cascade shadow atlas set up on `device`."""
    rs = scenebuild.build_render_scene(procedural.build_atrium_scene(
        procedural.AtriumConfig(columns_per_row=2, floor_subdiv=2,
                                box_count=3, box_subdiv=1,
                                column_segments=8), textured=False))
    scene = frame.scene_to_device(rs, device=device)
    def vec(v):
        v = np.asarray(v, np.float32)
        return torch.as_tensor(v / np.linalg.norm(v), device=device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    mats, splits, scales = shadow.compute_cascade_info(
        f(0.004), f(0.3), f([-3.0, -1.8, 0.3]), vec([0.94, 0.14, 0.31]),
        vec([0.13, -0.99, 0.04]), vec([-0.31, 0.0, 0.95]), 0.3153, 16 / 9,
        0.1, 300.0, vec([0.3, -0.8, 0.45]), 3, f(3.0), f(30.0))
    setup = frame.shadow_atlas_setup(scene, mats, 3, sres)
    sub = frame.shadow_bin_sub(sres)
    return setup, sub, 3 * sres // (16 * sub), sres // 128, (mats, splits,
                                                              scales)


def test_expand_keys_kernel_multiview_equals_plain(cuda):
    """Kernel A with the atlas's view-local keys (n_views=3)."""
    setup, sub, nb, ntx, _ = _atlas_setup(cuda)
    ki = raster.pair_key_inputs(setup, nb, ntx, None, sub, True, n_views=3)
    assert ki.tpv * 3 == setup.valid.shape[0]
    keys, owners = raster.expand_keys(ki)
    keys_p, owners_p = raster.expand_keys_plain(ki)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)
    torch.testing.assert_close(owners, owners_p, rtol=0, atol=0)


def _tri_planes(v):
    """Edge planes (a, b, c) of the pixel-space triangle v (3, 2), each >= 0
    inside, as float64 (3, 3)."""
    out = []
    for i in range(3):
        (x0, y0), (x1, y1) = v[i], v[(i + 1) % 3]
        pl = np.array([y0 - y1, x1 - x0, x0 * y1 - x1 * y0])
        if pl @ np.array([*v[(i + 2) % 3], 1.0]) < 0:
            pl = -pl
        out.append(pl)
    return np.stack(out)


def _depth_edge_cases(device, rng, nb, ntx, sub):
    """Hand-made depth-raster pair lists on an (nb * sub * 16) x (ntx * 128)
    atlas: random triangles in every bin; 600 tiny ones in bin 0 and 257
    in bin 1 (more than DEPTH_CHUNK: slices that merge); one-pixel
    triangles; a triangle spanning a whole bin; edges exactly 0 on columns,
    rows and diagonals of pixel centres; NaN, +-inf, +-0, huge and tiny
    coefficients in the edge and z planes. Returns (pair_edges (16, P),
    PairLists)."""
    rows = sub * 16
    bins = [[] for _ in range(nb * ntx)]

    def add(b, v=None, planes=None, z=None, fy=None):
        ty, tx = divmod(b, ntx)
        if planes is None:
            planes = _tri_planes(np.asarray(v, np.float64))
        if z is None:
            z = np.array([rng.uniform(-2e-3, 2e-3), rng.uniform(-2e-3, 2e-3),
                          rng.uniform(-0.3, 1.3)])
        if fy is None and v is not None:
            ys = np.asarray(v)[:, 1]
            fy = (np.floor(ys.min() / 16), np.floor(ys.max() / 16))
        if fy is None:
            fy = (ty * sub, ty * sub + sub - 1)
        col = np.zeros(16)
        for p in range(3):
            col[4 * p:4 * p + 3] = planes[p]
        col[12:15] = z
        col[3], col[7] = fy
        bins[b].append(col)

    def rand_tri(b, lo, hi):
        ty, tx = divmod(b, ntx)
        c = np.array([tx * 128 + rng.uniform(0, 128),
                      ty * rows + rng.uniform(0, rows)])
        return c + rng.uniform(lo, hi) * rng.normal(size=(3, 2))

    for b in range(nb * ntx):
        for _ in range(rng.integers(3, 20)):
            add(b, rand_tri(b, 1, 40))
    for _ in range(600):
        add(0, rand_tri(0, 0.3, 4))
    for _ in range(257):
        add(1, rand_tri(1, 0.5, 10))
    for b in range(nb * ntx):
        ty, tx = divmod(b, ntx)
        x0, y0 = tx * 128, ty * rows
        for _ in range(4):  # one pixel centre each
            cx = x0 + rng.integers(0, 128) + 0.5
            cy = y0 + rng.integers(0, rows) + 0.5
            add(b, [[cx - 0.4, cy - 0.3], [cx + 0.4, cy - 0.3],
                    [cx, cy + 0.4]])
        if b % 3 == 0:  # the whole bin
            add(b, [[x0 - 900.0, y0 - 900.0], [x0 + 5000.0, y0 - 900.0],
                    [x0 - 900.0, y0 + 5000.0]],
                z=np.array([0.0, 0.0, 0.25 + 0.01 * b]))
        cx = x0 + rng.integers(8, 100) + 0.5
        cy = y0 + rng.integers(2, rows - 8) + 0.5
        add(b, [[cx, cy], [cx, cy + 40.0], [cx + 20.0, cy]])  # e = 0 on x
        add(b, [[cx - 9.0, cy + 3.0], [cx + 9.0, cy + 3.0],
                [cx, cy - 6.0]])  # e = 0 on a row of centres
        add(b, [[cx - 7.0, cy - 7.0], [cx + 7.0, cy + 7.0],
                [cx + 7.0, cy - 7.0]])  # e = 0 on a diagonal
        base = _tri_planes(np.asarray(rand_tri(b, 8, 30), np.float64))
        odd = [(0, 0, np.nan), (1, 2, np.inf), (2, 2, -np.inf),
               (0, 1, np.inf), (1, 0, -0.0), (2, 1, 1e30), (0, 2, 1e-38)]
        for p, k, val in odd:  # an edge coefficient replaced
            planes = base.copy()
            planes[p, k] = val
            add(b, planes=planes)
        for k, val in ((0, np.nan), (2, np.inf), (2, -np.inf), (1, 1e30),
                       (0, -0.0), (2, -0.0), (1, 1e-38)):
            z = np.array([1e-3, -1e-3, 0.5])
            z[k] = val
            add(b, planes=base, z=z)
    counts = np.array([len(c) for c in bins], np.int32)
    cols = np.concatenate([np.stack(c, 1) for c in bins], 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                      device=device)
    with np.errstate(all="ignore"):
        edges = t(cols, np.float32)
    pairs = raster.PairLists(
        pair_tri=t(np.zeros(cols.shape[1]), np.int32),
        tile_start=t(starts, np.int32), tile_count=t(counts, np.int32),
        overflow=t(0, np.int32))
    return edges, pairs


@pytest.mark.parametrize("sub,row_skip,case",
                         [(8, True, "atlas"), (2, False, "random"),
                          (8, True, "edges"), (8, False, "edges"),
                          (2, True, "edges")])
def test_depth_kernel_equals_plain(cuda, sub, row_skip, case):
    """Kernel E: the atlas depth bit for bit (work items merged by
    atomicMax), a random screen at another bin height, and hand-made pair
    lists: bins of more than DEPTH_CHUNK pairs, one-pixel triangles, a
    pair spanning a bin, edges exactly 0 at pixel centres, NaN and inf
    coefficients (a NaN z writes the card's canonical NaN bits)."""
    if case == "atlas":
        setup, sub, nb, ntx, _ = _atlas_setup(cuda)
        pairs = raster.build_pairs(setup, nb, ntx, bin_rows=sub,
                                   order_rows=True, n_views=3,
                                   tile_cap=1 << 15)
    elif case == "random":
        setup = _random_setup(np.random.default_rng(14), 3000, 512, 256,
                              sub, cuda)
        nb, ntx = 256 // (16 * sub), 4
        pairs = raster.build_pairs(setup, nb, ntx, bin_rows=sub,
                                   tile_cap=1 << 15)
    if case == "edges":
        nb, ntx = 256 // (16 * sub), 4
        pe, pairs = _depth_edge_cases(cuda, np.random.default_rng(31), nb,
                                      ntx, sub)
        assert int(pairs.tile_count.max()) > 4 * raster.DEPTH_CHUNK
    else:
        pe, _ = raster.gather_pair_setups(setup, pairs, row_extents=row_skip,
                                          with_attrs=False)
    before = native.launch_counts()["depth"]
    depth = raster.rasterize_depth(pe, pairs, nb, ntx, sub=sub,
                                   row_skip=row_skip)
    assert native.launch_counts()["depth"] == before + 1
    depth_p = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count, nb,
                                 ntx, sub, row_skip)
    assert (depth > 0).float().mean() > 0.3
    torch.testing.assert_close(depth.view(torch.int32),
                               depth_p.view(torch.int32), rtol=0, atol=0)
    if case == "edges":
        bits = depth.view(torch.int32)
        assert bool((bits == 0x7FFFFFFF).any())  # a NaN z covered
        assert bool((bits == 0).any())


def _texture_edge_inputs(rng, h, w):
    """Tiles that the random layout may miss (mat_tex [0, 1, -1, 2, 3]):
    an all-invalid tile; an untextured dominant material (2) with a
    textured second (1); four materials in one tile; uv across the wrap
    seam and far from [0, 1) (u near 1000, v near -37); derivatives 50x
    larger in the bottom tile row, so the mip levels are smaller than the
    24x256 window; the rest random 8x64 blocks of materials."""
    mat = rng.integers(0, 5, (h // 8, w // 64)).repeat(8, 0).repeat(64, 1)
    valid = rng.random((h, w)) > 0.1
    valid[0:16, 0:128] = False
    mat[0:16, 128:224] = 2
    mat[0:16, 224:256] = 1
    mat[0:16, 256:384] = np.repeat([0, 1, 3, 4], [50, 30, 28, 20])
    mat[16:32, 128:256] = 3
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    u = 0.9 + xs * 0.003 + ys * 0.0004
    v = 0.3 + ys * 0.002 - xs * 0.0002
    u[16:48] += 1000.0
    v[32:64] -= 37.0
    u[64:80] = 0.995 + xs[64:80] * 0.0001  # the seam inside each tile
    duv = np.abs(rng.normal(0.002, 0.002, (4, h, w)))
    duv[:, h - 16:] *= 50.0
    return (np.stack([u, v]).astype(np.float32), duv.astype(np.float32),
            mat.astype(np.float32), valid)


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("two_mat", [True, False])
@pytest.mark.parametrize("filters", [
    {}, dict(trilinear=True), dict(aniso=True),
    dict(trilinear=True, aniso=True)])
def test_texture_kernel_equals_plain(cuda, filters, two_mat, case):
    """Kernel D's bilinear variant and its trilinear, anisotropic and
    trilinear + anisotropic ones, with and without two_mat, on random
    tiles and on the edge cases of _texture_edge_inputs."""
    rng = np.random.default_rng(15)
    mats = [procedural.procedural_texture([0.7, 0.4, 0.3], kind, size=size,
                                          seed=i)
            for i, (kind, size) in enumerate(
                [("checker", 512), ("brick", 64), ("marble", 256),
                 ("checker", 16)])]
    pool = textures.build_texture_pool(mats)
    h, w = 128, 384
    if case == "random":
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        uv = np.stack([0.9 + xs * 0.003 + ys * 0.0004,
                       0.3 + ys * 0.002 - xs * 0.0002]).astype(np.float32)
        duv = np.abs(rng.normal(0.002, 0.002, (4, h, w))).astype(np.float32)
        mat = (rng.integers(0, 5, (h // 8, w // 64)).repeat(8, 0)
               .repeat(64, 1)).astype(np.float32)
        valid = rng.random((h, w)) > 0.1
    else:
        uv, duv, mat, valid = _texture_edge_inputs(rng, h, w)
    args = [torch.as_tensor(a, device=cuda) for a in (
        uv, duv, mat, valid, np.asarray([0, 1, -1, 2, 3], np.int32),
        pool.info, pool.word0, pool.word1)]
    kw = dict(n_mips=pool.n_mips, two_mat=two_mat, **filters)
    before = native.launch_counts()["texture"]
    out = texture.sample_materials(*args, **kw)
    assert native.launch_counts()["texture"] == before + 1
    ref = texture.sample_plain(*args, **kw)
    torch.testing.assert_close(out[8], ref[8], rtol=0, atol=0)
    ok = ref[8] > 0.5
    if case == "random":
        # a filtered pixel is ok only where every tap of both windows is
        assert (0.1 if filters else 0.2) < float(ok.float().mean()) < 0.95
    else:
        assert not bool(ok[0:16, 0:128].any())  # all invalid
        assert not bool(ok[0:16, 128:224].any())  # untextured dominant
        second = bool(ok[0:16, 224:256].any())
        assert second == (two_mat and not filters.get("trilinear", False))
        assert bool(ok[16:64].any()) and bool(ok[64:80].any())
        assert bool(ok[h - 16:].any())
    torch.testing.assert_close(out[:8][:, ok], ref[:8][:, ok], rtol=0,
                               atol=1e-5)


def _shadow_world(rng, case, h, w):
    """World positions and linear depth: random points over the atrium
    (every tile straddles every cascade), a depth ramp across the screen
    (tiles at a split straddle two), or points 3x farther out (many taps
    leave the map)."""
    cam = np.float32([-3.0, -1.8, 0.3])
    fwd = np.asarray([0.94, 0.14, 0.31], np.float32)
    fwd /= np.linalg.norm(fwd)
    if case == "ramp":
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        side = np.float32([-0.31, 0.0, 0.95])
        depth = 0.2 + xs * (30.0 / w) + ys * 0.01
        world = (cam[:, None, None] + fwd[:, None, None] * depth
                 + side[:, None, None] * (ys - h / 2) * 0.05)
    else:
        world = np.stack([rng.uniform(-1, 12, (h, w)),
                          rng.uniform(-6, 0, (h, w)),
                          rng.uniform(-5.5, 5.5, (h, w))])
        if case == "edge":
            world = cam[:, None, None] + 3.0 * (world - cam[:, None, None])
    lin = np.einsum("c,chw->hw", fwd, world - cam[:, None, None])
    lin[rng.random((h, w)) < 0.05] = 0.0
    return world.astype(np.float32), lin.astype(np.float32)


@pytest.mark.parametrize("case,cascades,taps", [
    ("random", 3, 12), ("ramp", 3, 12), ("edge", 3, 12), ("random", 1, 12),
    ("random", 4, 12), ("random", 3, 1), ("random", 3, 16)])
def test_shadow_kernel_equals_plain(cuda, case, cascades, taps):
    """Kernel F at the default 12 taps and at run-time counts 1 and 16,
    with 1, 3 and 4 cascades, on tiles that straddle cascades and with
    taps off the map edge."""
    setup, sub, nb, ntx, (mats, splits, scales) = _atlas_setup(cuda)
    pairs = raster.build_pairs(setup, nb, ntx, bin_rows=sub, order_rows=True,
                               n_views=3, tile_cap=1 << 15)
    pe, _ = raster.gather_pair_setups(setup, pairs, row_extents=True,
                                      with_attrs=False)
    atlas = raster.rasterize_depth(pe, pairs, nb, ntx, sub=sub,
                                   row_skip=True).reshape(3, 512, 512)
    maps = torch.cat([atlas, atlas[:1] if cascades == 4
                      else torch.zeros_like(atlas[:1])])
    if cascades != 3:
        def vec(v):
            v = np.asarray(v, np.float32)
            return torch.as_tensor(v / np.linalg.norm(v), device=cuda)
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=cuda)
        mats, splits, scales = shadow.compute_cascade_info(
            f(0.004), f(0.3), f([-3.0, -1.8, 0.3]), vec([0.94, 0.14, 0.31]),
            vec([0.13, -0.99, 0.04]), vec([-0.31, 0.0, 0.95]), 0.3153,
            16 / 9, 0.1, 300.0, vec([0.3, -0.8, 0.45]), cascades, f(3.0),
            f(30.0))
    rng = np.random.default_rng(16)
    h, w = 64, 256
    world, lin = _shadow_world(rng, case, h, w)
    args = [torch.as_tensor(a.astype(np.float32), device=cuda)
            for a in (world, lin, rng.random((h, w)))]
    before = native.launch_counts()["shadow"]
    out = shadow.shadow_resolve(*args, maps, mats, scales, splits, cascades,
                                taps=taps)
    assert native.launch_counts()["shadow"] == before + 1
    rows = shadow.cascade_rows(mats, scales, splits)
    words = []
    ref = shadow.shadow_resolve_plain(
        *args, shadow.pack_shadow_maps_u16(maps), rows, cascades, taps,
        shadow.SHADOW_SAMPLE_RADIUS, 512, words=words)
    diff = (out - ref).abs()
    assert float((diff == 0).float().mean()) >= 0.999
    assert float(diff.max()) <= 1.0 / taps + 1e-6
    valid = args[1] > 0
    in_map = sum(int(wd.numel()) for wd in words)
    if case == "edge":  # many taps read no word: they left the map
        assert in_map < 0.9 * taps * int(valid.sum())
    if case in ("ramp", "random") and cascades > 1:
        cas = torch.zeros_like(args[1], dtype=torch.int64)
        for c in range(cascades - 1):
            cas += (args[1] >= rows[c, 18]).long()
        per_tile = [len(torch.unique(cas[y:y + 16, x:x + 128][
            valid[y:y + 16, x:x + 128]]))
            for y in range(0, h, 16) for x in range(0, w, 128)]
        assert max(per_tile) >= 2


def _gi_case(device, seed=7, h=64, w=256):
    """A 2 m box (port bake on the card) in a 14 m volume, and rays from a
    1.6 m sphere around it: half the surfaces face the box, a third of the
    pixels are empty (one tile fully), the sky is shifted by -10 so that a
    miss reads negative Y."""
    mesh = procedural.box_mesh(2.0, 2.0, 2.0)
    vol = sdf_bake.bake_mesh_sdf(mesh.positions, mesh.indices,
                                 resolution=(16, 16, 16), device=device)
    g = sdf_scene.composite_global_sdf(
        [vol], np.asarray([[-1.0] * 3], np.float32),
        np.asarray([[1.0] * 3], np.float32), np.eye(4, dtype=np.float32)[None],
        np.asarray([[0.8, 0.2, 0.1]], np.float32), margin=6.0)
    scene = frame.attach_global_sdf(
        {"corners": torch.zeros(1, device=device)}, g)
    rng = np.random.default_rng(seed)
    radial = rng.normal(size=(3, h, w))
    radial /= np.linalg.norm(radial, axis=0)
    normal = radial * np.where(rng.random((h, w)) < 0.5, -1.0, 1.0)
    dirs = rng.normal(size=(3, h, w))
    dirs /= np.linalg.norm(dirs, axis=0)
    dirs = normal * 1.5 + dirs
    dirs /= np.linalg.norm(dirs, axis=0)
    wpos = radial * 1.6 + rng.normal(scale=0.05, size=(3, h, w))
    valid = rng.random((h, w)) < 0.66
    valid[:16, :128] = False
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return scene, dict(world_pos=t(wpos), normal=t(normal), ray_dirs=t(dirs),
                       valid=torch.as_tensor(valid, device=device),
                       sky_lowres=t(rng.random((3, 32, 64)) - 10.0))


def _escaping_tile(rays):
    """Rays of tile (1, 0) leave the box along the outward radial: every
    one escapes the fine window."""
    radial = rays["world_pos"][:, 16:32, :128]
    radial = radial / radial.norm(dim=0, keepdim=True)
    for key in ("normal", "ray_dirs"):
        rays[key][:, 16:32, :128] = radial
    rays["valid"][16:32, :128] = True
    return rays


def _window_edge_rays(scene, rays, ty, tx, n=5):
    """Rays of tile (ty, tx) whose first sample lies at window x -0.5 and
    31.5 and the f32 values beside them (the edges of the trace's
    `inside`, which kernel G takes from the clamp excess): normal x 0, so
    the sample's x is wpos x, and y, z at the tile's mean, inside the
    window. Returns the mask of those rays."""
    wpos, valid, normal = rays["world_pos"], rays["valid"], rays["normal"]
    dev = wpos.device
    meta = sdfgi.trace_meta(scene["sdf_origin"], scene["sdf_voxel_size"],
                            7.5, torch.zeros(3, device=dev),
                            torch.zeros(3, device=dev),
                            torch.zeros((), device=dev))
    dims = scene["sdf_grid"]
    f32 = np.float32
    ox, inv = f32(meta[0].item()), f32(meta[4].item())
    rows, cols = slice(ty * 16, ty * 16 + 16), slice(tx * 128, tx * 128 + 128)
    sel = valid[rows, cols]
    mean = wpos[:, rows, cols][:, sel].mean(dim=1)
    mask = torch.zeros_like(valid)
    mask[ty * 16, tx * 128:tx * 128 + 2 * n] = True
    wpos[1:, mask] = mean[1:, None]
    normal[0, mask] = 0.0
    valid[mask] = True
    tile = ty * (wpos.shape[2] // 128) + tx
    bx0 = int(sdfgi.window_bricks(wpos, valid, meta, dims)[0][tile])
    wx0 = f32(bx0 * 16)
    xs = []
    for target in (f32(-0.5), f32(31.5)):
        # the f32 x values around the target and the window x each gives,
        # computed as the trace does: (x - origin) * (1 / voxel) - wx0
        x0 = f32(ox + (float(wx0) + float(target)) / float(inv))
        cand = [x0]
        for _ in range(64):
            cand = [np.nextafter(cand[0], f32(-np.inf)), *cand,
                    np.nextafter(cand[-1], f32(np.inf))]
        cand = np.asarray(cand, f32)
        g = (cand - ox) * inv - wx0
        _, first = np.unique(g, return_index=True)
        i = int(np.searchsorted(g[first], target))
        assert g[first][i - 1] < target <= g[first][i]
        xs.append(cand[first][i - n // 2:i - n // 2 + n])
    wpos[0, mask] = torch.as_tensor(np.concatenate(xs), device=dev)
    assert int(sdfgi.window_bricks(wpos, valid, meta, dims)[0][tile]) == bx0
    return mask


def _plane_gi_case(device, dims, seed=9, h=32, w=256):
    """A floor and, 6 m above it (world y), a ceiling over x < W / 2 -
    3.2 m (a quarter of the rays' x range) of a synthetic volume of dims (D, H, W) voxels of 0.25 m, random
    albedo, and rays from points between them, facing up from mid-air or
    down from the ceiling: some hit in the window, most escape it and hit
    in the coarse volume, the rays up from the open half see the sky (they
    start 3 m above the floor, a coarse voxel or more at factor 8 or
    16)."""
    d, hh, ww = dims
    voxel = 0.25
    y = torch.arange(hh, device=device, dtype=torch.float32)[:, None] * voxel
    x = torch.arange(ww, device=device, dtype=torch.float32)[None] * voxel
    y0 = 0.5 * hh * voxel - 3.0
    edge = 0.5 * ww * voxel - 3.2
    ceiling = torch.sqrt(torch.clamp_min(x - edge, 0.0) ** 2
                         + (y0 + 6.0 - y) ** 2)
    vol = torch.minimum(y - y0, ceiling)[None].expand(d, hh, ww).contiguous()
    sdf_packed = sdfgi.quantize_sdf_volume(vol, voxel)
    del vol
    g = torch.Generator(device=device).manual_seed(seed)
    nb = sdf_packed.shape[0]
    alb_packed = torch.randint(0, 1 << 24, (nb, 32, 128), generator=g,
                               device=device, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    up = rng.random((h, w)) < 0.5
    n = np.zeros((3, h, w))
    n[1] = np.where(up, 1.0, -1.0)
    dirs = rng.normal(size=(3, h, w))
    dirs /= np.linalg.norm(dirs, axis=0)
    dirs = n * 1.2 + dirs
    dirs /= np.linalg.norm(dirs, axis=0)
    rows, cols = np.mgrid[0:h, 0:w] - np.asarray([h, w])[:, None, None] / 2
    wpos = np.stack([0.5 * ww * voxel + 0.05 * cols,  # a tile spans 6.4 m
                     np.where(up, y0 + 3.0, y0 + 5.7),
                     0.5 * d * voxel + 0.05 * rows
                     + rng.uniform(-0.1, 0.1, (h, w))])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    rays = dict(world_pos=t(wpos), normal=t(n), ray_dirs=t(dirs),
                valid=torch.as_tensor(rng.random((h, w)) < 0.8,
                                      device=device),
                sky_lowres=t(rng.random((3, 32, 64)) - 10.0))
    scene = dict(sdf_volume=sdf_packed, sdf_albedo=alb_packed,
                 sdf_origin=torch.zeros(3, device=device),
                 sdf_voxel_size=voxel, sdf_grid=tuple(dims),
                 sdf_coarse=sdfgi.build_coarse_tables(sdf_packed, alb_packed,
                                                      tuple(dims)))
    return scene, rays


def _check_gi(device, scene, rays, mixed=True, edge=None, **kw):
    """Kernel G once (one launch) against its plain version, by the rule
    of the module docstring; with mixed, the rays both hit and miss and
    some escape the window; the rays of the mask edge agree on hit and
    escape every one. Returns the plain escaped plane."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    args = (rays["world_pos"], rays["normal"], rays["ray_dirs"],
            rays["valid"], rays["sky_lowres"], scene["sdf_volume"],
            scene["sdf_albedo"], scene["sdf_origin"],
            scene["sdf_voxel_size"], scene["sdf_grid"], f([0.3, -0.9, 0.3]),
            f([1.0, 0.9, 0.8]), f(10.0))
    before = native.launch_counts()["sdfgi_trace"]
    y, c, e = sdfgi.trace_gi(*args, **kw)
    assert native.launch_counts()["sdfgi_trace"] == before + 1
    y_p, c_p, e_p = sdfgi.trace_gi(*args, plain=True, **kw)
    ref = torch.cat([y_p, c_p, e_p[None]])
    out = torch.cat([y, c])
    valid = rays["valid"]
    same_hit = (out[0] >= 0) == (ref[0] >= 0)
    same_esc = e == ref[6]
    assert float(same_hit[valid].float().mean()) >= 0.999
    assert float(same_esc.float().mean()) >= 0.999
    if edge is not None:
        assert bool((same_hit & same_esc)[edge].all())
    both = same_hit & same_esc
    err = (out - ref[:6]).abs() - 1e-4 * ref[:6].abs()
    assert float(err[:, both].max()) <= 1e-4
    assert not bool(out[:, ~valid].any()) and not bool(e[~valid].any())
    if mixed:
        hits = float((ref[0] >= 0)[valid].float().mean())
        assert 0.05 < hits < 0.95
        assert float(ref[6][valid].mean()) > 0.01
    return ref[6]


@pytest.mark.parametrize("coarse,steps,strict", [
    (True, 128, False), (False, 32, False), (True, 1, False),
    (True, 32, True)])
def test_sdfgi_kernel_equals_plain(cuda, coarse, steps, strict):
    """The box scene: an all-sky tile (0, 0), a tile whose rays all escape
    (1, 0), rays that start on the window's x edges (2, 1); 128, 32 and 1
    fine steps; the strict influence cutoff."""
    scene, rays = _gi_case(cuda)
    rays = _escaping_tile(rays)
    edge = _window_edge_rays(scene, rays, 2, 1)
    escaped = _check_gi(
        cuda, scene, rays, mixed=steps > 1, edge=edge, steps=steps,
        influence=7.5,
        strict=strict, dims_zyx=scene["sdf_grid"] if coarse else None,
        coarse_tables=scene["sdf_coarse"] if coarse else None)
    if steps > 1:
        assert bool(escaped[16:32, :128].bool().all())


@pytest.mark.parametrize("dims,words", [
    ((128, 128, 256), 2048),  # 8192 voxels: the largest table at factor 8
    ((512, 512, 272), 5120)])  # factor 16 and still larger
def test_sdfgi_kernel_coarse_table_sizes(cuda, dims, words):
    """Kernel G's coarse march on the largest table
    ops/sdfgi.coarse_factor_for allows below factor 16 and on a larger
    one; rays that start on the window's x edges (1, 1)."""
    scene, rays = _plane_gi_case(cuda, dims)
    cd, ch, cw = scene["sdf_coarse"][2]
    assert cd * ch * ((cw + 3) // 4) == words
    edge = _window_edge_rays(scene, rays, 1, 1)
    _check_gi(cuda, scene, rays, edge=edge, steps=32, influence=7.5,
              dims_zyx=scene["sdf_grid"], coarse_tables=scene["sdf_coarse"])


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("h", [16, 32, 96, 640])
def test_packed_planes_kernel_equals_plain(cuda, n_planes, h):
    """Kernel H at P = 1-3 planes of 640 columns and h rows: the first
    tile row's windows clamped at the planes' top, the last's at the
    bottom (h 16 and 32: one window of all rows), tiles pushed far left
    and past the right edge (windows clamped at both sides), a ramp that
    splits a tile across its window; f16 halves over 26 octaves, some
    subnormal. The wrapper on motion (resample_packed_planes) and the
    kernel on the same coords with 16 pixels of every tile on their
    window's clamp edges (_window_edge_coords): every output bit equal to
    packed_planes_plain's. More than 3 planes raise."""
    rng = np.random.default_rng(17 + 4 * n_planes + h)
    w = 640
    vals = rng.normal(size=(2, n_planes, h, w)) * np.exp(
        rng.uniform(-18, 8, (2, n_planes, h, w)))
    vals[1, :, ::3, ::5] = 3e-6  # subnormal f16 halves
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    planes = taa.pack_f16_pair(t(vals[0]), t(vals[1]))
    motion = rng.normal(0, 0.002, (2, h, w)).astype(np.float32)
    motion[0, :16] -= 0.9
    motion[0, -16:] += 0.9
    motion[0, :, :128] += np.linspace(-0.3, 0.3, 128, dtype=np.float32)
    before = native.launch_counts()["packed_planes"]
    chans, ok = taa.resample_packed_planes(planes, t(motion), w, h)
    assert native.launch_counts()["packed_planes"] == before + 1
    coords = taa.reprojected_coords(t(motion), w, h)
    ref = taa.packed_planes_plain(planes, coords)
    assert torch.equal(ok, ref[2 * n_planes] > 0.5)
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert torch.equal(_bits(chans), _bits(ref[:2 * n_planes]))
    edge = t(_window_edge_coords(rng, h, w, 1, coords.cpu().numpy()))
    out = taa.packed_planes(planes, edge)
    ref = taa.packed_planes_plain(planes, edge)
    assert torch.equal(_bits(out), _bits(ref))
    assert 0.0 < float(out[-1].mean()) < 1.0
    with pytest.raises(ValueError):  # the kernel takes 1 to 3 planes
        taa.packed_planes(planes.repeat(4, 1, 1), edge)


@pytest.mark.parametrize("n_taps", [1, 16])
def test_history_taps_kernel_equals_plain(cuda, n_taps):
    """Kernel I at K = 1 (tech 4) and K = 16 (tech 1) on a 96x640 history:
    tiles pushed far left, past the right edge and off the top, a ramp
    that splits a tile across the window's edge; R11G11B10 values over 12
    octaves (all >= 0, so the taps' magnitude is the value)."""
    rng = np.random.default_rng(19 + n_taps)
    h, w = 96, 640
    rgb = rng.random((3, h, w)) * np.exp(rng.uniform(-6, 6, (3, h, w)))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    hist = color_packing.pack_r11g11b10(t(rgb))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    motion = rng.normal(0, 1.5, (2, h, w))
    motion[0, :16] -= 0.9 * w
    motion[0, -16:] += 0.9 * w
    motion[1, 16:32] -= 40.0
    motion[0, :, :128] += np.linspace(-90, 90, 128)
    coords = t(np.concatenate([
        np.stack([xs + motion[0] + rng.uniform(-2, 2),
                  ys + motion[1] + rng.uniform(-2, 2)])
        for _ in range(n_taps)]))
    before = native.launch_counts()["history_taps"]
    rgb_k, ok_k = taa.resample_history_taps(hist, coords)
    assert native.launch_counts()["history_taps"] == before + 1
    ref = taa.history_taps_plain(hist, coords)
    torch.testing.assert_close(ok_k, ref[3 * n_taps] > 0.5, rtol=0, atol=0)
    assert 0.05 < float(ok_k.float().mean()) < 0.95
    torch.testing.assert_close(rgb_k, ref[:3 * n_taps], rtol=1e-6,
                               atol=1e-30)


def _alpha_case(device, rng, n=600, width=512, height=256, sub=2,
                prev=False):
    """Random screen triangles with uvs over several wraps of two masks
    (an 8x8 checkerboard and random texels) and slots 0-2, through the
    port's 8-plane geometry stage (with prev, a dynamic scene's
    previous-frame clip planes too)."""
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
    arrays = [tris, (rng.random((n, 3, 2)) * 4).astype(np.float32), unit,
              unit, unit, rng.integers(0, 40, n).astype(np.float32),
              np.ones(n, bool), vp]
    t = [torch.as_tensor(a, device=device) for a in arrays]
    slots = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32),
                            device=device)
    setup = raster.geometry_setup(
        *t, width, height, cull="none", bin_rows=sub, tri_alpha_slot=slots,
        **(_prev_args(rng, tris, device) if prev else {}))
    yy, xx = np.mgrid[0:64, 0:64]
    masks = np.stack([
        textures.build_alpha_mask((((yy // 8) + (xx // 8)) % 2)
                                  .astype(np.float32)),
        textures.build_alpha_mask((rng.random((64, 64)) > 0.4)
                                  .astype(np.float32))])
    return setup, torch.as_tensor(masks, device=device)


def _alpha_edge_cases(device, rng, nb, ntx, sub):
    """Kernel E's hand-made pair lists (_depth_edge_cases: bins over 512
    pairs, one-pixel triangles, a bin-wide triangle, edges 0 at pixel
    centres, NaN / inf / +-0 / huge / tiny edge and z coefficients) as
    the 32-row alpha table: planes 4-6 (u/w, v/w, 1/w) wrap the 64x64
    masks every 0.5-60 px, slots 0-2 and the odd slots 3 (names no mask),
    0.7 (mask 1) and 1.5 (no mask: |slot - round(slot)| is not < 0.5);
    one pair in 7 has a NaN or +-inf uv coefficient. In bin 0, six
    bin-wide pairs at one depth sit in different slices of kernel K's
    K_CHUNK (equal packed depths: the highest slot that passes wins), and
    bins 2 and 5 are emptied (their pairs stay as dead columns). Returns
    (pair_edges (32, P), PairLists, masks (2, 128) i32)."""
    pe16, pairs = _depth_edge_cases(device, rng, nb, ntx, sub)
    return _alpha_rows(device, rng, pe16, pairs, sub)


def _alpha_rows(device, rng, pe16, pairs, sub):
    """_alpha_edge_cases' alpha table on any 16-row pair lists whose bin 0
    holds more than 300 pairs from column 0 on."""
    n = pe16.shape[1]
    rows = sub * 16
    pe = np.zeros((32, n), np.float64)
    pe[:16] = pe16.cpu().numpy()
    scale = 1.0 / (64.0 * np.exp(rng.uniform(np.log(0.5), np.log(60.0),
                                             (2, n))))
    ang = rng.uniform(0, 2 * np.pi, (2, n))
    for q in range(2):  # u/w and v/w
        pe[16 + 4 * q] = scale[q] * np.cos(ang[q])
        pe[17 + 4 * q] = scale[q] * np.sin(ang[q])
        pe[18 + 4 * q] = rng.uniform(-5, 5, n)
    pe[24] = rng.uniform(-1e-4, 1e-4, n)  # 1/w, positive on the screen
    pe[25] = rng.uniform(-1e-4, 1e-4, n)
    pe[26] = rng.uniform(0.6, 1.4, n)
    slot = rng.integers(0, 3, n).astype(np.float64)
    odd = rng.random(n)
    slot[odd < 0.05] = 3.0
    slot[(odd >= 0.05) & (odd < 0.1)] = 0.7
    slot[(odd >= 0.1) & (odd < 0.15)] = 1.5
    pe[30] = slot
    bad = np.nonzero(rng.random(n) < 1 / 7)[0]
    rows_uv = np.array([16, 17, 18, 20, 21, 22, 24, 25, 26])
    pe[rows_uv[rng.integers(0, 9, bad.size)], bad] = rng.choice(
        [np.nan, np.inf, -np.inf], bad.size)
    for k, p in enumerate((3, 40, 41, 77, 150, 300)):  # bin 0's slices
        pe[:16, p] = 0.0
        for e, (a, b) in enumerate(((1.0, 0.0), (0.0, 1.0), (-1.0, -1.0))):
            pe[4 * e:4 * e + 3, p] = (a, b, 900.0 if e < 2 else 128.0 +
                                      rows + 900.0)
        pe[12:15, p] = (0.0, 0.0, 0.875)
        pe[rows_uv, p] = (0.02, 0.01, 0.0, -0.01, 0.03, 0.5, 0.0, 0.0, 1.0)
        pe[3, p], pe[7, p] = 0.0, sub - 1.0
        pe[30, p] = (1.0, 0.0, 2.0, 1.0, 2.0, 1.0)[k]
    with np.errstate(all="ignore"):
        edges = torch.as_tensor(pe.astype(np.float32), device=device)
    counts = pairs.tile_count.clone()
    counts[[2, 5]] = 0
    yy, xx = np.mgrid[0:64, 0:64]
    masks = np.stack([
        textures.build_alpha_mask((((yy // 8) + (xx // 8)) % 2)
                                  .astype(np.float32)),
        textures.build_alpha_mask((rng.random((64, 64)) > 0.4)
                                  .astype(np.float32))])
    return edges, dataclasses.replace(pairs, tile_count=counts), \
        torch.as_tensor(masks, device=device)


@pytest.mark.parametrize("sub,row_skip,with_init",
                         [(4, False, True), (2, True, False),
                          (8, False, False)])
def test_depth_alpha_kernel_equals_plain(cuda, sub, row_skip, with_init):
    """Kernel J, both bodies (with init_depth: the opaque pass's depth,
    max-merged in place): equal to its plain version on every texel."""
    rng = np.random.default_rng(17)
    setup, masks = _alpha_case(cuda, rng, sub=sub)
    nb, ntx = 256 // (16 * sub), 4
    pairs = raster.build_pairs(setup, nb, ntx, bin_rows=sub,
                               order_rows=row_skip, tile_cap=1 << 15)
    pe, _ = raster.gather_pair_setups(setup, pairs, row_extents=row_skip,
                                      with_attrs=False)
    init = None
    if with_init:
        init = raster.depth_plain(pe[:16].contiguous(), pairs.tile_start,
                                  pairs.tile_count, nb, ntx, sub, False)
        init = torch.where(init > 0.5, init, 0.0)
    before = native.launch_counts()["depth_alpha"]
    merged = None if init is None else init.clone()
    depth = raster.rasterize_depth(pe, pairs, nb, ntx, sub=sub,
                                   row_skip=row_skip, alpha_masks=masks,
                                   init_depth=merged)
    assert native.launch_counts()["depth_alpha"] == before + 1
    assert merged is None or depth is merged
    depth_p = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count, nb,
                                 ntx, sub, row_skip, masks=masks, init=init)
    torch.testing.assert_close(depth.view(torch.int32),
                               depth_p.view(torch.int32), rtol=0, atol=0)
    uncut = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count, nb,
                               ntx, sub, row_skip, init=init)
    assert (depth > 0).float().mean() > 0.3
    assert bool((uncut > depth).any())  # the masks cut


@pytest.mark.parametrize("sub,row_skip,with_init", [
    (1, False, True), (1, True, False), (2, False, False), (2, True, True),
    (4, False, True), (4, True, False), (8, False, False), (8, True, True)])
def test_depth_alpha_kernel_edge_cases(cuda, sub, row_skip, with_init):
    """Kernel J on _alpha_edge_cases at sub 1, 2, 4 and 8, with and without
    row skip and init_depth: bins of many slices merging by atomicMax,
    empty bins, non-finite z and uv coefficients, odd slots; equal to its
    plain version on every texel, one launch per call."""
    rng = np.random.default_rng(41 + sub)
    nb, ntx = 256 // (16 * sub), 4
    pe, pairs, masks = _alpha_edge_cases(cuda, rng, nb, ntx, sub)
    assert int(pairs.tile_count.max()) > 2 * raster.J_CHUNK
    init = None
    if with_init:  # an opaque atlas: zeros and depths in (0, 0.9)
        d = torch.as_tensor(rng.uniform(0, 0.9, (256, 512)).astype(
            np.float32), device=cuda)
        init = torch.where(d > 0.45, d, 0.0)
    merged = None if init is None else init.clone()
    before = native.launch_counts()["depth_alpha"]
    depth = raster.rasterize_depth(pe, pairs, nb, ntx, sub=sub,
                                   row_skip=row_skip, alpha_masks=masks,
                                   init_depth=merged)
    assert native.launch_counts()["depth_alpha"] == before + 1
    depth_p = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count, nb,
                                 ntx, sub, row_skip, masks=masks, init=init)
    torch.testing.assert_close(depth.view(torch.int32),
                               depth_p.view(torch.int32), rtol=0, atol=0)
    base = torch.zeros_like(depth) if init is None else init
    raised = depth.view(torch.int32) > base.view(torch.int32)
    assert float(raised.float().mean()) > 0.05
    assert bool((depth.view(torch.int32) == 0x7FFFFFFF).any())  # NaN z
    rows = sub * 16  # the emptied bins 2 and 5 keep their values
    for b in (2, 5):
        ty, tx = divmod(b, ntx)
        cut = (slice(ty * rows, (ty + 1) * rows), slice(tx * 128,
                                                       tx * 128 + 128))
        assert torch.equal(depth[cut], base[cut])


@pytest.mark.parametrize("sub,row_skip", [
    (1, False), (1, True), (2, False), (2, True), (3, False), (3, True),
    (4, False), (4, True)])
def test_winner_alpha_kernel_edge_cases(cuda, sub, row_skip):
    """Kernel K on _alpha_edge_cases at sub 1-4, with and without row
    skip: slices that merge (the first stores, the rest atomicMax, the
    last splits), equal packed depths in different slices of bin 0,
    empty bins (-1), non-finite z and uv coefficients, odd slots; depth
    and vis equal to its plain version on every pixel, one launch."""
    rng = np.random.default_rng(51 + sub)
    nty, ntx = 256 // (16 * sub), 4
    pe, pairs, masks = _alpha_edge_cases(cuda, rng, nty, ntx, sub)
    assert int(pairs.tile_count.max()) > 2 * raster.K_CHUNK
    before = native.launch_counts()["winner_alpha"]
    depth, vis = raster.rasterize_winner_alpha(pe, pairs, masks, nty, ntx,
                                               sub, row_skip)
    assert native.launch_counts()["winner_alpha"] == before + 1
    depth_p, vis_p = raster.winner_alpha_plain(
        pe, pairs.tile_start, pairs.tile_count, masks, nty, ntx, sub,
        row_skip)
    torch.testing.assert_close(vis, vis_p, rtol=0, atol=0)
    torch.testing.assert_close(depth.view(torch.int32),
                               depth_p.view(torch.int32), rtol=0, atol=0)
    assert 0.3 < float((vis >= 0).float().mean()) < 1.0
    rows = sub * 16
    bin0 = vis[:rows, :128]
    # bin 0's equal-depth pairs: slots 300 (mask 1), 150 (mask 2), 77, ...
    assert bool((bin0 == 300).any()) and bool((bin0 == 150).any())
    for b in (2, 5):  # emptied: uncovered
        ty, tx = divmod(b, ntx)
        assert bool((vis[ty * rows:(ty + 1) * rows,
                         tx * 128:tx * 128 + 128] == -1).all())


def test_alpha_kernels_empty_bins(cuda):
    """No pairs at all: J leaves init_depth as it is (zeros without it),
    K gives vis -1 and depth 0 everywhere; one launch each."""
    pairs = raster.PairLists(
        pair_tri=torch.zeros(256, dtype=torch.int32, device=cuda),
        tile_start=torch.zeros(8, dtype=torch.int32, device=cuda),
        tile_count=torch.zeros(8, dtype=torch.int32, device=cuda),
        overflow=torch.zeros((), dtype=torch.int32, device=cuda))
    pe = torch.zeros((32, 256), device=cuda)
    masks = torch.full((1, 128), -1, dtype=torch.int32, device=cuda)
    counts = native.launch_counts()
    init = torch.rand((128, 256), device=cuda)
    depth = raster.rasterize_depth(pe, pairs, 4, 2, sub=2, alpha_masks=masks,
                                   init_depth=init.clone())
    zeros = raster.rasterize_depth(pe, pairs, 4, 2, sub=2, alpha_masks=masks)
    d_k, vis = raster.rasterize_winner_alpha(pe, pairs, masks, 4, 2, 2, True)
    after = native.launch_counts()
    assert after["depth_alpha"] == counts["depth_alpha"] + 2
    assert after["winner_alpha"] == counts["winner_alpha"] + 1
    assert torch.equal(depth, init) and not bool(zeros.any())
    assert (vis == -1).all() and (d_k == 0).all()


@pytest.mark.parametrize("sub,prev", [(2, False), (4, False), (2, True)])
def test_winner_alpha_and_attr_resolve_kernels_equal_plain(cuda, sub, prev):
    """Kernel K: depth and vis equal to its plain version; kernel L on K's
    vis: channels within 1e-4 of its plain version (kernel B's rule:
    rsqrtf may differ by an ulp from PyTorch's CUDA rsqrt); with prev, a
    dynamic scene's 40 attribute rows and 15 channels."""
    rng = np.random.default_rng(18)
    width, height = 384, 256
    setup, masks = _alpha_case(cuda, rng, n=400, width=width, height=height,
                               sub=sub, prev=prev)
    nty, ntx = height // (16 * sub), width // 128
    pairs = raster.build_pairs(setup, nty, ntx, bin_rows=sub,
                               order_rows=True)
    pe, pa = raster.gather_pair_setups(setup, pairs, row_extents=True)
    counts = native.launch_counts()
    depth, vis, gbuf = raster.rasterize_gbuffer(
        pe, pa, pairs, nty, ntx, sub=sub, row_skip=True, alpha_masks=masks)
    after = native.launch_counts()
    assert after["winner_alpha"] == counts["winner_alpha"] + 1
    assert after["attr_resolve"] == counts["attr_resolve"] + 1
    assert after["gbuffer"] == counts["gbuffer"]
    depth_p, vis_p = raster.winner_alpha_plain(
        pe, pairs.tile_start, pairs.tile_count, masks, nty, ntx, sub, True)
    torch.testing.assert_close(vis, vis_p, rtol=0, atol=0)
    torch.testing.assert_close(depth, depth_p, rtol=0, atol=0)
    assert (vis >= 0).float().mean() > 0.4
    gbuf_p = raster.attr_resolve_plain(pa, pairs.tile_start, vis, nty, ntx,
                                       sub)
    assert gbuf.shape[0] == (15 if prev else 13)
    torch.testing.assert_close(gbuf, gbuf_p, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sub,prev,coverage,lead", [
    (1, False, "none", 0), (2, False, "full", 37), (3, True, "full", 5),
    (4, False, "mixed", 100), (4, True, "mixed", 0)])
def test_attr_resolve_kernel_cases(cuda, sub, prev, coverage, lead):
    """Kernel L on a made vis: no pixel covered, every pixel covered, a
    mix with whole uncovered rows; sub 1-4; segments that start off the
    128-pair grid (lead); 15 channels with prev. Its table is
    attr_table_plain's bit for bit; its channels within 1e-4 of the
    per-pixel plain version (kernel B's rule)."""
    rng = np.random.default_rng(23 + sub)
    nty, ntx = 3, 4
    counts = rng.integers(1, 80, nty * ntx)
    starts = lead + np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_pairs = int(starts[-1] + counts[-1] + 50)
    rows = 40 if prev else 32
    a = rng.normal(size=(rows, n_pairs)) * np.exp(rng.uniform(-4, 4, (
        rows, n_pairs)))
    a[0] = np.abs(a[0]) + 0.5
    pa = torch.as_tensor(a.astype(np.float32), device=cuda)
    h, w = nty * sub * 16, ntx * 128
    bin_of = (np.arange(h)[:, None] // (16 * sub)) * ntx \
        + np.arange(w)[None] // 128
    vis = (starts % 128)[bin_of] + rng.integers(0, counts[bin_of])
    if coverage == "none":
        vis[:] = -1
    elif coverage == "mixed":
        vis[rng.random((h, w)) < 0.4] = -1
        vis[8:24] = -1
    vis = torch.as_tensor(vis.astype(np.int32), device=cuda)
    tile_start = torch.as_tensor(starts.astype(np.int32), device=cuda)
    before = native.launch_counts()["attr_resolve"]
    gbuf = raster.resolve_attributes(pa, tile_start, vis, nty, ntx, sub)
    assert native.launch_counts()["attr_resolve"] == before + 1
    ref = raster.attr_resolve_plain(pa, tile_start, vis, nty, ntx, sub)
    assert gbuf.shape == ref.shape == (15 if prev else 13, h, w)
    torch.testing.assert_close(gbuf, ref, rtol=0, atol=1e-4)
    assert not bool(gbuf[:, vis < 0].any())
    table = torch.empty((n_pairs, rows), dtype=torch.float32, device=cuda)
    native.launch("attr_resolve_launch", pa, table, tile_start, vis,
                  torch.empty_like(gbuf), n_pairs, nty, ntx, sub, int(prev))
    torch.testing.assert_close(table, raster.attr_table_plain(pa), rtol=0,
                               atol=0)


@pytest.mark.parametrize("rows", [64, 56])
def test_expand_rows_kernel_equals_plain(cuda, rows):
    """Kernel M bit for bit, and build_pairs(carry_table=...) on the card:
    the same segments as without it, rows equal to gather_pair_setups on
    every live slot. 64 rows: the 8-plane alpha table; 56: a dynamic
    scene's opaque main-view table (16 edge rows, 40 attribute rows)."""
    rng = np.random.default_rng(19)
    if rows == 64:
        setup, _ = _alpha_case(cuda, rng, n=2000)
    else:
        setup = _random_setup(rng, 2000, 512, 256, 2, cuda, prev=True)
    nb, ntx = 256 // 32, 4
    table, n_edge = raster.setup_row_table(setup, row_extents=True)
    assert table.shape[0] == rows
    ki = raster.pair_key_inputs(setup, nb, ntx, None, 2, True)
    _, owners = raster.expand_keys(ki)
    before = native.launch_counts()["expand_rows"]
    out = raster.expand_rows(owners, table, ki.cum[-1:], ki.budget)
    assert native.launch_counts()["expand_rows"] == before + 1
    torch.testing.assert_close(
        out, raster.expand_rows_plain(owners, table, ki.cum[-1:], ki.budget),
        rtol=0, atol=0)
    plain = raster.build_pairs(setup, nb, ntx, bin_rows=2, order_rows=True)
    pairs, rows = raster.build_pairs(setup, nb, ntx, bin_rows=2,
                                     order_rows=True, carry_table=table)
    torch.testing.assert_close(pairs.tile_start, plain.tile_start)
    torch.testing.assert_close(pairs.tile_count, plain.tile_count)
    pe, pa = raster.gather_pair_setups(setup, plain, row_extents=True)
    total = int(plain.tile_count.sum())
    torch.testing.assert_close(rows[:, :total],
                               torch.cat([pe, pa])[:, :total], rtol=0,
                               atol=0)


def test_expand_keys_kernel_alpha_keys_equal_plain(cuda):
    """Kernel A's order_alpha keys (tri_alpha): keys and owners equal."""
    rng = np.random.default_rng(20)
    setup, _ = _alpha_case(cuda, rng, n=3000)
    tri_alpha = torch.as_tensor(rng.random(3000) < 0.1, device=cuda)
    ki = raster.pair_key_inputs(setup, 8, 4, None, 2, True,
                                tri_alpha=tri_alpha)
    assert ki.order_alpha and ki.key_alpha == 2
    keys, owners = raster.expand_keys(ki)
    keys_p, owners_p = raster.expand_keys_plain(ki)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)
    torch.testing.assert_close(owners, owners_p, rtol=0, atol=0)


def _wide_depth_case(device, rng, nb, ntx, sub):
    """Pair lists over many bins, made in bulk: 2-6 random triangles (1-40
    px) in every bin, a bin-wide one in every third bin, 600 tiny
    triangles in bin 0 and 257 in bin 1 and in the last bin (slices that
    merge; above 8,192 bins the last bin's index needs more than the
    packed key's 13 bits); z as in _depth_edge_cases. Returns
    (pair_edges (16, P) f32, PairLists)."""
    rows, n_bins = sub * 16, nb * ntx
    per = rng.integers(2, 7, n_bins)
    per[[0, 1, n_bins - 1]] += (600, 257, 257)
    bin_of = np.repeat(np.arange(n_bins), per)
    n = bin_of.size
    ty, tx = np.divmod(bin_of, ntx)
    tiny = np.zeros(n, bool)
    first = np.concatenate([[0], np.cumsum(per)[:-1]])
    for b, k in ((0, 600), (1, 257), (n_bins - 1, 257)):
        tiny[first[b] + per[b] - k:first[b] + per[b]] = True
    centre = np.stack([tx * 128 + rng.uniform(0, 128, n),
                       ty * rows + rng.uniform(0, rows, n)], -1)
    size = np.where(tiny, rng.uniform(0.3, 4, n), rng.uniform(1, 40, n))
    v = centre[:, None] + size[:, None, None] * rng.normal(size=(n, 3, 2))
    wide = (np.arange(n) == first[bin_of]) & (bin_of % 3 == 0)
    x0, y0 = tx[wide] * 128.0, ty[wide] * rows
    v[wide] = np.stack([np.stack([x0 - 900, y0 - 900], -1),
                        np.stack([x0 + 5000, y0 - 900], -1),
                        np.stack([x0 - 900, y0 + 5000], -1)], 1)
    cols = np.zeros((16, n))
    for i in range(3):  # edge planes, >= 0 inside
        (xa, ya), (xb, yb) = v[:, i].T, v[:, (i + 1) % 3].T
        pl = np.stack([ya - yb, xb - xa, xa * yb - xb * ya])
        xc, yc = v[:, (i + 2) % 3].T
        pl *= np.where(pl[0] * xc + pl[1] * yc + pl[2] < 0, -1.0, 1.0)
        cols[4 * i:4 * i + 3] = pl
    cols[12] = rng.uniform(-2e-3, 2e-3, n)
    cols[13] = rng.uniform(-2e-3, 2e-3, n)
    cols[14] = np.where(wide, 0.25 + 0.5 * (bin_of % 97) / 97,
                        rng.uniform(-0.3, 1.3, n))
    cols[12:14, wide] = 0.0
    cols[3] = np.floor(v[..., 1].min(1) / 16)
    cols[7] = np.floor(v[..., 1].max(1) / 16)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                      device=device)
    pairs = raster.PairLists(
        pair_tri=t(np.zeros(n), np.int32), tile_start=t(first, np.int32),
        tile_count=t(per, np.int32), overflow=t(0, np.int32))
    return t(cols, np.float32), pairs


# bin counts the reference renders: J with bench.py's banners at shadow
# resolution 3072 (144 x 24 bins of 64 rows) and 4096 (192 x 32; 256 x 32
# with 4 cascades); K on a 5120x2880 view (90 x 40 bins of 32 rows); B at
# 7680x4320 (135 x 60); E at 8,192; and every kernel above 8,192 bins
WIDE_BINS = [("J", 144, 24, 4, False), ("J", 144, 24, 4, True),
             ("J", 192, 32, 4, False), ("J", 192, 32, 4, True),
             ("J", 256, 32, 4, True), ("J", 128, 72, 1, True),
             ("K", 90, 40, 2, True), ("K", 128, 72, 1, False),
             ("E", 256, 32, 4, True), ("E", 144, 64, 1, False),
             ("B", 135, 60, 2, True), ("B", 128, 72, 1, False)]


@pytest.mark.parametrize("kernel,nb,ntx,sub,flag", WIDE_BINS,
                         ids=[f"{k}-{nb * ntx}-{f}"
                              for k, nb, ntx, _, f in WIDE_BINS])
def test_strip_kernels_take_many_bins(cuda, kernel, nb, ntx, sub, flag):
    """Kernels E, B, J and K at the bin counts above, each equal to its
    plain version (E, J, K exact; B by its rule), one launch per call. J:
    flag merges onto an init atlas; K, E and B: flag is row skip."""
    rng = np.random.default_rng(nb * ntx + sub)
    pe, pairs = _wide_depth_case(cuda, rng, nb, ntx, sub)
    h, w = nb * sub * 16, ntx * 128
    name = dict(J="depth_alpha", K="winner_alpha", E="depth",
                B="gbuffer")[kernel]
    before = native.launch_counts()[name]
    if kernel in "JK":
        pe, pairs, masks = _alpha_rows(cuda, rng, pe, pairs, sub)
    if kernel == "J":
        init = None
        if flag:
            d = torch.rand((h, w), device=cuda) * 0.9
            init = torch.where(d > 0.45, d, 0.0)
        depth = raster.rasterize_depth(
            pe, pairs, nb, ntx, sub=sub, alpha_masks=masks,
            init_depth=None if init is None else init.clone())
        want = raster.depth_plain(pe, pairs.tile_start, pairs.tile_count, nb,
                                  ntx, sub, False, masks=masks, init=init)
        got = [depth.view(torch.int32)]
        want = [want.view(torch.int32)]
    elif kernel == "K":
        got = list(raster.rasterize_winner_alpha(pe, pairs, masks, nb, ntx,
                                                 sub, flag))
        want = list(raster.winner_alpha_plain(
            pe, pairs.tile_start, pairs.tile_count, masks, nb, ntx, sub,
            flag))
    elif kernel == "E":
        got = [raster.rasterize_depth(pe, pairs, nb, ntx, sub=sub,
                                      row_skip=flag).view(torch.int32)]
        want = [raster.depth_plain(pe, pairs.tile_start, pairs.tile_count,
                                   nb, ntx, sub, flag).view(torch.int32)]
    else:
        pa = _edge_case_attrs(rng, pe.shape[1], False, cuda)
        got = list(raster.rasterize_gbuffer(pe, pa, pairs, nb, ntx, sub=sub,
                                            row_skip=flag))
        want = list(raster.gbuffer_plain(pe, pa, pairs.tile_start,
                                         pairs.tile_count, nb, ntx, sub,
                                         flag))
        torch.testing.assert_close(got.pop(), want.pop(), rtol=0, atol=1e-4)
    assert native.launch_counts()[name] == before + 1
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert float((got[0] != 0).float().mean()) > 0.1
    assert bool(got[0][h - sub * 16:, w - 128:].any())  # the last bin


def _keys_setup(rng, t, nty, ntx, bin_rows, valid, device):
    """Random bboxes (1-3 bins tall, 1-2 wide, fine rows inside the first
    bin row) where valid, as the TriangleSetup fields pair_key_inputs
    reads (tests/test_torch_raster.py:_random_bbox_setup's layout)."""
    ty0 = rng.integers(0, nty, t)
    ty1 = np.minimum(ty0 + rng.integers(1, 4, t) - 1, nty - 1)
    tx0 = rng.integers(0, ntx, t)
    tx1 = np.minimum(tx0 + rng.integers(1, 3, t) - 1, ntx - 1)
    fine = np.stack([ty0 * bin_rows + rng.integers(0, bin_rows, t),
                     ty1 * bin_rows + bin_rows - 1], axis=1)
    fine = np.where(valid[:, None], fine, [1, 0])
    t_ = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                       device=device)
    return raster.TriangleSetup(
        edges=torch.zeros((3, 4, t), device=device),
        attrs=torch.zeros((raster.NATTR, 0), device=device),
        tile_bbox=t_(np.stack([ty0, tx0, ty1, tx1], 1), np.int32),
        valid=t_(valid, bool), fine_y=t_(fine, np.int32))


def _flat_valid(rng, t):
    """An alpha stream's validity: three runs of 256 triangles (one at the
    end of the table) and 40 single ones among long runs that cover no
    bin, so cum stays flat over all but ~800 of t entries."""
    valid = np.zeros(t, bool)
    for s in (1000, t // 2, t - 256):
        valid[s:s + 256] = True
    valid[rng.integers(0, t, 40)] = True
    return valid


@pytest.mark.parametrize("case,budget", [
    ("dense", "past"), ("dense", "short"), ("flat", "default"),
    ("flat", "short"), ("flat-views", "default")])
def test_expand_keys_kernel_owner_search_cases(cuda, case, budget):
    """Kernel A's owner search: a dense stream (owners change every few
    slots, so warps' and rounds' slots straddle owners), a flat alpha
    stream of 300,000 triangles with ~800 live (runs of empty triangles
    longer than any window; alpha keys), the same as 3 views; budgets
    past the total (dead slots: 3,000 more, or the frame's default for
    the alpha streams, T + 8 slots per bin row) and half the total (every
    slot live). Keys and owners equal expand_keys_plain exactly."""
    rng = np.random.default_rng(61)
    nty, ntx, bin_rows = 48, 4, 2
    t = 40_000 if case == "dense" else 300_000
    valid = rng.random(t) > 0.3 if case == "dense" else _flat_valid(rng, t)
    setup = _keys_setup(rng, t, nty, ntx, bin_rows, valid, cuda)
    alpha = None if case == "dense" else setup.valid
    views = 3 if case == "flat-views" else 1
    ki = raster.pair_key_inputs(setup, nty, ntx, None, bin_rows, True,
                                n_views=views, tri_alpha=alpha)
    total = int(ki.cum[-1])
    if budget != "default":
        ki = raster.pair_key_inputs(
            setup, nty, ntx, total // 2 if budget == "short" else
            total + 3000, bin_rows, True, n_views=views, tri_alpha=alpha)
    assert (ki.budget < total) == (budget == "short")
    assert ki.budget < total or ki.budget > total + 2900
    assert total > (50_000 if case == "dense" else 800)
    before = native.launch_counts()["expand_keys"]
    keys, owners = raster.expand_keys(ki)
    assert native.launch_counts()["expand_keys"] == before + 1
    keys_p, owners_p = raster.expand_keys_plain(ki)
    torch.testing.assert_close(keys, keys_p, rtol=0, atol=0)
    torch.testing.assert_close(owners, owners_p, rtol=0, atol=0)


def _window_edge_coords(rng, h, w, n_taps, coords=None):
    """Kernel I's coords (as tests/test_torch_taa.py:_coords), or a copy of
    the given (2K, h, w) coords, with 16 pixels of every 16 x 128 tile
    moved, in every tap, onto the edges of their tile's window: the
    footprint clamped at 0 and at win - 2, fx or fy exactly 0 and 1, the
    in-window margin exactly 2.5 and one f32 step inside it (I's), exactly
    0.5, just below it and exactly win - 1.5 (H's), far outside on either
    side. The window follows tap 0's
    mean x, so the moves are redone until no tile's window changes.
    Returns (2K, h, w) f32 numpy."""
    if coords is not None:
        coords = np.array(coords, np.float32)
    else:
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
        motion = rng.normal(0, 1.5, (2, h, w)).astype(np.float32)
        motion[0, :, :128] += np.linspace(-90, 90, 128, dtype=np.float32)
        coords = np.concatenate([
            np.stack([xs + motion[0] + rng.uniform(-2, 2),
                      ys + motion[1] + rng.uniform(-2, 2)])
            for _ in range(n_taps)]).astype(np.float32)
    win_h, win_w = min(32, h), min(256, w)

    def edges(win):
        f = np.float32
        return np.array([0.0, 0.5, -100.0, 2.5, np.nextafter(f(2.5), f(3)),
                         win - 2.5, np.nextafter(f(win - 2.5), f(0)),
                         win - 1.5, win - 0.5, win + 50.0,
                         0.5 - 2.0 ** -20, 1.0, 1.5, win - 1.0, 3e4,
                         -3e4], np.float32)

    ex, ey = edges(win_w), edges(win_h)
    py = (np.arange(16) * 5) % 16  # 16 pixels of a tile: (py, px)
    px = (np.arange(16) * 37 + 3) % 128
    windows = None
    for _ in range(6):
        by, bx = (v.numpy() for v in taa._tile_window(
            torch.as_tensor(coords[0]), h, w))
        if windows is not None and np.array_equal(windows, (by, bx)):
            return coords
        windows = np.array((by, bx))
        for ty in range(h // 16):
            for tx in range(w // 128):
                y, x = ty * 16 + py, tx * 128 + px
                for k in range(n_taps):
                    roll = np.roll(np.arange(16), k)
                    coords[2 * k, y, x] = bx[y, x] + ex[roll]
                    coords[2 * k + 1, y, x] = by[y, x] + ey[roll[::-1]]
    raise AssertionError("the windows did not settle")


@pytest.mark.parametrize("n_taps", [1, 16])
def test_history_taps_kernel_window_edges(cuda, n_taps):
    """Kernel I with taps on its windows' clamp edges
    (_window_edge_coords) on a 64 x 512 history, so windows move in x and
    y: ok equal to its plain version on every pixel, values within 1e-6
    of the taps' magnitude (R11G11B10 values are >= 0)."""
    rng = np.random.default_rng(71 + n_taps)
    h, w = 64, 512
    rgb = rng.random((3, h, w)) * np.exp(rng.uniform(-6, 6, (3, h, w)))
    hist = color_packing.pack_r11g11b10(
        torch.as_tensor(rgb.astype(np.float32), device=cuda))
    coords = torch.as_tensor(_window_edge_coords(rng, h, w, n_taps),
                             device=cuda)
    before = native.launch_counts()["history_taps"]
    rgb_k, ok_k = taa.resample_history_taps(hist, coords)
    assert native.launch_counts()["history_taps"] == before + 1
    ref = taa.history_taps_plain(hist, coords)
    torch.testing.assert_close(ok_k, ref[3 * n_taps] > 0.5, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k, ref[:3 * n_taps], rtol=1e-6,
                               atol=1e-30)


# the small banner atrium (tests/test_frame.py:312-314) with 3 boxes
FLIGHT_ATRIUM = dict(columns_per_row=2, floor_subdiv=2, box_count=3,
                     box_subdiv=1, column_segments=8, banner_count=2)


@functools.lru_cache(maxsize=1)
def _flight_case(device):
    """The small textured banner atrium with its scene SDF baked on the
    card at 16^3 per mesh, the default RenderSettings() at 256x128 (TAA,
    bloom, fog, GI, 3 sun cascades of 256^2, alpha-tested banners) and a
    4-camera path moving a little every frame, uploaded once."""
    scene_data = procedural.build_atrium_scene(
        procedural.AtriumConfig(**FLIGHT_ATRIUM), textured=True)
    rs = scenebuild.build_render_scene(scene_data)
    gsdf = sdf_scene.build_scene_sdf(rs, scene_data, bake_resolution_cap=16,
                                     device=device)
    scene = frame.attach_global_sdf(frame.scene_to_device(rs, device=device),
                                    gsdf)
    settings = config.RenderSettings(
        width=256, height=128, exposure_adaption_speed=1000.0,
        shadows=config.ShadowSettings(resolution=256))
    luts = frame.bake_static_luts(settings, device=device)
    exts = [cam_mod.extrinsic_from_angles([0.05 * i, -1.7, -4.0 + 0.02 * i],
                                          pitch_deg=2.0, yaw_deg=0.3 * i)
            for i in range(4)]
    path = frame.camera_arrays(
        *(np.stack([getattr(e, k) for e in exts])
          for k in ("position", "forward", "right", "up")), device=device)
    return scene, settings, luts, path


def _counts_since(before):
    return {k: v - before[k] for k, v in native.launch_counts().items()}


def test_flight_equals_eager_camera_path_frames(cuda):
    """render_flight (frame 1 eager, then a captured frame step replayed)
    over 5 frames of a 4-camera path equals 5 eager camera-path frames from
    the same state: the last image and every FrameState field, bit for
    bit; the replays count as many kernel launches as the eager frames
    made; the caller's state is not written."""
    scene, settings, luts, path = _flight_case(cuda)
    n = 5
    state0 = initial_state(256, 128, device=cuda)
    before = native.launch_counts()
    img_e, st_e = None, state0
    for _ in range(n):
        img_e, st_e = frame.render_frame(st_e, scene, path, luts, 1.0 / 60.0,
                                         settings, device=cuda)
    eager = _counts_since(before)
    before = native.launch_counts()
    img_f, st_f = frame.render_flight(state0, scene, path, luts, 1.0 / 60.0,
                                      settings, n, device=cuda)
    assert _counts_since(before) == eager
    assert eager["packed_planes"] == n and eager["winner_alpha"] == n
    assert torch.equal(img_f, img_e)
    assert img_f.float().std() > 5
    for f in dataclasses.fields(FrameState):
        a, b = getattr(st_f, f.name), getattr(st_e, f.name)
        if a.is_floating_point():
            a, b = _bits(a), _bits(b)
        assert torch.equal(a, b), f.name
    assert int(st_f.frame_index) == n and int(state0.frame_index) == 0
    assert not bool(state0.prev_color.any())


def test_flight_capture_that_fails_raises(cuda, monkeypatch):
    """A frame step that waits for the device (here the tonemap pass
    reading a value back) cannot be captured: render_flight raises after
    its one eager frame and renders no frame eagerly in the graph's place.
    Last in this file: the failed capture is the process's last CUDA
    work."""
    scene, settings, luts, path = _flight_case(cuda)
    tonemap = post.tonemap_pass

    def reading_back(hdr, time):
        float(hdr.sum())  # a host synchronisation
        return tonemap(hdr, time)

    monkeypatch.setattr(post, "tonemap_pass", reading_back)
    state0 = initial_state(256, 128, device=cuda)
    before = native.launch_counts()
    with pytest.raises(RuntimeError):
        frame.render_flight(state0, scene, path, luts, 1.0 / 60.0, settings,
                            3, device=cuda)
    ran = _counts_since(before)
    assert ran["gbuffer"] == 1 and ran["packed_planes"] == 1
