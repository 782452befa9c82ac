"""Material texture sampling (plainrenderer_tpu/ops/texture.py).

The reference samples per-pixel albedo / normal / specular through a
bindless texture array with hardware samplers (triangle.frag:177-201). The
JAX package re-architected that around per-tile windows, and the port keeps
its semantics exactly, because the window decides which pixels are
sampled at all (the `ok` channel):

  - per 16x128 screen tile, the two extreme materials of its valid pixels
    and the more frequent of them (`dom`); one mip per (tile, material)
    from the mean uv footprint of that material's pixels;
  - a 24x256-texel window (3x2 bricks of the pool) placed on the texture
    torus around the circular mean texel of those pixels; bilinear taps
    wrap on the level, and a pixel whose footprint leaves a window larger
    than the level gets ok = 0;
  - mixed tiles repeat all of it for the second material (two_mat);
  - untextured materials and 3rd+ minority materials get ok = 0, and the
    frame falls back to the material constants there.

sample_materials is kernel D (csrc/texture.cu) for CUDA tensors and
sample_plain for CPU tensors. Both reduce a tile's 2048 pixels in one fixed
order: 256 threads of 8 pixels (thread = (row // 8) * 128 + column), each
summing its 8 rows in turn, then a halving tree over the 256 threads. So
the tile sums, and with them each tile's mip and window, agree bit for
bit. texture_filter >= 1 adds per-pixel trilinear filtering (a second
window at mip + 1, lerped by the per-pixel lod fraction; two_mat is then
off) and texture_filter >= 2 anisotropic filtering (the minor-axis mip,
3 taps along the major footprint axis), both as the JAX kernel.
"""

from __future__ import annotations

import functools

import torch

from .. import native
from .raster import TILE_H, TILE_W, _kernel_device, _require

WIN_BY = 3  # window bricks (rows of 8 texels)
WIN_BX = 2  # window bricks (cols of 128 texels)
WIN_H = WIN_BY * 8  # 24
WIN_W = WIN_BX * 128  # 256
N_OUT = 9  # rgb, alpha, nx, ny, rough, metal, ok

THREADS = 256  # per tile: 2 row halves x 128 columns
ROWS_PER_THREAD = TILE_H * TILE_W // THREADS  # 8


def to_thread_layout(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., n_tiles, THREADS, ROWS_PER_THREAD): tile t =
    ty * n_tiles_x + tx, thread (row // 8) * 128 + column, then row % 8."""
    *lead, h, w = x.shape
    nty, ntx = h // TILE_H, w // TILE_W
    halves = TILE_H // ROWS_PER_THREAD
    y = x.reshape(*lead, nty, halves, ROWS_PER_THREAD, ntx, TILE_W)
    n = len(lead)
    y = y.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return y.reshape(*lead, nty * ntx, THREADS, ROWS_PER_THREAD)


def from_thread_layout(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of to_thread_layout."""
    *lead, _, _, _ = x.shape
    nty, ntx = h // TILE_H, w // TILE_W
    halves = TILE_H // ROWS_PER_THREAD
    y = x.reshape(*lead, nty, ntx, halves, TILE_W, ROWS_PER_THREAD)
    n = len(lead)
    y = y.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return y.reshape(*lead, h, w)


def tile_sum(x: torch.Tensor) -> torch.Tensor:
    """(n, THREADS, ROWS) f32 -> (n,): each thread sums its rows in order,
    then a halving tree over threads (v[i] += v[i + s], s = 128 .. 1), the
    order the kernels use."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for r in range(x.shape[-1]):
        acc = acc + x[..., r]
    s = acc.shape[-1] // 2
    while s >= 1:
        acc = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    return acc[..., 0]


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=(-2, -1), dtype=torch.int32)


def _jmod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.mod for floats: the exact fmod, moved into y's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


@functools.lru_cache(maxsize=8)
def byte_table(device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(256,) f32: b / 255 for every byte b, correctly rounded (an IEEE
    division of f32 tensors). A multiply by fl(1 / 255) is not the same
    function: it differs for 126 of the 256 bytes. Kernel D unpacks
    through the same table in shared memory."""
    b = torch.arange(256, dtype=torch.float32)
    return torch.div(b, torch.full_like(b, 255.0)).to(device)


def _unpack8(w: torch.Tensor, shift: int, table: torch.Tensor):
    return table[((w >> shift) & 0xFF).long()]


def window_bricks(base, nbx, nby, bx0, by0) -> torch.Tensor:
    """The pool bricks of a window of WIN_BY x WIN_BX bricks on a level
    of nby x nbx bricks whose first brick is base, at brick (by0, bx0) of
    the level's torus: (..., 6) for int tensors of shape (...), brick
    (i, j) at index i * WIN_BX + j is base + ((by0 + i) mod nby) * nbx +
    (bx0 + j) mod nbx, the modulos taken by max(n, 1). Window texel
    (yi, xi), 0 <= yi < 24 and 0 <= xi < 256, is then pool word
    (bricks[(yi >> 3) * 2 + (xi >> 7)] * 8 + (yi & 7)) * 128 + (xi & 127):
    the same address as wrapping each tap's brick on the torus, with no
    division per tap. Kernel D computes the same 6 per window."""
    dev = base.device
    i = torch.arange(WIN_BY, dtype=base.dtype, device=dev)[:, None]
    j = torch.arange(WIN_BX, dtype=base.dtype, device=dev)[None, :]

    def grid(x):
        return x[..., None, None]
    by = torch.remainder(grid(by0) + i, grid(torch.clamp(nby, min=1)))
    bx = torch.remainder(grid(bx0) + j, grid(torch.clamp(nbx, min=1)))
    bricks = grid(base) + by * grid(nbx) + bx
    return bricks.reshape(*base.shape, WIN_BY * WIN_BX)


def _sample_level(mip, texc, sel, n_sel, u, v, info_flat, n_mips: int,
                  word0, word1, aniso_axis=None, taps=None):
    """One (texture, mip) window of one material per tile and its taps
    (texture.py:113-271). All pixel tensors are in thread layout (n,
    THREADS, ROWS); mip and texc (n,). aniso_axis (mvx, mvy), the major
    footprint axis in mip-0 uv units per pixel, takes 3 bilinear taps at
    -1/3, 0 and 1/3 of it in this level's texel units and averages them,
    the in-window masks ANDed (texture.py:252-271). taps, a list, receives
    each tap's pool word index (n, THREADS, ROWS). Returns (raw (8, n,
    THREADS, ROWS), the 8 bilinear blends before the gamma and normal
    decode, and the in-window mask)."""
    def col(row, k):  # per-tile int32 info entry
        return info_flat[(row * 4 + k).long()]

    def tile(x):  # per-tile scalar -> broadcast over pixels
        return x[:, None, None]

    row = texc * n_mips + mip
    base, nbx, lw, lh = (col(row, k) for k in range(4))
    nby = torch.div(lh + 7, 8, rounding_mode="floor")
    lwf = tile(lw.to(torch.float32))
    lhf = tile(lh.to(torch.float32))

    # circular mean texel on the level's torus: anchor at the selected
    # minimum, wrap offsets into [-L/4, 3L/4), average (texture.py:123-147)
    uf = (u - torch.floor(u)) * lwf
    vf = (v - torch.floor(v)) * lhf
    a_u = torch.where(sel, uf, 1e9).amin(dim=(-2, -1))
    a_v = torch.where(sel, vf, 1e9).amin(dim=(-2, -1))
    rel_u = uf - tile(a_u)
    rel_u = rel_u - torch.floor(rel_u / lwf + 0.25) * lwf
    rel_v = vf - tile(a_v)
    rel_v = rel_v - torch.floor(rel_v / lhf + 0.25) * lhf
    mean_u = a_u + tile_sum(torch.where(sel, rel_u, 0.0)) / n_sel
    mean_v = a_v + tile_sum(torch.where(sel, rel_v, 0.0)) / n_sel
    bx0 = torch.div((mean_u - WIN_W * 0.5).to(torch.int32), 128,
                    rounding_mode="floor")
    by0 = torch.div((mean_v - WIN_H * 0.5).to(torch.int32), 8,
                    rounding_mode="floor")

    # window-local coords on the torus
    tx = _jmod(uf - tile((bx0 * 128).to(torch.float32)), lwf)
    ty = _jmod(vf - tile((by0 * 8).to(torch.float32)), lhf)
    fits_x = tile(lw <= WIN_W)
    fits_y = tile(lh <= WIN_H)
    lw_t, lh_t = tile(lw), tile(lh)
    bricks = window_bricks(base, nbx, nby, bx0, by0).long()
    w0_flat, w1_flat = word0.reshape(-1), word1.reshape(-1)
    table = byte_table(word0.device)

    def tap(xi, yi):
        xi = torch.where(xi >= lw_t, xi - lw_t, xi)
        xi = torch.where(xi < 0, xi + lw_t, xi)
        yi = torch.where(yi >= lh_t, yi - lh_t, yi)
        yi = torch.where(yi < 0, yi + lh_t, yi)
        xi = torch.clamp(xi, 0, WIN_W - 1)
        yi = torch.clamp(yi, 0, WIN_H - 1)
        # window brick (yi >> 3, xi >> 7) is pool brick (by0 + ., bx0 + .)
        # modulo the level's brick grid
        slot = ((yi >> 3) * WIN_BX + (xi >> 7)).long()
        bidx = torch.gather(bricks, 1, slot.flatten(1)).reshape(slot.shape)
        flat = (bidx * 8 + (yi & 7)) * 128 + (xi & 127)
        if taps is not None:
            taps.append(flat)
        return w0_flat[flat], w1_flat[flat]

    def bilinear_at(txo, tyo):
        in_w = ((fits_x | ((txo >= 0.5) & (txo <= WIN_W - 1.5)))
                & (fits_y | ((tyo >= 0.5) & (tyo <= WIN_H - 1.5))) & sel)
        x0 = torch.floor(txo - 0.5).to(torch.int32)
        y0 = torch.floor(tyo - 0.5).to(torch.int32)
        fx = torch.clamp(txo - 0.5 - x0.to(torch.float32), 0.0, 1.0)
        fy = torch.clamp(tyo - 0.5 - y0.to(torch.float32), 0.0, 1.0)
        w000, w100 = tap(x0, y0)
        w001, w101 = tap(x0 + 1, y0)
        w010, w110 = tap(x0, y0 + 1)
        w011, w111 = tap(x0 + 1, y0 + 1)
        b00 = (1 - fx) * (1 - fy)
        b01 = fx * (1 - fy)
        b10 = (1 - fx) * fy
        b11 = fx * fy

        def blend(a, b, c, d, shift):
            return (_unpack8(a, shift, table) * b00
                    + _unpack8(b, shift, table) * b01
                    + _unpack8(c, shift, table) * b10
                    + _unpack8(d, shift, table) * b11)

        return torch.stack(
            [blend(w000, w001, w010, w011, s) for s in (0, 8, 16, 24)]
            + [blend(w100, w101, w110, w111, s) for s in (0, 8, 16, 24)]
        ), in_w

    if aniso_axis is None:
        return bilinear_at(tx, ty)
    mvx, mvy = aniso_axis[0] * lwf, aniso_axis[1] * lhf
    acc = in_win = None
    for off in (-1.0 / 3.0, 0.0, 1.0 / 3.0):
        vals, in_o = bilinear_at(tx + mvx * off, ty + mvy * off)
        acc = vals if acc is None else acc + vals
        in_win = in_o if in_win is None else in_win & in_o
    return acc * (1.0 / 3.0), in_win


def _material_pass(m_sel, n_valid, u, v, duv, mat, valid, mat_tex, info,
                   word0, word1, n_mips: int, mip_bias: float,
                   trilinear: bool = False, aniso: bool = False, taps=None):
    """Window + taps for one material per tile (texture.py:79-285). All
    pixel tensors are in thread layout (n, THREADS, ROWS); m_sel (n,).
    aniso takes the mip of the footprint's minor axis (with the major
    axis / 3 as a floor) and 3 taps along its major axis; trilinear lerps
    a second window at mip + 1 by the per-pixel lod fraction, the
    in-window masks ANDed. taps: as _sample_level's. Returns (values (8,
    n, THREADS, ROWS) zeroed where not ok, ok, sel)."""
    info_flat = info.reshape(-1)

    def tile(x):  # per-tile scalar -> broadcast over pixels
        return x[:, None, None]

    tex = mat_tex[m_sel.long()]
    textured = (tex >= 0) & (n_valid > 0)
    texc = torch.clamp(tex, min=0)
    sel = valid & (mat == tile(m_sel))
    n_sel = torch.clamp(_count(sel).to(torch.float32), min=1.0)

    # mip from the mean uv footprint of this material's pixels, in mip-0
    # texel units (texture.py:91-111)
    row0 = (texc * n_mips * 4).long()
    lw0 = tile(info_flat[row0 + 2].to(torch.float32))
    lh0 = tile(info_flat[row0 + 3].to(torch.float32))
    axis = None
    if aniso:
        ex_len = torch.sqrt((duv[0] * lw0) ** 2 + (duv[1] * lh0) ** 2)
        ey_len = torch.sqrt((duv[2] * lw0) ** 2 + (duv[3] * lh0) ** 2)
        rho_maj = torch.maximum(ex_len, ey_len)
        # rho_maj / 3 as XLA rounds it: a multiply by the f32 reciprocal
        rho = torch.maximum(torch.minimum(ex_len, ey_len),
                            rho_maj * (1.0 / 3.0))
        use_ex = ex_len >= ey_len
        axis = (torch.where(use_ex, duv[0], duv[2]),
                torch.where(use_ex, duv[1], duv[3]))
    else:
        rho = torch.maximum(
            torch.maximum(torch.abs(duv[0]) * lw0, torch.abs(duv[1]) * lh0),
            torch.maximum(torch.abs(duv[2]) * lw0, torch.abs(duv[3]) * lh0))
    mean_rho = tile_sum(torch.where(sel, rho, 0.0)) / n_sel
    lam = torch.log2(torch.clamp(mean_rho, min=1e-6)) + mip_bias
    mip = torch.clamp(lam.to(torch.int32), 0, n_mips - 1)

    level = (texc, sel, n_sel, u, v, info_flat, n_mips, word0, word1, axis,
             taps)
    raw, in_win = _sample_level(mip, *level)
    if trilinear:
        raw_hi, in_hi = _sample_level(
            torch.clamp(mip + 1, max=n_mips - 1), *level)
        lam_px = torch.log2(torch.clamp(rho, min=1e-6)) + mip_bias
        t = torch.clamp(lam_px - tile(mip.to(torch.float32)), 0.0, 1.0)
        raw = raw + (raw_hi - raw) * t
        in_win = in_win & in_hi
    r, g, b, alpha, nx, ny, rough, metal = raw
    ok = in_win & tile(textured)
    vals = torch.stack([r * r, g * g, b * b, alpha, nx * 2.0 - 1.0,
                        ny * 2.0 - 1.0, rough, metal])
    return torch.where(ok, vals, 0.0), ok, sel


def tile_materials(mat, val, mat_tex):
    """Per tile (texture.py:61-74, :308-310), from the material ids (int32)
    and valid mask in thread layout: (n_valid, dom, second, needs2) —
    the valid count, the more frequent of the two extreme materials, the
    other one, and whether the second window is sampled."""
    n_mat = mat_tex.shape[0]
    n_valid = _count(val)
    m_min = torch.clamp(torch.where(val, mat, 2 ** 20).amin(dim=(-2, -1)),
                        0, n_mat - 1)
    m_max = torch.clamp(torch.where(val, mat, -1).amax(dim=(-2, -1)),
                        0, n_mat - 1)
    n_min = _count(val & (mat == m_min[:, None, None]))
    dom = torch.where(2 * n_min >= n_valid, m_min, m_max)
    second = torch.where(dom == m_min, m_max, m_min)
    n_sec = _count(val & (mat == second[:, None, None]))
    needs2 = (second != dom) & (n_sec > 0) & (mat_tex[second.long()] >= 0)
    return n_valid, dom, second, needs2


def sample_plain(uv, duv, mat_id, valid, mat_tex, info, word0, word1,
                 n_mips: int, mip_bias: float = 0.0, two_mat: bool = True,
                 trilinear: bool = False, aniso: bool = False, words=None):
    """Plain version of kernel D: (9, H, W) f32, the same arithmetic and
    reduction order as csrc/texture.cu. Value channels are 0 where ok is
    0 (the JAX kernel leaves the dominant window's taps there; the frame
    reads values only where ok). two_mat is ignored under trilinear, whose
    second window holds mip + 1 (texture.py:301). words, a list, receives
    the pool word index of every tap that an ok pixel's value reads (one
    int64 tensor per tap), for counting the distinct words."""
    _, h, w = uv.shape
    u, v = to_thread_layout(uv)
    duv_t = to_thread_layout(duv)
    mat = to_thread_layout(mat_id).to(torch.int32)
    val = to_thread_layout(valid)
    n_valid, dom, second, needs2 = tile_materials(mat, val, mat_tex)
    args = (n_valid, u, v, duv_t, mat, val, mat_tex, info, word0, word1,
            n_mips, mip_bias, trilinear, aniso)
    taps = [] if words is not None else None
    vals, ok, _ = _material_pass(dom, *args, taps=taps)
    kept = [(taps, ok)]
    if two_mat and not trilinear:
        taps2 = [] if words is not None else None
        vals2, ok2, sel2 = _material_pass(second, *args, taps=taps2)
        take = sel2 & needs2[:, None, None]
        kept = [(taps, ok & ~take), (taps2, ok2 & take)]
        vals = torch.where(take, vals2, vals)
        ok = torch.where(take, ok2, ok)
    if words is not None:
        words.extend(f[keep] for pass_taps, keep in kept for f in pass_taps)
    out = torch.cat([vals, ok[None].to(torch.float32)])
    return from_thread_layout(out, h, w)


def sample_materials(uv, duv, mat_id, valid, mat_tex, info, word0, word1,
                     *, n_mips: int, mip_bias: float = 0.0,
                     trilinear: bool = False, aniso: bool = False,
                     two_mat: bool = True):
    """Sample per-pixel material values from the brick texture pool
    (texture.py:326; kernel D, csrc/texture.cu, replaces
    texture.py:47 _sample_kernel).

    uv (2, H, W); duv (4, H, W) dudx, dvdx, dudy, dvdy; mat_id (H, W) f32;
    valid (H, W) bool; mat_tex (M,) i32; info (n_tex * n_mips, 4) i32;
    word0 / word1 (NB, 8, 128) i32. trilinear: a second window at mip + 1
    lerped by the per-pixel lod fraction; aniso: the minor-axis mip and 3
    taps along the major footprint axis; two_mat: mixed tiles window their
    second material too (ignored under trilinear). Returns (9, H, W):
    linear rgb, alpha, normal xy, rough, metal, ok."""
    dev = uv.device
    _, h, w = uv.shape
    _require(uv, "uv", torch.float32, 3, dev)
    _require(duv, "duv", torch.float32, 3, dev)
    _require(mat_id, "mat_id", torch.float32, 2, dev)
    _require(valid, "valid", torch.bool, 2, dev)
    _require(mat_tex, "mat_tex", torch.int32, 1, dev)
    _require(info, "info", torch.int32, 2, dev)
    _require(word0, "word0", torch.int32, 3, dev)
    _require(word1, "word1", torch.int32, 3, dev)
    if uv.shape[0] != 2 or duv.shape != (4, h, w) or mat_id.shape != (h, w) \
            or valid.shape != (h, w):
        raise ValueError("uv (2, H, W), duv (4, H, W), mat_id and valid "
                         "(H, W) must agree")
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"({h}, {w}) is not a multiple of the 16x128 tile")
    if info.shape[1] != 4 or info.shape[0] % n_mips \
            or word0.shape != word1.shape or word0.shape[1:] != (8, 128):
        raise ValueError("info (n_tex * n_mips, 4), word0/word1 (NB, 8, 128)")
    if mat_tex.shape[0] < 1:
        raise ValueError("mat_tex needs at least one material")
    if not _kernel_device(uv):
        return sample_plain(uv, duv, mat_id, valid, mat_tex, info, word0,
                            word1, n_mips, mip_bias, two_mat, trilinear,
                            aniso)
    out = torch.empty((N_OUT, h, w), dtype=torch.float32, device=dev)
    native.launch("texture_launch", uv, duv, mat_id, valid, mat_tex, info,
                  word0, word1, out, h, w, mat_tex.shape[0], n_mips,
                  int(two_mat and not trilinear), int(trilinear), int(aniso),
                  float(mip_bias))
    return out
