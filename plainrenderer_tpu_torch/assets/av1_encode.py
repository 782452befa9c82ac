"""The AV1 frame encoder: one key frame of 8-bit 4:2:0 (or monochrome)
planes into the temporal unit libavif stores as an item, with libaom
3.12's frame-level rules at libavif's settings (all-intra usage, speed 6):

  - the sequence header: reduced still picture, the level the picture's
    size needs (the first level of the AV1 specification's table A.3
    whose MaxPicSize, MaxHSize and MaxVSize hold it), 128 x 128
    superblocks where both sides exceed 480 samples, filter intra and
    the intra edge filter on, CDEF, loop restoration and superres off
    (PIL's save refuses libaom's superres options, so writes none),
    no colour description, full range;
  - the tiles: libavif's automatic tiling (a tile per 512 x 512 of area,
    rounded up to a power of two and split towards the longer side) and
    at least as many columns as keep a tile within 4,096 samples with a
    superblock of margin;
  - screen content tools where more than a tenth of the 16 x 16 luma
    blocks hold two to four values (av1_set_screen_content_options);
  - base_q_idx 64 (quality 75), no delta q, no quantizer matrices, no
    segmentation;
  - the deblocking level from the q index (LPF_PICK_FROM_Q's key-frame
    fit on the AC step), sharpness 0;
  - TX_MODE_SELECT, the search deciding each block's transform size.
    libaom's search writes TX_MODE_LARGEST on some pictures, PIL's small
    saves among them: like allow_intrabc (0 here), a header field its
    search decides, not a rule.

The tiles are written by the tile decoder of assets/av1_block.py run
with a decision source in its symbol decoder's place
(assets/av1_block_encode.py): each syntax element is decided when the
decoder reads it, and the coefficients of each transform block from the
decoder's own prediction of it (libaom's forward transform, quantize_b
and dropout: assets/av1_fwd_transform.py, av1_quantize.py), so the
reconstruction the encoder predicts from is the decoder's. libaom codes
every intra block with skip 0 (its encode_block_intra: "skipped blocks
are so rare"), whatever its coefficients; so does the port. The
decisions themselves come from a separate object, a ``Plan``: the port's
intra search (assets/av1_intra_search.py) or any other subclass, which
``write_frame`` runs under the same headers.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import (av1_block, av1_block_encode, av1_fwd_transform, av1_loopfilter,
               av1_obu, av1_obu_write, av1_quantize)
from .av1_block import BLOCK_DIMS, PART_SPLIT, TX_DIMS, TX_INV_SET1, TX_INV_SET2
from .av1_transform import AC_Q

QINDEX = 64        # libavif's quality 75: quantizer 16
# AV1 levels (seq_level_idx: MaxPicSize, MaxHSize, MaxVSize), table A.3
LEVELS = ((0, 147456, 2048, 1152), (1, 278784, 2816, 1584),
          (4, 665856, 4352, 2448), (5, 1065024, 5504, 3096),
          (8, 2359296, 6144, 3456), (12, 8912896, 8192, 4352),
          (16, 35651584, 16384, 8704))
MAX_SIDE = 65536   # frame_width_bits_minus_1 has 4 bits


def seq_level(w: int, h: int) -> int:
    for idx, pic, mw, mh in LEVELS:
        if w * h <= pic and w <= mw and h <= mh:
            return idx
    return 31


def tile_log2s(w: int, h: int) -> tuple:
    """(tile columns log2, tile rows log2) for a w x h picture."""
    tiles = max(1, -(-(w * h) // (512 * 512)))
    n = tiles.bit_length() - 1
    if w >= h:
        ratio_log2 = (w // h).bit_length() - 1
        rows = max(n - ratio_log2, 0) // 2
        cols = n - rows
    else:
        ratio_log2 = (h // w).bit_length() - 1
        cols = max(n - ratio_log2, 0) // 2
        rows = n - cols
    need = av1_obu._tile_log2(4096, w + 64)
    return max(cols, need), rows


def lf_level(qindex: int) -> int:
    q = int(AC_Q[0, qindex])
    return max(0, min(63, (q * 17563 - 421574 + (1 << 17)) >> 18))


def screen_content(y: np.ndarray) -> bool:
    """av1_set_screen_content_options' test on the source luma."""
    h, w = y.shape
    n = 0
    if h >= 16 and w >= 16:
        blocks = y[:h // 16 * 16, :w // 16 * 16].reshape(h // 16, 16, w // 16, 16)
        blocks = blocks.transpose(0, 2, 1, 3).reshape(-1, 256)
        s = np.sort(blocks, axis=1)
        colors = 1 + (np.diff(s.astype(np.int16), axis=1) != 0).sum(axis=1)
        n = int(((colors > 1) & (colors <= 4)).sum())
    return n * 256 * 10 > w * h


def headers(w: int, h: int, mono: bool, y: np.ndarray):
    """The sequence header and the frame header (every field the decoder
    derives) the port writes for this picture, before its tiles."""
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE):
        raise ValueError(f"AV1 frame of {w} x {h} samples")
    seq = SimpleNamespace(
        profile=0, still_picture=1, reduced=1, level=seq_level(w, h),
        frame_width_bits=max(1, (w - 1).bit_length()),
        frame_height_bits=max(1, (h - 1).bit_length()),
        max_width=w, max_height=h, use_128=int(min(w, h) > 480),
        enable_filter_intra=1, enable_intra_edge_filter=1,
        enable_superres=0, enable_cdef=0, enable_restoration=0, bit_depth=8,
        mono=int(mono), color_description_present=0, cp=2, tc=2, mc=2,
        color_range=1, csp=0, separate_uv_delta_q=0,
        film_grain_params_present=0)
    data = av1_obu_write.sequence_header(seq)
    seq = av1_obu.sequence_header(data, 0, len(data))
    cols, rows = tile_log2s(w, h)
    lf = lf_level(QINDEX)
    fh = SimpleNamespace(
        disable_cdf_update=0, allow_screen_content_tools=int(screen_content(y)),
        force_integer_mv_bit=0, use_superres=0, allow_intrabc=0,
        uniform_tile_spacing=1, tile_cols_log2=cols, tile_rows_log2=rows,
        context_update_tile_id=0, tile_size_bytes=4,
        mi_cols=2 * ((w + 7) >> 3), mi_rows=2 * ((h + 7) >> 3),
        base_q_idx=QINDEX, dq_y_dc=0, dq_u_dc=0, dq_u_ac=0, using_qmatrix=0,
        seg_enabled=0, delta_q_present=0, coded_lossless=0,
        lf_level=[lf, lf, lf, lf], lf_sharpness=0, lf_delta_enabled=1,
        lf_delta_update=0, lf_ref_deltas=[1, 0, 0, 0, -1, 0, -1, -1],
        lf_mode_deltas=[0, 0], tx_mode_select=1, reduced_tx_set=0)
    return seq, _reparse(seq, fh)


def _reparse(seq, fh):
    w = av1_obu_write.BitWriter()
    av1_obu_write.frame_header(w, seq, fh)
    w.byte_align()
    data = w.data()
    hdr, _ = av1_obu.frame_header(data, 0, len(data), seq)
    if hdr.tile_cols_log2 != fh.tile_cols_log2 or hdr.tile_rows_log2 != fh.tile_rows_log2:
        raise ValueError("AV1 tiling outside the frame's limits")
    return hdr


# ------------------------------------------------------------- planning

def coefficient_symbols(levels: np.ndarray, t: int, tx_class: int) -> tuple:
    """The values the tile decoder reads for a transform block's nonzero
    levels ((min(h,32), min(w,32)) array): {element name prefix: [values
    in reading order]} and the fixed-probability bits in reading order."""
    scan = av1_block.coef_plan(t, tx_class)[0]
    flat = levels.reshape(-1)
    q = [int(flat[p]) for p in scan]
    eob = max(i for i, v in enumerate(q) if v) + 1
    sym = {"eob_pt": [], "eob_extra": [], "coeff_base_eob": [],
           "coeff_base": [], "coeff_br": [], "dc_sign": []}
    bits = []
    pt = 1 if eob == 1 else (eob - 1).bit_length() + 1
    sym["eob_pt"].append(pt - 1)
    if pt >= 3:
        off = eob - (1 << (pt - 2)) - 1
        sym["eob_extra"].append((off >> (pt - 3)) & 1)
        for i in range(pt - 4, -1, -1):
            bits.append((off >> i) & 1)
    for ci in range(eob - 1, -1, -1):
        lv = abs(q[ci])
        if ci == eob - 1:
            sym["coeff_base_eob"].append(min(lv, 3) - 1)
        else:
            sym["coeff_base"].append(min(lv, 3))
        if lv > 2:
            rest = lv - 3
            for _ in range(4):
                k = min(rest, 3)
                sym["coeff_br"].append(k)
                rest -= k
                if k < 3:
                    break
    for ci in range(eob):
        v = q[ci]
        if not v:
            continue
        if ci == 0:
            sym["dc_sign"].append(int(v < 0))
        else:
            bits.append(int(v < 0))
        if abs(v) > 14:
            x = abs(v) - 14
            n = x.bit_length()
            bits.extend([0] * (n - 1) + [1])
            bits.extend((x >> i) & 1 for i in range(n - 2, -1, -1))
    return sym, bits


# coefficient element names by prefix (eob_pt_16 ... eob_pt_1024), the
# longer before the shorter it starts with
_COEF_KINDS = ("eob_pt", "eob_extra", "coeff_base_eob", "coeff_base",
               "coeff_br", "dc_sign")


class Plan:
    """A tile's decision source. A subclass decides the partition of each
    node and each block's modes (``choose_partition``, ``choose_block``:
    y_mode, angles, uv_mode, cfl_sign, cfl_alphas, filter_mode, tx_depth,
    tx_type); this class answers the tile decoder's reads from those
    decisions and quantizes each transform block from the decoder's own
    prediction of it (``levels``)."""

    def __init__(self, src: list):
        self.src = src          # source planes, padded to the frame state's
        self.q = QINDEX
        self.part = None
        self.blk = None
        self.queue = {}
        self.bits_tx = []
        self.bits_blk = []

    # hooks from the planning tile decoder
    def start(self, td):
        self.td = td
        td.plan = self

    def partition(self, td, r, c, bsize):
        self.part = self.choose_partition(td, r, c, bsize)

    def tx_block(self, td, x, y, plane, t):
        tw, th = TX_DIMS[t]
        if plane == 0:
            tt = self.blk.tx_type
        else:
            tt = td._compute_tx_type(plane, t, x >> 2, y >> 2)
        pred = td.fs.planes[plane][y:y + th, x:x + tw]
        res = self.src[plane][y:y + th, x:x + tw] - pred
        lv = self.levels(res, tt, t, plane, x, y)
        self.queue = {}
        self.bits_tx = []
        self.cur_zero = not lv.any()
        if not self.cur_zero:
            sym, bits = coefficient_symbols(lv, t, av1_block.tx_class_of(tt))
            self.queue = dict(sym, tx_type=[tt])
            self.bits_tx = bits

    def levels(self, res, tt, t, plane, x, y):
        tw, th = TX_DIMS[t]
        co = av1_fwd_transform.forward_2d(res, tt)
        lv = av1_quantize.quantize_b(co, self.q, av1_quantize.log_scale(tw, th))
        scan = av1_block.coef_plan(t, av1_block.tx_class_of(tt))[0]
        return av1_quantize.dropout(lv, scan, tw, th, self.q)

    # the symbol decoder's interface through av1_block_encode.SymbolWriter
    def symbol(self, name, cdf):
        return self._answer(name[0])

    def bool(self, icdf0):
        if self.part is not None:
            v = int(self.part == PART_SPLIT)
            self.part = None
            return v
        if self.bits_blk:
            return self.bits_blk.pop(0)
        return self.bits_tx.pop(0)

    def _answer(self, kind):
        if kind.startswith("partition"):
            v, self.part = self.part, None
            return v
        if kind == "skip":
            self.blk = self.choose_block(self.td)
            return 0
        b = self.blk
        if kind == "kf_y_mode":
            return b.y_mode
        if kind == "angle_delta":
            return b.angles.pop(0) + 3
        if kind in ("uv_mode_cfl", "uv_mode_nocfl"):
            return b.uv_mode
        if kind == "cfl_sign":
            return b.cfl_sign
        if kind == "cfl_alpha":
            return b.cfl_alphas.pop(0)
        if kind == "filter_intra":
            return int(b.filter_mode is not None)
        if kind == "filter_intra_mode":
            return b.filter_mode
        if kind == "palette_y_mode":
            if b.palette is None:
                return 0
            self.pal_syms, self.bits_blk = palette_symbols(self.td, b.palette)
            return 1
        if kind == "palette_y_size":
            return len(b.palette.colors) - 2
        if kind.startswith("palette_y_color"):
            return self.pal_syms.pop(0)
        if kind in ("palette_uv_mode", "intrabc"):
            return 0
        if kind in ("tx8", "tx16", "tx32", "tx64"):
            return b.tx_depth
        if kind == "txb_skip":
            return int(self.cur_zero)
        if kind in ("intra_tx_set1", "intra_tx_set2"):
            tt = self.queue["tx_type"][0]
            inv = TX_INV_SET1 if kind == "intra_tx_set1" else TX_INV_SET2
            return inv.index(tt)
        for pre in _COEF_KINDS:
            if kind.startswith(pre):
                return self.queue[pre].pop(0)
        raise ValueError(f"the AV1 encoder has no answer for {kind}")


def palette_symbols(td, pal) -> tuple:
    """The colour map's symbols and the bits before them (the colour cache
    flags, the new colours, the map's first index) for a luma palette
    ``pal`` (colors ascending, map over the block) of the block td is
    coding."""
    colors, m = pal.colors, pal.map
    n = len(colors)
    bits = []
    used = []
    for v in td._palette_cache(0):
        if len(used) >= n:
            break
        hit = v in colors and v not in used
        bits.append(int(hit))
        if hit:
            used.append(v)
    new = [v for v in colors if v not in used]
    if new:
        bits.extend((new[0] >> i) & 1 for i in range(7, -1, -1))
    if len(new) > 1:
        nb = max(5, max((b - a - 1).bit_length() for a, b in zip(new, new[1:])))
        bits.extend(((nb - 5) >> i) & 1 for i in (1, 0))
        for a, b in zip(new, new[1:]):
            bits.extend(((b - a - 1) >> i) & 1 for i in range(nb - 1, -1, -1))
            rng = 255 - b
            nb = min(nb, max(0, (rng - 1).bit_length()) if rng > 0 else 0)
    w = n.bit_length()
    lim = (1 << w) - n
    x = int(m[0][0])
    if x < lim:
        bits.extend((x >> i) & 1 for i in range(w - 2, -1, -1))
    else:
        x += lim
        bits.extend(((x >> 1) >> i) & 1 for i in range(w - 2, -1, -1))
        bits.append(x & 1)
    h = td.h
    bw, bh = BLOCK_DIMS[td.mi_size]
    ow = min(bw, (h.mi_cols - td.mi_col) * 4)
    oh = min(bh, (h.mi_rows - td.mi_row) * 4)
    syms = []
    ml = [list(map(int, row)) for row in m]
    for rr, cc in av1_block.color_scan(ow, oh):
        _, order = av1_block.color_context(ml, rr, cc, n)
        syms.append(order.index(ml[rr][cc]))
    return syms, bits


class Planner(av1_block.TileDecoder):
    """The tile decoder with the encoder's hooks: the partition decision
    before a node's read, the coefficients of a transform block once the
    decoder has predicted it."""

    def partition(self, r, c, bsize):
        h = self.h
        if r < h.mi_rows and c < h.mi_cols and bsize >= av1_block.BLOCK_8X8:
            half = BLOCK_DIMS[bsize][0] >> 3
            if r + half < h.mi_rows or c + half < h.mi_cols:
                self.plan.partition(self, r, c, bsize)
        super().partition(r, c, bsize)

    def _coeffs(self, start_x, start_y, plane, t):
        self.plan.tx_block(self, start_x, start_y, plane, t)
        return super()._coeffs(start_x, start_y, plane, t)


def padded_sources(planes: list, seq, hdr) -> list:
    """The source planes edge-extended to the frame state's planes."""
    out = []
    for p, s in enumerate(planes):
        ph, pw = av1_block.plane_shape(seq, hdr, p)
        out.append(np.pad(np.asarray(s, np.int64),
                          ((0, ph - s.shape[0]), (0, pw - s.shape[1])),
                          mode="edge"))
    return out


def encode_frame(planes: list, make_plan) -> SimpleNamespace:
    """One key frame of [Y, U, V] (4:2:0) or [Y] (monochrome) u8 planes
    under ``headers``' headers: write_frame's result."""
    y = np.asarray(planes[0])
    h, w = y.shape
    seq, hdr = headers(w, h, len(planes) == 1, y)
    return write_frame(planes, seq, hdr, make_plan)


def write_frame(planes: list, seq, hdr, make_plan) -> SimpleNamespace:
    """The frame of the u8 planes under the given headers, the decisions
    from make_plan(padded sources, tile index); returns the temporal unit
    (``data``), the headers, the reconstruction after deblocking cropped
    to the picture (``planes``) and the tiles' plans."""
    h, w = np.asarray(planes[0]).shape
    n = hdr.tile_cols * hdr.tile_rows
    src = padded_sources(planes, seq, hdr)
    plans = [make_plan(src, t) for t in range(n)]
    tiles, fs = av1_block_encode.write_tiles(seq, hdr, plans,
                                             tile_decoder=Planner)
    hdr.tile_size_bytes = av1_obu_write.tile_size_bytes(tiles)
    sizes = [len(t) for t in tiles]
    hdr.context_update_tile_id = sizes.index(max(sizes))
    data = av1_obu_write.temporal_unit(seq, hdr, tiles)
    av1_loopfilter.apply(fs)
    out = []
    for p in range(seq.num_planes):
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        out.append(fs.planes[p][:(h + sy) >> sy, :(w + sx) >> sx].copy())
    return SimpleNamespace(data=data, seq=seq, hdr=hdr, planes=out,
                           plans=plans, tiles=tiles)
