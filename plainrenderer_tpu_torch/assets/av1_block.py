"""AV1 intra tile decoding (the AV1 specification, sections 5.11 and 6.10,
with the block-level processes of section 7): the superblock loop,
partitions, intra frame mode info (segment ids, skip, CDEF index, delta q
and delta lf, y / uv modes with angle deltas, CfL alphas, palette with its
colour cache, filter intra), transform sizes and types, the coefficient
syntax (txb skip, eob, base / br levels, Golomb, dc sign, scans) and the
reconstruction of each transform block in decoding order.

Per-4x4 state (modes, sizes, skips, segment ids, transform sizes) lives in
frame-wide numpy arrays the post filters read afterwards, each in the
narrowest dtype that holds it (8-bit planes as uint8, 10 and 12-bit ones
as uint16, vectors as int32), so a 16384 x 16384 frame fits; arithmetic on samples is int64.

``RecordingDecoder`` is a symbol decoder that also lists every syntax
element the tile decoder reads from it: (CDF name, context, value) for a
symbol, ("bool", icdf0, bit) for a bit read at a fixed probability. The
tile decoder itself is the same with or without it; assets/
av1_block_encode.py drives it with a symbol writer in the decoder's place.
"""

from __future__ import annotations

import copy

import numpy as np

from . import av1_intra, av1_intrabc, av1_msac, av1_restoration, av1_transform
from .av1_cdf import TABLES
from .av1_obu import AV1Error, qindex

# block sizes: enum -> (width, height) in pixels
BLOCK_DIMS = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16),
              (16, 32), (32, 16), (32, 32), (32, 64), (64, 32), (64, 64),
              (64, 128), (128, 64), (128, 128), (4, 16), (16, 4), (8, 32),
              (32, 8), (16, 64), (64, 16))
BLOCK_OF = {d: i for i, d in enumerate(BLOCK_DIMS)}
TX_DIMS = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
           (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
           (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
TX_OF = {d: i for i, d in enumerate(TX_DIMS)}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
(PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT, PART_HORZ_A, PART_HORZ_B,
 PART_VERT_A, PART_VERT_B, PART_HORZ_4, PART_VERT_4) = range(10)
DC_PRED, V_PRED, H_PRED, D157_PRED, UV_CFL = 0, 1, 2, 6, 13
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
MODE_TO_TXFM = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0)
FILTER_INTRA_DIR = (DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED)
TX_INV_SET1 = (9, 0, 10, 11, 3, 1, 2)   # IDTX DCT V_DCT H_DCT ADST_ADST ...
TX_INV_SET2 = (9, 0, 3, 1, 2)
INTER_INV = {11: (9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8),
             12: (9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8), 13: (9, 0)}
TX_SETS = {0: {0}, 1: {0, 1, 2, 3, 9, 10, 11}, 2: {0, 1, 2, 3, 9},
           11: set(range(16)), 12: set(INTER_INV[12]), 13: {0, 9}}
PALETTE_COLOR_CONTEXT = (-1, -1, 0, -1, -1, 4, 3, 2, 1)


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _split_tx(t: int) -> int:
    w, h = TX_DIMS[t]
    if w == h:
        return TX_OF[(max(4, w // 2), max(4, h // 2))]
    if max(w, h) == 2 * min(w, h):
        return TX_OF[(min(w, h), min(w, h))]
    return TX_OF[(w // 2, h)] if w > h else TX_OF[(w, h // 2)]


SPLIT_TX = tuple(_split_tx(t) for t in range(19))
MAX_TX_RECT = tuple(TX_OF[(min(w, 64), min(h, 64))] for w, h in BLOCK_DIMS)


def _depth(t):
    d = 0
    while t != 0:
        t = SPLIT_TX[t]
        d += 1
    return d


MAX_TX_DEPTH = tuple(_depth(t) for t in MAX_TX_RECT)
TX_SQR = tuple(TX_OF[(min(w, h), min(w, h))] for w, h in TX_DIMS)
TX_SQR_UP = tuple(TX_OF[(max(w, h), max(w, h))] for w, h in TX_DIMS)


def _adjusted(t):
    w, h = TX_DIMS[t]
    return TX_OF[(min(w, 32), min(h, 32))]


ADJUSTED = tuple(_adjusted(t) for t in range(19))


def _qm_offsets():
    off, out = 0, {}
    for t, (w, h) in enumerate(TX_DIMS):
        if w <= 32 and h <= 32:
            out[t] = off
            off += w * h
    return {t: out[ADJUSTED[t]] for t in range(19)}


QM_OFFSET = _qm_offsets()


def _scan(w, h, kind):
    """Scan order in row-major positions: 0 default (zig-zag for squares,
    one-way diagonals for rectangles), 1 row (V class), 2 column (H
    class)."""
    if kind == 1:
        return list(range(w * h))
    if kind == 2:
        return [r * w + c for c in range(w) for r in range(h)]
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w == h:
            if d % 2 == 0:
                cells.reverse()
        elif w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return out


def _coef_plan(t: int, tx_class: int) -> tuple:
    """Per transform size and class: scan, padded level indices, the
    neighbour offsets and context offsets of coeff_base and coeff_br."""
    w, h = TX_DIMS[ADJUSTED[t]]
    rw, rh = TX_DIMS[t]       # the context offsets follow the real shape
    kind = 0 if tx_class == 0 else (1 if tx_class == 2 else 2)
    scan = _scan(w, h, kind)
    W = w + 4
    pidx = [(p // w) * W + p % w for p in scan]
    if tx_class == 0:
        nb = (1, W, W + 1, 2, 2 * W)
        nbr = (1, W, W + 1)
    elif tx_class == 1:   # horizontal class: along the row
        nb = (1, W, 2, 3, 4)
        nbr = (1, W, 2)
    else:
        nb = (1, W, 2 * W, 3 * W, 4 * W)
        nbr = (1, W, 2 * W)
    off, offr = [], []
    for p in scan:
        r, c = p // w, p % w
        if tx_class == 0:
            if r == 0 and c == 0:
                o = -1
            elif rw > rh and c < 2:
                o = 16
            elif rw < rh and r < 2:
                o = 11
            else:
                s = r + c
                o = 1 if s == 1 else 6 if s < 4 else 21
            orr = 0 if p == 0 else (7 if r < 2 and c < 2 else 14)
        else:
            idx = c if tx_class == 1 else r
            o = 26 + 5 * min(idx, 2)
            orr = 0 if p == 0 else (7 if idx == 0 else 14)
        off.append(o)
        offr.append(orr)
    return scan, pidx, nb, nbr, off, offr, w, h


_PLANS: dict = {}


def coef_plan(t, tx_class):
    key = (t, tx_class)
    if key not in _PLANS:
        _PLANS[key] = _coef_plan(t, tx_class)
    return _PLANS[key]


def tx_class_of(tx_type: int) -> int:
    if tx_type in (10, 12, 14):   # V_*: vertical class
        return 2
    if tx_type in (11, 13, 15):   # H_*: horizontal class
        return 1
    return 0


def _cdf_tree(a: np.ndarray):
    if a.ndim == 1:
        return [int(v) for v in a] + [0]
    return [_cdf_tree(x) for x in a]


_DEFAULTS: dict = {}


def default_cdfs(base_q_idx: int) -> dict:
    """The frame's starting CDFs: the mode CDFs and the coefficient CDFs of
    the q context base_q_idx selects."""
    qctx = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3
    if qctx not in _DEFAULTS:
        d = {}
        for k, v in TABLES.items():
            if v.dtype == np.dtype("<u2") and k not in (
                    "dc_q", "ac_q", "dr_intra_derivative", "sgr_x_by_xplus1",
                    "sgr_one_by_x"):
                if k in ("txb_skip", "eob_extra", "dc_sign", "coeff_base_eob",
                         "coeff_base", "coeff_br") or k.startswith("eob_pt"):
                    d[k] = _cdf_tree(v[qctx])
                else:
                    d[k] = _cdf_tree(v)
        _DEFAULTS[qctx] = d
    return copy.deepcopy(_DEFAULTS[qctx])


def plane_shape(seq, hdr, p: int) -> tuple:
    """The (rows, columns) of plane p in the frame state: the frame's mode
    info grid in samples, with 160 of margin for blocks past its edge."""
    sx = seq.ssx if p else 0
    sy = seq.ssy if p else 0
    return ((hdr.mi_rows * 4) >> sy) + 160, ((hdr.mi_cols * 4) >> sx) + 160


class FrameState:
    """What decoding writes and the post filters read."""

    def __init__(self, seq, hdr):
        self.seq, self.hdr = seq, hdr
        mr, mc = hdr.mi_rows, hdr.mi_cols
        pad = 32
        shape = (mr + pad, mc + pad)
        self.mi_size = np.zeros(shape, np.int8)
        self.skip = np.zeros(shape, np.int8)
        self.seg_id = np.zeros(shape, np.int8)
        self.y_mode = np.zeros(shape, np.int8)
        self.uv_mode = np.zeros(shape, np.int8)
        self.is_inter = np.zeros(shape, np.int8)
        self.tx_size = np.zeros(shape, np.int8)
        self.pal_size = np.zeros((2,) + shape, np.int8)
        self.pal_colors = [dict(), dict()]
        self.delta_lf = np.zeros(shape + (4,), np.int8)
        self.cdef_idx = np.full(((mr + 15) // 16 + 2, (mc + 15) // 16 + 2), -1,
                                np.int8)
        self.planes = []
        self.lf_tx = []
        self.tx_type = np.zeros(shape, np.int8)
        self.mvs = np.zeros(shape + (2,), np.int32)
        self.decoded_mi = np.zeros(shape, bool)
        dtype = np.uint8 if seq.bit_depth == 8 else np.uint16
        for p in range(seq.num_planes):
            ph, pw = plane_shape(seq, hdr, p)
            self.planes.append(np.zeros((ph, pw), dtype))
            self.lf_tx.append(np.zeros((ph // 4 + 1, pw // 4 + 1), np.int8))
        self.lr = {}
        self.tools = set()   # the coding tools this frame used


class TileDecoder:
    block_dims = BLOCK_DIMS

    def __init__(self, fs: FrameState, cdfs: dict, sd, row_start, row_end,
                 col_start, col_end):
        self.fs = fs
        self.seq = fs.seq
        self.h = fs.hdr
        self.c = cdfs
        self.sd = sd
        self.r0, self.r1, self.c0, self.c1 = row_start, row_end, col_start, col_end
        seq = self.seq
        self.bd = seq.bit_depth
        self.maxv = (1 << self.bd) - 1
        np_ = seq.num_planes
        w4 = fs.hdr.mi_cols + 64
        h4 = fs.hdr.mi_rows + 64
        self.above_level = [[0] * w4 for _ in range(np_)]
        self.above_dc = [[0] * w4 for _ in range(np_)]
        self.left_level = [[0] * h4 for _ in range(np_)]
        self.left_dc = [[0] * h4 for _ in range(np_)]
        self.delta_lf = [0, 0, 0, 0]
        self.uv_mode_ = DC_PRED
        self.mv_cdfs = av1_intrabc.mv_cdfs(cdfs)
        self.ref_lr = None
        self.current_q = self.h.base_q_idx
        self.sb4 = 32 if seq.use_128 else 16

    # -------------------------------------------------------------- tile
    def decode(self):
        h = self.h
        self.ref_lr = av1_restoration.reference_params(self.seq.num_planes)
        sb = self.sb4
        for r in range(self.r0, self.r1, sb):
            np_ = self.seq.num_planes
            for p in range(np_):
                self.left_level[p] = [0] * len(self.left_level[p])
                self.left_dc[p] = [0] * len(self.left_dc[p])
            for c in range(self.c0, self.c1, sb):
                self.read_deltas = h.delta_q_present
                self._clear_decoded(r, c)
                if h.uses_lr and not h.allow_intrabc:
                    av1_restoration.read_lr(self, r, c, sb)
                self.partition(r, c, BLOCK_128X128 if sb == 32 else BLOCK_64X64)

    def _inside(self, r, c):
        return self.c0 <= c < self.c1 and self.r0 <= r < self.r1

    def _clear_decoded(self, r, c):
        """clear_block_decoded_flags for the superblock at (r, c)."""
        seq = self.seq
        self.sb_r, self.sb_c = r, c
        self.decoded = []
        sb = self.sb4
        for p in range(seq.num_planes):
            sx = seq.ssx if p else 0
            sy = seq.ssy if p else 0
            wid = (self.c1 - c) >> sx
            hei = (self.r1 - r) >> sy
            n = (sb >> sy) + 3
            m = (sb >> sx) + 3
            d = np.zeros((n, m), np.int8)    # index [y + 1][x + 1]
            d[0, 1:1 + min(m - 1, max(wid, 0))] = 1
            d[1:1 + min(n - 1, max(hei, 0)), 0] = 1
            d[0, 0] = 1
            d[(sb >> sy) + 1, 0] = 0
            self.decoded.append(d)

    # --------------------------------------------------------- partition
    def partition(self, r, c, bsize):
        h = self.h
        if r >= h.mi_rows or c >= h.mi_cols:
            return
        fs = self.fs
        bw = BLOCK_DIMS[bsize][0]
        num4 = bw >> 2
        half = num4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < h.mi_rows
        has_cols = (c + half) < h.mi_cols
        avail_u = self._inside(r - 1, c)
        avail_l = self._inside(r, c - 1)
        if bsize < BLOCK_8X8:
            part = PART_NONE
        else:
            bsl = _log2(num4)
            above = avail_u and (_log2(BLOCK_DIMS[fs.mi_size[r - 1, c]][0] >> 2) < bsl)
            left = avail_l and (_log2(BLOCK_DIMS[fs.mi_size[r, c - 1]][1] >> 2) < bsl)
            ctx = left * 2 + above
            cdf = self.c["partition%d" % bw][ctx]
            if has_rows and has_cols:
                part = self.sd.symbol(cdf)
            elif has_cols:
                prob = _psum(cdf, (PART_VERT, PART_SPLIT, PART_HORZ_A,
                                   PART_VERT_A, PART_VERT_B)
                             + ((PART_VERT_4,) if bsize != BLOCK_128X128 else ()))
                part = PART_SPLIT if self.sd.bool_prob(prob) else PART_HORZ
            elif has_rows:
                prob = _psum(cdf, (PART_HORZ, PART_SPLIT, PART_HORZ_A,
                                   PART_HORZ_B, PART_VERT_A)
                             + ((PART_HORZ_4,) if bsize != BLOCK_128X128 else ()))
                part = PART_SPLIT if self.sd.bool_prob(prob) else PART_VERT
            else:
                part = PART_SPLIT
        bw_, bh_ = BLOCK_DIMS[bsize]
        if part == PART_NONE:
            self._check_chroma_size(bsize)
            self.block(r, c, bsize)
            return
        sub = {PART_HORZ: (bw_, bh_ // 2), PART_VERT: (bw_ // 2, bh_),
               PART_SPLIT: (bw_ // 2, bh_ // 2), PART_HORZ_A: (bw_, bh_ // 2),
               PART_HORZ_B: (bw_, bh_ // 2), PART_VERT_A: (bw_ // 2, bh_),
               PART_VERT_B: (bw_ // 2, bh_), PART_HORZ_4: (bw_, bh_ // 4),
               PART_VERT_4: (bw_ // 4, bh_)}[part]
        if sub not in BLOCK_OF:
            raise AV1Error("AV1 partition to an invalid block size")
        sub = BLOCK_OF[sub]
        self._check_chroma_size(sub)
        split = BLOCK_OF.get((bw_ // 2, bh_ // 2))
        if part == PART_HORZ:
            self.block(r, c, sub)
            if has_rows:
                self.block(r + half, c, sub)
        elif part == PART_VERT:
            self.block(r, c, sub)
            if has_cols:
                self.block(r, c + half, sub)
        elif part == PART_SPLIT:
            self.partition(r, c, sub)
            self.partition(r, c + half, sub)
            self.partition(r + half, c, sub)
            self.partition(r + half, c + half, sub)
        elif part == PART_HORZ_A:
            self.block(r, c, split)
            self.block(r, c + half, split)
            self.block(r + half, c, sub)
        elif part == PART_HORZ_B:
            self.block(r, c, sub)
            self.block(r + half, c, split)
            self.block(r + half, c + half, split)
        elif part == PART_VERT_A:
            self.block(r, c, split)
            self.block(r + half, c, split)
            self.block(r, c + half, sub)
        elif part == PART_VERT_B:
            self.block(r, c, sub)
            self.block(r, c + half, split)
            self.block(r + half, c + half, split)
        elif part == PART_HORZ_4:
            for k in range(4):
                if k < 3 or r + quarter * 3 < h.mi_rows:
                    self.block(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < h.mi_cols:
                    self.block(r, c + quarter * k, sub)

    def _check_chroma_size(self, bsize):
        """A partition's block must have a chroma block size: in 4:2:2 no
        block taller than wide has one (dav1d fails the frame on the
        vertical partitions; libaom never writes them there)."""
        seq = self.seq
        if seq.num_planes > 1 and seq.ssx and not seq.ssy:
            w, h = BLOCK_DIMS[bsize]
            if w < h:
                raise AV1Error("AV1 4:2:2 partition to a block with no "
                               "chroma size")

    # ------------------------------------------------------------- block
    def block_setup(self, r, c, bsize):
        """The block's position, size, chroma and neighbour availability
        (what block() sets before its first read)."""
        seq = self.seq
        self.mi_row, self.mi_col, self.mi_size = r, c, bsize
        bw, bh = BLOCK_DIMS[bsize]
        bw4, bh4 = bw >> 2, bh >> 2
        self.bw4, self.bh4 = bw4, bh4
        if bh4 == 1 and seq.ssy and (r & 1) == 0:
            has_chroma = False
        elif bw4 == 1 and seq.ssx and (c & 1) == 0:
            has_chroma = False
        else:
            has_chroma = seq.num_planes > 1
        self.has_chroma = has_chroma
        self.avail_u = self._inside(r - 1, c)
        self.avail_l = self._inside(r, c - 1)
        self.avail_u_c = self.avail_u
        self.avail_l_c = self.avail_l
        if has_chroma:
            if seq.ssy and bh4 == 1:
                self.avail_u_c = self._inside(r - 2, c)
            if seq.ssx and bw4 == 1:
                self.avail_l_c = self._inside(r, c - 2)
        else:
            self.avail_u_c = self.avail_l_c = False

    def block(self, r, c, bsize):
        fs, h, seq, sd = self.fs, self.h, self.seq, self.sd
        self.block_setup(r, c, bsize)
        bw, bh = BLOCK_DIMS[bsize]
        bw4, bh4 = self.bw4, self.bh4
        has_chroma = self.has_chroma
        # intra_frame_mode_info
        self.skip = 0
        if h.seg_id_pre_skip:
            self._segment_id()
        self.skip = 0
        if h.seg_id_pre_skip and h.seg_feature[self.segment_id][6]:
            self.skip = 1
        else:
            ctx = 0
            if self.avail_u:
                ctx += fs.skip[r - 1, c]
            if self.avail_l:
                ctx += fs.skip[r, c - 1]
            self.skip = sd.symbol(self.c["skip"][ctx])
        if not h.seg_id_pre_skip:
            self._segment_id()
        self.lossless = h.lossless[self.segment_id]
        self._read_cdef()
        self._read_delta_q()
        self._read_delta_lf()
        self.read_deltas = 0
        self.use_intrabc = 0
        if h.allow_intrabc:
            self.use_intrabc = sd.symbol(self.c["intrabc"])
        self.pal_y = self.pal_uv = 0
        self.use_filter_intra = 0
        self.angle_y = self.angle_uv = 0
        if self.use_intrabc:
            self.is_inter_ = 1
            self.y_mode_ = self.uv_mode_ = DC_PRED
            self.dv = av1_intrabc.clip_dv(self, av1_intrabc.read_dv(self),
                                          bsize)
        else:
            self.is_inter_ = 0
            am = fs.y_mode[r - 1, c] if self.avail_u else DC_PRED
            lm = fs.y_mode[r, c - 1] if self.avail_l else DC_PRED
            self.y_mode_ = sd.symbol(self.c["kf_y_mode"][INTRA_MODE_CONTEXT[am]]
                                     [INTRA_MODE_CONTEXT[lm]])
            use_angle = bsize >= BLOCK_8X8
            if use_angle and 1 <= self.y_mode_ <= 8:
                self.angle_y = sd.symbol(self.c["angle_delta"][self.y_mode_ - 1]) - 3
            if has_chroma:
                if self.lossless and self._residual_size(1) == BLOCK_4X4:
                    cfl_ok = True
                elif not self.lossless and max(bw, bh) <= 32:
                    cfl_ok = True
                else:
                    cfl_ok = False
                if cfl_ok:
                    self.uv_mode_ = sd.symbol(self.c["uv_mode_cfl"][self.y_mode_])
                else:
                    self.uv_mode_ = sd.symbol(self.c["uv_mode_nocfl"][self.y_mode_])
                if self.uv_mode_ == UV_CFL:
                    self._cfl_alphas()
                if use_angle and 1 <= self.uv_mode_ <= 8:
                    self.angle_uv = sd.symbol(self.c["angle_delta"][self.uv_mode_ - 1]) - 3
            if (bsize >= BLOCK_8X8 and bw <= 64 and bh <= 64
                    and h.allow_screen_content_tools):
                self._palette_mode_info()
            if (seq.enable_filter_intra and self.y_mode_ == DC_PRED
                    and self.pal_y == 0 and max(bw, bh) <= 32):
                self.use_filter_intra = sd.symbol(self.c["filter_intra"][bsize])
                if self.use_filter_intra:
                    self.filter_mode = sd.symbol(self.c["filter_intra_mode"])
        if self.pal_y or self.pal_uv:
            self._palette_tokens()
        self._read_tx_size(bw4, bh4)
        if self.skip:
            self._reset_block_context(bw4, bh4)
        rs, re_ = r, min(r + bh4, h.mi_rows)
        cs, ce = c, min(c + bw4, h.mi_cols)
        fs.mi_size[rs:re_, cs:ce] = bsize
        fs.skip[rs:re_, cs:ce] = self.skip
        fs.seg_id[rs:re_, cs:ce] = self.segment_id
        fs.y_mode[rs:re_, cs:ce] = self.y_mode_
        fs.uv_mode[rs:re_, cs:ce] = self.uv_mode_
        fs.is_inter[rs:re_, cs:ce] = self.is_inter_
        if not self.var_tx:
            fs.tx_size[rs:re_, cs:ce] = self.tx_sz
        fs.mvs[rs:re_, cs:ce] = self.dv if self.use_intrabc else (0, 0)
        fs.pal_size[0, rs:re_, cs:ce] = self.pal_y
        fs.pal_size[1, rs:re_, cs:ce] = self.pal_uv
        for plane, n in ((0, self.pal_y), (1, self.pal_uv)):
            if n:
                cols = self.colors_y if plane == 0 else self.colors_u
                d = fs.pal_colors[plane]
                for rr in range(rs, re_):
                    for cc in range(cs, ce):
                        d[(rr, cc)] = cols
        fs.delta_lf[rs:re_, cs:ce] = self.delta_lf
        tools = fs.tools
        if self.pal_y or self.pal_uv:
            tools.add("palette")
        if self.use_filter_intra:
            tools.add("filter_intra")
        if self.has_chroma and self.uv_mode_ == UV_CFL and not self.use_intrabc:
            tools.add("cfl")
        if seq.enable_intra_edge_filter and (1 <= self.y_mode_ <= 8
                                             and not self.use_intrabc):
            tools.add("intra_edge")
        if self.use_intrabc:
            tools.add("intrabc")
            for p in range(1 + 2 * self.has_chroma):
                av1_intrabc.predict(self, p)
        self._residual()
        fs.decoded_mi[rs:re_, cs:ce] = True

    def _residual_size(self, plane):
        bw, bh = BLOCK_DIMS[self.mi_size]
        if plane == 0:
            return self.mi_size
        seq = self.seq
        d = (max(4, bw >> seq.ssx), max(4, bh >> seq.ssy))
        if d not in BLOCK_OF:
            raise AV1Error("AV1 block with an invalid chroma size")
        return BLOCK_OF[d]

    def _segment_id(self):
        h, fs, r, c = self.h, self.fs, self.mi_row, self.mi_col
        if not h.seg_enabled:
            self.segment_id = 0
            return
        ul = fs.seg_id[r - 1, c - 1] if self.avail_u and self.avail_l else -1
        u = fs.seg_id[r - 1, c] if self.avail_u else -1
        lft = fs.seg_id[r, c - 1] if self.avail_l else -1
        if u == -1:
            pred = 0 if lft == -1 else lft
        elif lft == -1:
            pred = u
        else:
            pred = u if ul == u else lft
        if self.skip:
            self.segment_id = int(pred)
            return
        if ul < 0:
            ctx = 0
        elif ul == u and ul == lft:
            ctx = 2
        elif ul == u or ul == lft or u == lft:
            ctx = 1
        else:
            ctx = 0
        v = self.sd.symbol(self.c["segment_id"][ctx])
        mx = h.last_active_seg_id + 1
        v = _neg_deinterleave(v, int(pred), mx)
        self.segment_id = max(0, min(h.last_active_seg_id, v))

    def _read_cdef(self):
        h = self.h
        if self.skip or h.coded_lossless or not h.cdef_on or h.allow_intrabc:
            return
        r, c = self.mi_row, self.mi_col
        fr, fc = r >> 4, c >> 4
        idx = self.fs.cdef_idx
        if idx[fr, fc] == -1:
            v = self.sd.literal(h.cdef_bits)
            idx[fr, fc] = v
            bw, bh = BLOCK_DIMS[self.mi_size]
            if bw > 64:
                idx[fr, fc + 1] = v
            if bh > 64:
                idx[fr + 1, fc] = v
            if bw > 64 and bh > 64:
                idx[fr + 1, fc + 1] = v

    def _read_delta_q(self):
        h = self.h
        sbsize = BLOCK_128X128 if self.seq.use_128 else BLOCK_64X64
        if self.mi_size == sbsize and self.skip:
            return
        if self.read_deltas:
            sd = self.sd
            a = sd.symbol(self.c["delta_q"])
            if a == 3:
                bits = sd.literal(3) + 1
                a = sd.literal(bits) + (1 << bits) + 1
            if a:
                s = sd.literal(1)
                red = -a if s else a
                self.current_q = max(1, min(255, self.current_q
                                            + (red << h.delta_q_res)))

    def _read_delta_lf(self):
        h = self.h
        sbsize = BLOCK_128X128 if self.seq.use_128 else BLOCK_64X64
        if self.mi_size == sbsize and self.skip:
            return
        if self.read_deltas and h.delta_lf_present:
            sd = self.sd
            n = 1
            if h.delta_lf_multi:
                n = 4 if self.seq.num_planes > 1 else 2
            for i in range(n):
                cdf = self.c["delta_lf_multi"][i] if h.delta_lf_multi else self.c["delta_lf"]
                a = sd.symbol(cdf)
                if a == 3:
                    bits = sd.literal(3) + 1
                    a = sd.literal(bits) + (1 << bits) + 1
                if a:
                    s = sd.literal(1)
                    red = -a if s else a
                    self.delta_lf[i] = max(-63, min(63, self.delta_lf[i]
                                                    + (red << h.delta_lf_res)))

    def _cfl_alphas(self):
        sd = self.sd
        signs = sd.symbol(self.c["cfl_sign"])
        su, sv = (signs + 1) // 3, (signs + 1) % 3
        self.alpha_u = self.alpha_v = 0
        if su:
            a = sd.symbol(self.c["cfl_alpha"][(su - 1) * 3 + sv]) + 1
            self.alpha_u = -a if su == 1 else a
        if sv:
            a = sd.symbol(self.c["cfl_alpha"][(sv - 1) * 3 + su]) + 1
            self.alpha_v = -a if sv == 1 else a

    # ------------------------------------------------------------ palette
    def _palette_cache(self, plane):
        fs, r, c = self.fs, self.mi_row, self.mi_col
        above_n = left_n = 0
        if (r * 4) % 64 and self.avail_u:
            above_n = int(fs.pal_size[plane, r - 1, c])
        if self.avail_l:
            left_n = int(fs.pal_size[plane, r, c - 1])
        above = self._colors_at(plane, r - 1, c) if above_n else []
        left = self._colors_at(plane, r, c - 1) if left_n else []
        ai = li = 0
        cache = []
        while ai < above_n and li < left_n:
            a, lv = above[ai], left[li]
            if lv < a:
                if not cache or lv != cache[-1]:
                    cache.append(lv)
                li += 1
            else:
                if not cache or a != cache[-1]:
                    cache.append(a)
                ai += 1
                if lv == a:
                    li += 1
        for v in above[ai:above_n] + left[li:left_n]:
            if not cache or v != cache[-1]:
                cache.append(v)
        return cache

    def _colors_at(self, plane, r, c):
        return self.fs.pal_colors[plane].get((r, c), [])

    def _read_colors(self, n, cache, delta_plus1):
        sd, bd = self.sd, self.bd
        cols = []
        for v in cache:
            if len(cols) >= n:
                break
            if sd.literal(1):
                cols.append(v)
        if len(cols) < n:
            cols.append(sd.literal(bd))
        if len(cols) < n:
            bits = bd - 3 + sd.literal(2)
            while len(cols) < n:
                d = sd.literal(bits) + delta_plus1
                v = min(self.maxv, cols[-1] + d)
                cols.append(v)
                rng = (1 << bd) - v - delta_plus1
                bits = min(bits, max(0, (rng - 1).bit_length()) if rng > 0 else 0)
        return sorted(cols)

    def _palette_mode_info(self):
        sd, fs, r, c = self.sd, self.fs, self.mi_row, self.mi_col
        bw, bh = BLOCK_DIMS[self.mi_size]
        bctx = _log2(bw >> 2) + _log2(bh >> 2) - 2
        if self.y_mode_ == DC_PRED:
            ctx = 0
            if self.avail_u and fs.pal_size[0, r - 1, c] > 0:
                ctx += 1
            if self.avail_l and fs.pal_size[0, r, c - 1] > 0:
                ctx += 1
            if sd.symbol(self.c["palette_y_mode"][bctx][ctx]):
                self.pal_y = sd.symbol(self.c["palette_y_size"][bctx]) + 2
                self.colors_y = self._read_colors(self.pal_y,
                                                  self._palette_cache(0), 1)
        if self.has_chroma and self.uv_mode_ == DC_PRED:
            if sd.symbol(self.c["palette_uv_mode"][1 if self.pal_y else 0]):
                n = self.pal_uv = sd.symbol(self.c["palette_uv_size"][bctx]) + 2
                self.colors_u = self._read_colors(n, self._palette_cache(1), 0)
                bd = self.bd
                if sd.literal(1):
                    bits = bd - 4 + sd.literal(2)
                    v = [sd.literal(bd)]
                    for _ in range(1, n):
                        d = sd.literal(bits)
                        if d and sd.literal(1):
                            d = -d
                        val = v[-1] + d
                        if val < 0:
                            val += 1 << bd
                        if val >= 1 << bd:
                            val -= 1 << bd
                        v.append(max(0, min(self.maxv, val)))
                    self.colors_v = v
                else:
                    self.colors_v = [sd.literal(bd) for _ in range(n)]

    def _palette_tokens(self):
        h = self.h
        bw, bh = BLOCK_DIMS[self.mi_size]
        on_h = min(bh, (h.mi_rows - self.mi_row) * 4)
        on_w = min(bw, (h.mi_cols - self.mi_col) * 4)
        if self.pal_y:
            self.map_y = self._color_map(self.pal_y, bw, bh, on_w, on_h,
                                         "palette_y_color")
        if self.pal_uv:
            seq = self.seq
            bw2, bh2 = bw >> seq.ssx, bh >> seq.ssy
            ow, oh = on_w >> seq.ssx, on_h >> seq.ssy
            if bw2 < 4:
                bw2 += 2
                ow += 2
            if bh2 < 4:
                bh2 += 2
                oh += 2
            self.map_uv = self._color_map(self.pal_uv, bw2, bh2, ow, oh,
                                          "palette_uv_color")

    def _color_map(self, n, bw, bh, ow, oh, name):
        sd = self.sd
        cdfs = self.c[name + str(n)]
        m = [[0] * bw for _ in range(bh)]
        m[0][0] = sd.ns(n)
        for rr, cc in color_scan(ow, oh):
            ctx, order = color_context(m, rr, cc, n)
            m[rr][cc] = order[sd.symbol(cdfs[ctx])]
        for i in range(oh):
            for j in range(ow, bw):
                m[i][j] = m[i][ow - 1]
        for i in range(oh, bh):
            m[i] = list(m[oh - 1])
        return np.array(m, np.int64)

    # ----------------------------------------------------------- tx size
    def _read_tx_size(self, bw4, bh4):
        h, fs = self.h, self.fs
        bsize = self.mi_size
        self.var_tx = False
        if (h.tx_mode_select and bsize > BLOCK_4X4 and self.is_inter_
                and not self.skip and not self.lossless):
            self.var_tx = True
            t = MAX_TX_RECT[bsize]
            tw4, th4 = TX_DIMS[t][0] >> 2, TX_DIMS[t][1] >> 2
            for row in range(self.mi_row, self.mi_row + bh4, th4):
                for col in range(self.mi_col, self.mi_col + bw4, tw4):
                    self._var_tx(row, col, t, 0)
            return
        if self.lossless:
            self.tx_sz = 0
            return
        t = MAX_TX_RECT[bsize]
        allow = (not self.skip) or (not self.is_inter_)
        if bsize > BLOCK_4X4 and allow and h.tx_mode_select:
            depth = MAX_TX_DEPTH[bsize]
            tw, th = TX_DIMS[t]
            r, c = self.mi_row, self.mi_col
            if self.avail_u and fs.is_inter[r - 1, c]:
                aw = BLOCK_DIMS[fs.mi_size[r - 1, c]][0]
            elif self.avail_u:
                aw = self._above_tx_w(r, c)
            else:
                aw = 0
            if self.avail_l and fs.is_inter[r, c - 1]:
                lh = BLOCK_DIMS[fs.mi_size[r, c - 1]][1]
            elif self.avail_l:
                lh = self._left_tx_h(r, c)
            else:
                lh = 0
            ctx = (aw >= tw) + (lh >= th)
            cdf = self.c[("tx8", "tx16", "tx32", "tx64")[depth - 1]][ctx]
            d = self.sd.symbol(cdf)
            for _ in range(d):
                t = SPLIT_TX[t]
        self.tx_sz = t

    def _var_tx(self, row, col, t, depth):
        h, fs = self.h, self.fs
        if row >= h.mi_rows or col >= h.mi_cols:
            return
        tw, th = TX_DIMS[t]
        if t == 0 or depth == 2:
            split = 0
        else:
            above = self._above_tx_w(row, col, True) < tw
            left = self._left_tx_h(row, col, True) < th
            bw, bh = BLOCK_DIMS[self.mi_size]
            size = min(64, max(bw, bh))
            mx = TX_OF[(size, size)]
            ctx = (TX_SQR_UP[t] != mx) * 3 + (4 - mx) * 6 + above + left
            split = self.sd.symbol(self.c["txfm_split"][ctx])
        w4, h4 = tw >> 2, th >> 2
        if split:
            sub = SPLIT_TX[t]
            sw, sh = TX_DIMS[sub][0] >> 2, TX_DIMS[sub][1] >> 2
            for i in range(0, h4, sh):
                for j in range(0, w4, sw):
                    self._var_tx(row + i, col + j, sub, depth + 1)
        else:
            fs.tx_size[row:row + h4, col:col + w4] = t
            self.tx_sz = t

    def _above_tx_w(self, r, c, inside=False):
        fs = self.fs
        if inside:
            if r == self.mi_row:
                if not self.avail_u:
                    return 64
                if fs.skip[r - 1, c] and fs.is_inter[r - 1, c]:
                    return BLOCK_DIMS[fs.mi_size[r - 1, c]][0]
            return TX_DIMS[fs.tx_size[r - 1, c]][0]
        fs = self.fs
        if fs.skip[r - 1, c] and fs.is_inter[r - 1, c]:
            return BLOCK_DIMS[fs.mi_size[r - 1, c]][0]
        return TX_DIMS[fs.tx_size[r - 1, c]][0]

    def _left_tx_h(self, r, c, inside=False):
        fs = self.fs
        if inside:
            if c == self.mi_col:
                if not self.avail_l:
                    return 64
                if fs.skip[r, c - 1] and fs.is_inter[r, c - 1]:
                    return BLOCK_DIMS[fs.mi_size[r, c - 1]][1]
            return TX_DIMS[fs.tx_size[r, c - 1]][1]
        if fs.skip[r, c - 1] and fs.is_inter[r, c - 1]:
            return BLOCK_DIMS[fs.mi_size[r, c - 1]][1]
        return TX_DIMS[fs.tx_size[r, c - 1]][1]

    def _reset_block_context(self, bw4, bh4):
        seq = self.seq
        r, c = self.mi_row, self.mi_col
        for p in range(1 + 2 * self.has_chroma):
            sx = seq.ssx if p else 0
            sy = seq.ssy if p else 0
            for i in range(c >> sx, ((c + bw4 - 1) >> sx) + 1):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
            for i in range(r >> sy, ((r + bh4 - 1) >> sy) + 1):
                self.left_level[p][i] = 0
                self.left_dc[p][i] = 0

    # ---------------------------------------------------------- residual
    def _plane_tx(self, plane):
        if self.lossless:
            return 0
        if plane == 0:
            return self.tx_sz
        t = MAX_TX_RECT[self._residual_size(plane)]
        w, hh = TX_DIMS[t]
        if w == 64 or hh == 64:
            if w == 16:
                return TX_OF[(16, 32)]
            if hh == 16:
                return TX_OF[(32, 16)]
            return TX_OF[(32, 32)]
        return t

    def _residual(self):
        seq = self.seq
        bw, bh = BLOCK_DIMS[self.mi_size]
        wch = max(1, bw >> 6)
        hch = max(1, bh >> 6)
        for cy in range(hch):
            for cx in range(wch):
                for p in range(1 + 2 * self.has_chroma):
                    t = self._plane_tx(p)
                    tw, th = TX_DIMS[t]
                    sx = seq.ssx if p else 0
                    sy = seq.ssy if p else 0
                    pw, ph = BLOCK_DIMS[self._residual_size(p)]
                    n4w, n4h = pw >> 2, ph >> 2
                    bx = (self.mi_col >> sx) * 4
                    by = (self.mi_row >> sy) * 4
                    if self.is_inter_ and not self.lossless and p == 0:
                        self._transform_tree(bx + cx * 64, by + cy * 64,
                                             min(n4w, 16) * 4, min(n4h, 16) * 4)
                        continue
                    for y in range(0, min(n4h, 16 >> sy), th >> 2):
                        for x in range(0, min(n4w, 16 >> sx), tw >> 2):
                            self._transform_block(p, bx, by, t,
                                                  x + ((cx << 4) >> sx),
                                                  y + ((cy << 4) >> sy))

    def _transform_tree(self, x, y, w, h):
        hdr = self.h
        if x >= hdr.mi_cols * 4 or y >= hdr.mi_rows * 4:
            return
        t = int(self.fs.tx_size[y >> 2, x >> 2])
        tw, th = TX_DIMS[t]
        if w <= tw and h <= th:
            self._transform_block(0, x, y, t, 0, 0)
        elif w > h:
            self._transform_tree(x, y, w // 2, h)
            self._transform_tree(x + w // 2, y, w // 2, h)
        elif w < h:
            self._transform_tree(x, y, w, h // 2)
            self._transform_tree(x, y + h // 2, w, h // 2)
        else:
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    self._transform_tree(x + dx, y + dy, w // 2, h // 2)

    def _transform_block(self, plane, base_x, base_y, t, x, y):
        seq, h, fs = self.seq, self.h, self.fs
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        start_x = base_x + 4 * x
        start_y = base_y + 4 * y
        max_x = (h.mi_cols * 4) >> sx
        max_y = (h.mi_rows * 4) >> sy
        if start_x >= max_x or start_y >= max_y:
            return
        tw, th = TX_DIMS[t]
        sub_r, sub_c = self._sub(plane, start_x, start_y)
        step_x, step_y = tw >> 2, th >> 2
        if not self.is_inter_:
            self.predict_tx(plane, start_x, start_y, t, x, y)
        if not self.skip:
            eob = self._coeffs(start_x, start_y, plane, t)
            if eob > 0:
                self._reconstruct(plane, start_x, start_y, t)
        ly, lx = start_y >> 2, start_x >> 2
        fs.lf_tx[plane][ly:ly + step_y, lx:lx + step_x] = t
        dec = self.decoded[plane]
        dec[sub_r + 1:sub_r + 1 + step_y, sub_c + 1:sub_c + 1 + step_x] = 1

    def _sub(self, plane, start_x, start_y):
        """A transform block's place in its superblock's decoded flags."""
        seq = self.seq
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        row = (start_y << sy) >> 2
        col = (start_x << sx) >> 2
        sbm = self.sb4 - 1
        return (row & sbm) >> sy, (col & sbm) >> sx

    def predict_tx(self, plane, start_x, start_y, t, x, y):
        """The intra prediction of one transform block (palette, or the
        block's mode with filter intra, the edge filter and CfL) into the
        frame, from the block's modes and the neighbours decoded so far."""
        seq, h, fs = self.seq, self.h, self.fs
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        max_x = (h.mi_cols * 4) >> sx
        max_y = (h.mi_rows * 4) >> sy
        tw, th = TX_DIMS[t]
        sub_r, sub_c = self._sub(plane, start_x, start_y)
        step_x, step_y = tw >> 2, th >> 2
        frame = fs.planes[plane]
        if (plane == 0 and self.pal_y) or (plane and self.pal_uv):
            if plane == 0:
                pal, m = self.colors_y, self.map_y
            else:
                pal = self.colors_u if plane == 1 else self.colors_v
                m = self.map_uv
            pal = np.array(pal, np.int64)
            frame[start_y:start_y + th, start_x:start_x + tw] = pal[
                m[y * 4:y * 4 + th, x * 4:x * 4 + tw]]
        else:
            is_cfl = plane > 0 and self.uv_mode_ == UV_CFL
            if plane == 0:
                mode = self.y_mode_
                angle = self.angle_y
            else:
                mode = DC_PRED if is_cfl else self.uv_mode_
                angle = self.angle_uv
            dec = self.decoded[plane]
            have_left = (self.avail_l if plane == 0 else self.avail_l_c) or x > 0
            have_above = (self.avail_u if plane == 0 else self.avail_u_c) or y > 0
            ar = bool(dec[sub_r, sub_c + step_x + 1]) if sub_c + step_x + 1 < dec.shape[1] else False
            bl = bool(dec[sub_r + step_y + 1, sub_c]) if sub_r + step_y + 1 < dec.shape[0] else False
            fmode = self.filter_mode if (plane == 0 and self.use_filter_intra) else None
            ftype = self._filter_type(plane) if (
                seq.enable_intra_edge_filter and 1 <= mode <= 8) else 0
            av1_intra.predict(frame, start_x, start_y, _log2(tw), _log2(th),
                              mode, angle, have_left, have_above, ar, bl,
                              max_x - 1, max_y - 1, self.bd,
                              seq.enable_intra_edge_filter, ftype, fmode)
            if is_cfl:
                alpha = self.alpha_u if plane == 1 else self.alpha_v
                av1_intra.cfl(frame, fs.planes[0], start_x, start_y, tw, th,
                              sx, sy, self.max_luma_w, self.max_luma_h,
                              alpha, self.maxv)
        if plane == 0:
            self.max_luma_w = start_x + step_x * 4
            self.max_luma_h = start_y + step_y * 4

    def _filter_type(self, plane):
        fs, seq = self.fs, self.seq
        r, c = self.mi_row, self.mi_col
        above = left = False
        if (self.avail_u if plane == 0 else self.avail_u_c):
            rr, cc = r - 1, c
            if plane:
                if seq.ssx and not (c & 1):
                    cc += 1
                if seq.ssy and (r & 1):
                    rr -= 1
            above = self._is_smooth(rr, cc, plane)
        if (self.avail_l if plane == 0 else self.avail_l_c):
            rr, cc = r, c - 1
            if plane:
                if seq.ssx and (c & 1):
                    cc -= 1
                if seq.ssy and not (r & 1):
                    rr += 1
            left = self._is_smooth(rr, cc, plane)
        return int(above or left)

    def _is_smooth(self, r, c, plane):
        fs = self.fs
        if plane == 0:
            m = fs.y_mode[r, c]
        else:
            m = fs.uv_mode[r, c]
        return m in (9, 10, 11)

    # ------------------------------------------------------ coefficients
    def _coeffs(self, start_x, start_y, plane, t):
        sd, seq, h = self.sd, self.seq, self.h
        c_ = self.c
        x4, y4 = start_x >> 2, start_y >> 2
        tw, th = TX_DIMS[t]
        w4, h4 = tw >> 2, th >> 2
        txsz_ctx = (TX_SQR[t] + TX_SQR_UP[t] + 1) >> 1
        ptype = 1 if plane else 0
        max_x4, max_y4 = h.mi_cols, h.mi_rows
        if plane:
            max_x4 >>= seq.ssx
            max_y4 >>= seq.ssy
        al, ad = self.above_level[plane], self.above_dc[plane]
        ll, ld = self.left_level[plane], self.left_dc[plane]
        bsize = self._residual_size(plane)
        bw, bh = BLOCK_DIMS[bsize]
        if plane == 0:
            top = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    top = max(top, al[x4 + k])
            left = 0
            for k in range(h4):
                if y4 + k < max_y4:
                    left = max(left, ll[y4 + k])
            top, left = min(top, 255), min(left, 255)
            if bw == tw and bh == th:
                ctx = 0
            elif top == 0 and left == 0:
                ctx = 1
            elif top == 0 or left == 0:
                ctx = 2 + (max(top, left) > 3)
            elif max(top, left) <= 3:
                ctx = 4
            elif min(top, left) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = left = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    above |= al[x4 + k] | ad[x4 + k]
            for k in range(h4):
                if y4 + k < max_y4:
                    left |= ll[y4 + k] | ld[y4 + k]
            ctx = 7 + (above != 0) + (left != 0)
            if bw * bh > tw * th:
                ctx += 3
        all_zero = sd.symbol(c_["txb_skip"][txsz_ctx][ctx])
        cul = 0
        dc_cat = 0
        eob = 0
        if all_zero:
            if plane == 0:
                self.fs.tx_type[y4:y4 + h4, x4:x4 + w4] = 0
        else:
            if plane == 0:
                self._transform_type(x4, y4, t)
            tx_type = self._compute_tx_type(plane, t, x4, y4)
            self.plane_tx_type = tx_type
            cls = tx_class_of(tx_type)
            scan, pidx, nb, nbr, off, offr, aw, ah = coef_plan(t, cls)
            ew = min(_log2(tw), 5) + min(_log2(th), 5) - 4
            ectx = 0 if cls == 0 else 1
            cdf = c_["eob_pt_%d" % (16 << ew)][ptype]
            cdf = cdf[ectx] if ew < 5 else cdf[0]
            eob_pt = sd.symbol(cdf) + 1
            eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
            shift = eob_pt - 3
            if shift >= 0:
                if sd.symbol(c_["eob_extra"][txsz_ctx][ptype][eob_pt - 3]):
                    eob += 1 << shift
                for i in range(1, max(0, eob_pt - 2)):
                    shift = max(0, eob_pt - 2) - 1 - i
                    if sd.literal(1):
                        eob += 1 << shift
            W = aw + 4
            levels = [0] * (W * (ah + 4))
            area = aw * ah
            base_cdfs = c_["coeff_base"][txsz_ctx][ptype]
            br_cdfs = c_["coeff_br"][min(txsz_ctx, 3)][ptype]
            beob = c_["coeff_base_eob"][txsz_ctx][ptype]
            symbol = sd.symbol
            n1, n2, n3, n4, n5 = nb
            b1, b2, b3 = nbr
            for ci in range(eob - 1, -1, -1):
                p = pidx[ci]
                if ci == eob - 1:
                    e = 0 if ci == 0 else (1 if ci <= area >> 3 else
                                           (2 if ci <= area >> 2 else 3))
                    level = symbol(beob[e]) + 1
                else:
                    o = off[ci]
                    if o < 0:
                        ctx = 0
                    else:
                        mag = (min(levels[p + n1], 3) + min(levels[p + n2], 3)
                               + min(levels[p + n3], 3) + min(levels[p + n4], 3)
                               + min(levels[p + n5], 3))
                        ctx = min((mag + 1) >> 1, 4) + o
                    level = symbol(base_cdfs[ctx])
                if level > 2:
                    mag = (min(levels[p + b1], 15) + min(levels[p + b2], 15)
                           + min(levels[p + b3], 15))
                    bctx = min((mag + 1) >> 1, 6) + offr[ci]
                    bc = br_cdfs[bctx]
                    for _ in range(4):
                        k = symbol(bc)
                        level += k
                        if k < 3:
                            break
                levels[p] = level
            quant = {}
            for ci in range(eob):
                p = pidx[ci]
                lv = levels[p]
                if not lv:
                    continue
                if ci == 0:
                    dctx = self._dc_sign_ctx(plane, x4, y4, w4, h4, max_x4,
                                             max_y4)
                    sign = symbol(c_["dc_sign"][ptype][dctx])
                else:
                    sign = sd.literal(1)
                if lv > 14:
                    length = 0
                    while True:
                        length += 1
                        if sd.literal(1):
                            break
                        if length == 32:
                            raise AV1Error("AV1 Golomb code too long")
                    x = 1
                    for _ in range(length - 1):
                        x = (x << 1) | sd.literal(1)
                    lv = x + 14
                if scan[ci] == 0:
                    dc_cat = 1 if sign else 2
                lv &= 0xFFFFF
                cul += lv
                quant[scan[ci]] = -lv if sign else lv
            cul = min(63, cul)
            self.quant = quant
            self.quant_w = aw
        for i in range(w4):
            al[x4 + i] = cul
            ad[x4 + i] = dc_cat
        for i in range(h4):
            ll[y4 + i] = cul
            ld[y4 + i] = dc_cat
        return eob

    def _dc_sign_ctx(self, plane, x4, y4, w4, h4, max_x4, max_y4):
        s = 0
        ad, ld = self.above_dc[plane], self.left_dc[plane]
        for k in range(w4):
            if x4 + k < max_x4:
                v = ad[x4 + k]
                s += -1 if v == 1 else (1 if v == 2 else 0)
        for k in range(h4):
            if y4 + k < max_y4:
                v = ld[y4 + k]
                s += -1 if v == 1 else (1 if v == 2 else 0)
        return 1 if s < 0 else (2 if s > 0 else 0)

    def _tx_set(self, t):
        """get_tx_set: 0 DCT only; intra 1 / 2; inter 11 / 12 / 13."""
        if TX_SQR_UP[t] > 3:
            return 0
        if self.is_inter_:
            if self.h.reduced_tx_set or TX_SQR_UP[t] == 3:
                return 13
            if TX_SQR[t] == 2:
                return 12
            return 11
        if TX_SQR_UP[t] == 3:
            return 0
        if self.h.reduced_tx_set:
            return 2
        if TX_SQR[t] == 2:
            return 2
        return 1

    def _transform_type(self, x4, y4, t):
        h = self.h
        s = self._tx_set(t)
        q = qindex(h, self.segment_id, self.current_q, True) if h.seg_enabled else h.base_q_idx
        tt = 0
        if s > 0 and q > 0:
            d = (FILTER_INTRA_DIR[self.filter_mode] if self.use_filter_intra
                 else self.y_mode_)
            if s == 1:
                tt = TX_INV_SET1[self.sd.symbol(self.c["intra_tx_set1"][TX_SQR[t]][d])]
            elif s == 2:
                tt = TX_INV_SET2[self.sd.symbol(self.c["intra_tx_set2"][TX_SQR[t]][d])]
            else:
                inv = INTER_INV[s]
                cdf = self.c["inter_tx_set%d" % (s - 10)][TX_SQR[t]]
                tt = inv[self.sd.symbol(cdf)]
        tw, th = TX_DIMS[t]
        self.fs.tx_type[y4:y4 + (th >> 2), x4:x4 + (tw >> 2)] = tt

    def _compute_tx_type(self, plane, t, x4, y4):
        if self.lossless or TX_SQR_UP[t] > 3:
            return 0
        if plane == 0:
            return int(self.fs.tx_type[y4, x4])
        if self.is_inter_:
            # the luma type under the chroma sample, inside this block
            seq = self.seq
            tt = int(self.fs.tx_type[max(self.mi_row, y4 << seq.ssy),
                                     max(self.mi_col, x4 << seq.ssx)])
            return tt if tt in TX_SETS[self._tx_set(t)] else 0
        tt = MODE_TO_TXFM[self.uv_mode_]
        return tt if tt in TX_SETS[self._tx_set(t)] else 0

    def _reconstruct(self, plane, x, y, t):
        h, seq = self.h, self.seq
        tw, th = TX_DIMS[t]
        pels = tw * th
        dq_denom = 2 if pels > 1024 else (1 if pels > 256 else 0)
        aw, ah = TX_DIMS[ADJUSTED[t]]
        q = qindex(h, self.segment_id, self.current_q, False)
        dc_q, ac_q = DC_Q[(self.bd - 8) >> 1], AC_Q[(self.bd - 8) >> 1]
        if plane == 0:
            dcq = dc_q[max(0, min(255, q + h.dq_y_dc))]
            acq = ac_q[max(0, min(255, q))]
        elif plane == 1:
            dcq = dc_q[max(0, min(255, q + h.dq_u_dc))]
            acq = ac_q[max(0, min(255, q + h.dq_u_ac))]
        else:
            dcq = dc_q[max(0, min(255, q + h.dq_v_dc))]
            acq = ac_q[max(0, min(255, q + h.dq_v_ac))]
        qml = h.seg_qm_level[self.segment_id][plane]
        use_qm = (h.using_qmatrix and not self.lossless and qml < 15
                  and self.plane_tx_type < 9)   # 2D transforms only
        if use_qm:
            self.fs.tools.add("qm")
        if self.lossless:
            self.fs.tools.add("wht")
        coef = np.zeros((ah, aw), np.int64)
        lim = 1 << (7 + self.bd)
        qm = QM_TABLE[qml][1 if plane else 0] if use_qm else None
        qoff = QM_OFFSET[t]
        for pos, v in self.quant.items():
            qq = int(dcq) if pos == 0 else int(acq)
            if qm is not None:
                qq = (qq * int(qm[qoff + pos]) + 16) >> 5
            dq = (abs(v) * qq) & 0xFFFFFF
            dq >>= dq_denom
            if v < 0:
                dq = -dq
            coef[pos // aw, pos % aw] = max(-lim, min(lim - 1, dq))
        res = av1_transform.inverse_2d(coef, _log2(tw), _log2(th),
                                       self.plane_tx_type, self.lossless, self.bd)
        frame = self.fs.planes[plane]
        blk = frame[y:y + th, x:x + tw]
        frame[y:y + th, x:x + tw] = np.clip(blk + res, 0, self.maxv)




def _qm_row_major():
    """The quantizer matrices with each rectangular size in row-major order
    (the tables store them column by column; square ones are symmetric)."""
    q = TABLES["qm"].copy()
    for t, (w, h) in enumerate(TX_DIMS):
        if w <= 32 and h <= 32 and w != h:
            o = QM_OFFSET[t]
            blk = q[:, :, o:o + w * h].reshape(15, 2, w, h)
            q[:, :, o:o + w * h] = blk.transpose(0, 1, 3, 2).reshape(15, 2, -1)
    return q


QM_TABLE = _qm_row_major()
DC_Q = av1_transform.DC_Q
AC_Q = av1_transform.AC_Q


def color_scan(ow, oh):
    """The palette colour map's coding order after its first sample: anti-
    diagonals, each from its top-right sample."""
    for i in range(1, oh + ow - 1):
        for j in range(min(i, ow - 1), max(0, i - oh + 1) - 1, -1):
            yield i - j, j


def color_context(m, rr, cc, n):
    """get_palette_color_context: the context of the map sample at (rr, cc)
    and the colour order its symbol indexes."""
    scores = [0] * 8
    order = list(range(8))
    if cc > 0:
        scores[m[rr][cc - 1]] += 2
    if rr > 0 and cc > 0:
        scores[m[rr - 1][cc - 1]] += 1
    if rr > 0:
        scores[m[rr - 1][cc]] += 2
    for a in range(3):
        mx, mi = scores[a], a
        for b in range(a + 1, n):
            if scores[b] > mx:
                mx, mi = scores[b], b
        if mi != a:
            mo = order[mi]
            for k in range(mi, a, -1):
                scores[k] = scores[k - 1]
                order[k] = order[k - 1]
            scores[a] = mx
            order[a] = mo
    hsh = scores[0] + 2 * scores[1] + 2 * scores[2]
    return PALETTE_COLOR_CONTEXT[hsh], order


def _psum(cdf, syms):
    n = len(cdf) - 1
    total = 0
    for s in syms:
        if s < n:
            hi = 32768 if s == 0 else cdf[s - 1]
            total += hi - cdf[s]
    return total


def _neg_deinterleave(diff, ref, mx):
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


def cdf_names(*trees) -> dict:
    """id of every CDF list in the trees (dicts of nested lists) -> (name,
    index path): the kind of element a read over that CDF is."""
    out = {}

    def walk(node, name, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k if name is None else name + "." + k, path)
        elif node and isinstance(node[0], list):
            for i, v in enumerate(node):
                walk(v, name, path + (i,))
        else:
            out[id(node)] = (name, path)

    for t in trees:
        walk(t, None, ())
    return out


class RecordingDecoder(av1_msac.SymbolDecoder):
    """A symbol decoder that appends each element it reads to ``record``:
    (CDF name, context path, value) or ("bool", icdf0, bit); ``names`` is
    cdf_names over the tile's CDFs, set once the tile decoder exists."""

    def __init__(self, data, pos, size, disable_cdf_update, record: list):
        super().__init__(data, pos, size, disable_cdf_update)
        self.record = record
        self.names = {}

    def symbol(self, cdf: list) -> int:
        v = super().symbol(cdf)
        name, path = self.names.get(id(cdf), ("?", ()))
        self.record.append((name, path, v))
        return v

    def bool_prob(self, icdf0: int) -> int:
        v = super().bool_prob(icdf0)
        self.record.append(("bool", icdf0, v))
        return v
