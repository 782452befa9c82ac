"""The port's own intra rate-distortion search for the AV1 encoder
(assets/av1_encode.py), used where libaom's search is not pinned (PIL's
default save): its decisions are the port's, every layer around them is
libaom's.

For each superblock, when the tile decoder reads its first partition, the
search walks the quad tree (128 x 128 superblocks always split once): a
node whose luma is smooth (mean absolute second difference at most 2) is
first coded whole and kept if that reconstructs it within a mean squared
error of 1/2; otherwise its four quarters are searched first (8 x 8 is
the smallest block), and the node is tried whole only where at least
three quarters stayed whole, keeping the cheaper. A block's cost is
J = SSE * 2048 + R * RDMULT / 512 (libaom's RDCOST, R in 1/512 bits, SSE
over the block's visible samples), RDMULT libaom's key-frame multiplier
at the DC step of qindex 64 (q^2 * (3.3 + 0.0015 q)), every rate from
the tile's live CDFs at the superblock's start (libaom's av1_cost_symbol
and av1_prob_cost): partition, modes, transform type, transform size and
the coefficients (the decoder's own base and range contexts).

Within a block, the 13 luma modes (6 where the luma varies by 2 or less)
are ranked by the Hadamard SATD of their residual plus the mode's rate,
the best directional one then with each angle delta; the two best are
quantized (libaom's quantize_b, as an estimate in the transform domain)
with DCT and, for the best, ADST both ways where the transform set has
it; the winner is coded with rate-distortion quantization (each level the
nearest or the one below, or 0, whichever costs less) and reconstructed
by the decoder's own dequantizer and inverse transform. An 8 x 8 block
also tries four 4 x 4 DCTs where its error is above 1 a sample (the frame
header selects the transform size per block). A block whose luma has two
to eight values may take them as its palette where the frame has screen
content tools. Chroma picks among DC, V, H, smooth, the luma's mode and
CfL (each plane's alpha from -16 to 16 by the SSE of its prediction; DC
and CfL alone where the chroma varies by 2 or less) the same way. Filter
intra and intra block copy are not used.

Every decision is integer arithmetic (numpy int64), so the bytes are the
same on any host. Trials write into the frame state and the tile
decoder's flags, which are restored to the winner's (the decoded flags
to the superblock's start) before the decoder codes the node; every
trial's prediction is the decoder's own (``TileDecoder.predict_tx``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import av1_block, av1_fwd_transform, av1_quantize
from .av1_block import (BLOCK_DIMS, BLOCK_64X64, BLOCK_8X8,
                        INTRA_MODE_CONTEXT, MAX_TX_RECT, PART_NONE, PART_SPLIT,
                        TX_DIMS, TX_INV_SET1, TX_INV_SET2, TX_SETS, TX_SQR,
                        TX_SQR_UP, UV_CFL)
from .av1_encode import Plan
from .av1_transform import DC_Q

# av1_prob_cost: -log2((128 + i) / 256) in 1/512 bits
PROB_COST = (
    512, 506, 501, 495, 489, 484, 478, 473, 467, 462, 456, 451, 446, 441, 435,
    430, 425, 420, 415, 410, 405, 400, 395, 390, 385, 380, 375, 371, 366, 361,
    356, 352, 347, 343, 338, 333, 329, 324, 320, 316, 311, 307, 302, 298, 294,
    289, 285, 281, 277, 273, 268, 264, 260, 256, 252, 248, 244, 240, 236, 232,
    228, 224, 220, 216, 212, 209, 205, 201, 197, 194, 190, 186, 182, 179, 175,
    171, 168, 164, 161, 157, 153, 150, 146, 143, 139, 136, 132, 129, 125, 122,
    119, 115, 112, 109, 105, 102, 99, 95, 92, 89, 86, 82, 79, 76, 73, 70, 66,
    63, 60, 57, 54, 51, 48, 45, 42, 38, 35, 32, 29, 26, 23, 20, 18, 15, 12, 9,
    6, 3)
BIT = 512
LUMA_MODES = tuple(range(13))
QUIET_MODES = (0, 1, 2, 9, 10, 11)     # where the luma varies by 2 or less
DIRECTIONAL = tuple(range(1, 9))
CHROMA_MODES = (0, 1, 2, 9)
H8 = np.array([[1 if bin(i & j).count("1") % 2 == 0 else -1 for j in range(8)]
               for i in range(8)], np.int64)
H4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]],
              np.int64)


def rdmult(qindex: int) -> int:
    """libaom's key-frame RDMULT: q^2 (3.3 + 0.0015 q) at the DC step q,
    in integers (q^2 (33000 + 15 q) / 10000)."""
    q = int(DC_Q[0, qindex])
    return q * q * (33000 + 15 * q) // 10000


def cost_symbol(p15: int) -> int:
    """av1_cost_symbol: the cost of a symbol of probability p15 / 32768."""
    p15 = max(1, min(32767, p15))
    shift = 14 - (p15.bit_length() - 1)
    prob = max(1, min(255, ((p15 << shift) * 256 + 16384) >> 15))
    return PROB_COST[prob - 128] + shift * BIT


def cdf_costs(cdf: list) -> list:
    """The cost of each symbol of an inverted CDF list."""
    n = len(cdf) - 1
    return [cost_symbol((32768 if s == 0 else cdf[s - 1]) - cdf[s])
            for s in range(n)]


def satd(res: np.ndarray) -> int:
    h, w = res.shape
    if h >= 8 and w >= 8:
        t = res.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
        return int(np.abs(H8 @ t @ H8).sum())
    t = res.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)
    return int(np.abs(H4 @ t @ H4).sum()) * 2


class Search(Plan):
    """The decision source at PIL's defaults."""

    def __init__(self, src):
        super().__init__(src)
        self.rdmult = rdmult(self.q)
        self.parts = {}
        self.blocks = {}
        self.memo = {}

    # ------------------------------------------------------ plan hooks
    def choose_partition(self, td, r, c, bsize):
        key = (r, c, bsize)
        if key not in self.parts:
            self.td = td
            self.costs = {}
            self.memo = {}
            self.c = td.c
            decoded = [d.copy() for d in td.decoded]
            self._node(td, r, c, bsize)
            for d, s in zip(td.decoded, decoded):
                d[...] = s      # the decoder marks the blocks as it codes them
        return self.parts[key]

    def choose_block(self, td):
        b = self.blocks[(td.mi_row, td.mi_col, td.mi_size)]
        return SimpleNamespace(**{k: (list(v) if isinstance(v, list) else v)
                                  for k, v in vars(b).items()})

    # ------------------------------------------------------------ rates
    def _cost(self, name, cdf):
        k = id(cdf)
        v = self.costs.get(k)
        if v is None:
            v = self.costs[k] = cdf_costs(cdf)
        return v

    def _coef_tables(self, txsz_ctx, ptype):
        key = ("coef", txsz_ctx, ptype)
        v = self.costs.get(key)
        if v is None:
            c = self.c
            base = np.array([cdf_costs(x) for x in c["coeff_base"][txsz_ctx][ptype]],
                            np.int64)
            beob = np.array([cdf_costs(x) for x in c["coeff_base_eob"][txsz_ctx][ptype]],
                            np.int64)
            br = [cdf_costs(x) for x in c["coeff_br"][min(txsz_ctx, 3)][ptype]]
            brc = np.zeros((len(br), 13), np.int64)
            for ctx, cs in enumerate(br):
                for rest in range(13):
                    tot, rem = 0, rest
                    for _ in range(4):
                        k = min(rem, 3)
                        tot += cs[k]
                        rem -= k
                        if k < 3:
                            break
                    brc[ctx, rest] = tot
            skip = [cdf_costs(x) for x in c["txb_skip"][txsz_ctx]]
            extra = [cdf_costs(x) for x in c["eob_extra"][txsz_ctx][ptype]]
            v = self.costs[key] = (base, beob, brc, skip, extra)
        return v

    def coef_rate(self, lv: np.ndarray, t: int, tt: int, plane: int) -> int:
        """The rate of a transform block's levels (0 levels: its txb_skip)."""
        ptype = 1 if plane else 0
        txsz_ctx = (TX_SQR[t] + TX_SQR_UP[t] + 1) >> 1
        base, beob, brc, skip, extra = self._coef_tables(txsz_ctx, ptype)
        sctx = 1 if plane == 0 else 7
        if not lv.any():
            return skip[sctx][1]
        cls = av1_block.tx_class_of(tt)
        scan, pidx, nb, nbr, off, offr, aw, ah = av1_block.coef_plan(t, cls)
        W = aw + 4
        pad = np.zeros((ah + 4, W), np.int64)
        pad[:ah, :aw] = np.abs(lv)
        flat = pad.reshape(-1)
        pid = np.asarray(pidx)
        q = flat[pid]
        nz = np.flatnonzero(q)
        eob = int(nz[-1]) + 1
        rate = skip[sctx][0]
        tw, th = TX_DIMS[t]
        ew = min(tw.bit_length() - 1, 5) + min(th.bit_length() - 1, 5) - 4
        cdf = self.c["eob_pt_%d" % (16 << ew)][ptype]
        cdf = cdf[0 if cls == 0 else 1] if ew < 5 else cdf[0]
        pt = 1 if eob == 1 else (eob - 1).bit_length() + 1
        rate += self._cost("eob_pt", cdf)[pt - 1]
        if pt >= 3:
            off_e = eob - (1 << (pt - 2)) - 1
            rate += extra[pt - 3][(off_e >> (pt - 3)) & 1] + (pt - 3) * BIT
        p = pid[:eob]
        qq = q[:eob]
        mag = sum(np.minimum(flat[p + n], 3) for n in nb)
        o = np.asarray(off[:eob])
        ctx = np.where(o < 0, 0, np.minimum((mag + 1) >> 1, 4) + o)
        sym = np.minimum(qq, 3)
        area = aw * ah
        last = eob - 1
        e = 0 if last == 0 else (1 if last <= area >> 3 else (2 if last <= area >> 2 else 3))
        rate += int(base[ctx[:last], sym[:last]].sum()) + int(beob[e, sym[last] - 1])
        big = qq > 2
        if big.any():
            pb = p[big]
            magb = sum(np.minimum(flat[pb + n], 15) for n in nbr)
            bctx = np.minimum((magb + 1) >> 1, 6) + np.asarray(offr[:eob])[big]
            rest = qq[big] - 3
            rate += int(brc[bctx, np.minimum(rest, 12)].sum())
            g = rest[rest >= 12] - 11
            for x in g.tolist():
                rate += (2 * x.bit_length() - 1) * BIT
        rate += (int(np.count_nonzero(qq)) - (1 if qq[0] else 0)) * BIT
        if qq[0]:
            rate += BIT
        return rate

    def levels(self, res, tt, t, plane, x, y):
        """Rate-distortion quantization: each coefficient's level is the
        nearest one or the one below it (or 0), whichever costs less in
        squared error plus RDMULT times its rate (base and range symbols in
        the contexts of the nearest levels, its sign). The last result at
        each place is kept: the writing pass meets the winner's residual
        again and takes its levels from there."""
        key = (plane, x, y, t, tt)
        hit = self.memo.get(key)
        if hit is not None and np.array_equal(hit[0], res):
            return hit[1].copy()
        lv = self._rdoq(res, tt, t, plane)
        self.memo[key] = (res.copy(), lv)
        return lv.copy()

    def _rdoq(self, res, tt, t, plane):
        tw, th = TX_DIMS[t]
        co = av1_fwd_transform.forward_2d(res, tt)
        ls = av1_quantize.log_scale(tw, th)
        step = np.full(co.shape, int(av1_quantize.AC_Q[0, self.q]), np.int64)
        step[0, 0] = int(DC_Q[0, self.q])
        a = np.abs(co)
        up = ((a << ls) + (step >> 1)) // step
        if not up.any():
            return up
        ptype = 1 if plane else 0
        txsz_ctx = (TX_SQR[t] + TX_SQR_UP[t] + 1) >> 1
        base, _, brc, _, _ = self._coef_tables(txsz_ctx, ptype)
        cls = av1_block.tx_class_of(tt)
        scan, pidx, nb, nbr, off, offr, aw, ah = av1_block.coef_plan(t, cls)
        W = aw + 4
        pad = np.zeros((ah + 4, W), np.int64)
        pad[:ah, :aw] = up
        flat = pad.reshape(-1)
        pid = np.asarray(pidx)
        mag = sum(np.minimum(flat[pid + n], 3) for n in nb)
        o = np.asarray(off)
        ctx = np.where(o < 0, 0, np.minimum((mag + 1) >> 1, 4) + o)
        magb = sum(np.minimum(flat[pid + n], 15) for n in nbr)
        bctx = np.minimum((magb + 1) >> 1, 6) + np.asarray(offr)
        lv_scan = up.reshape(-1)[np.asarray(scan)]
        a_scan = a.reshape(-1)[np.asarray(scan)]
        st_scan = step.reshape(-1)[np.asarray(scan)]
        shift = 6 - 2 * ls
        best_j = best_l = None
        for cand in (lv_scan, np.maximum(lv_scan - 1, 0), lv_scan * 0):
            e = a_scan - ((cand * st_scan) >> ls)
            rate = base[ctx, np.minimum(cand, 3)] + np.where(cand > 0, BIT, 0)
            rate = rate + np.where(cand > 2, brc[bctx, np.minimum(cand - 3, 12)], 0)
            j = (((e * e) >> shift) << 11) + ((rate * self.rdmult) >> 9)
            if best_j is None:
                best_j, best_l = j, cand
            else:
                better = j < best_j
                best_j = np.where(better, j, best_j)
                best_l = np.where(better, cand, best_l)
        out = np.zeros(up.size, np.int64)
        out[np.asarray(scan)] = best_l
        out = out.reshape(up.shape)
        return np.where(co < 0, -out, out)

    def _rd(self, rate: int, sse: int) -> int:
        return ((rate * self.rdmult + 256) >> 9) + (sse << 11)

    # -------------------------------------------------------- snapshots
    def _snapshot(self, td, r, c, bsize):
        fs, seq = td.fs, td.seq
        n4 = BLOCK_DIMS[bsize][0] >> 2
        regs = []
        for p in range(seq.num_planes):
            sx = seq.ssx if p else 0
            sy = seq.ssy if p else 0
            y0, x0 = (r * 4) >> sy, (c * 4) >> sx
            hh, ww = (n4 * 4) >> sy, (n4 * 4) >> sx
            regs.append(fs.planes[p][y0:y0 + max(hh, 4), x0:x0 + max(ww, 4)].copy())
        return (regs, [d.copy() for d in td.decoded],
                fs.y_mode[r:r + n4, c:c + n4].copy(),
                fs.uv_mode[r:r + n4, c:c + n4].copy(),
                fs.mi_size[r:r + n4, c:c + n4].copy())

    def _restore(self, td, r, c, bsize, snap):
        fs, seq = td.fs, td.seq
        regs, dec, ym, um, ms = snap
        n4 = BLOCK_DIMS[bsize][0] >> 2
        for p in range(seq.num_planes):
            sx = seq.ssx if p else 0
            sy = seq.ssy if p else 0
            y0, x0 = (r * 4) >> sy, (c * 4) >> sx
            a = regs[p]
            fs.planes[p][y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = a
        for d, s in zip(td.decoded, dec):
            d[...] = s
        fs.y_mode[r:r + n4, c:c + n4] = ym
        fs.uv_mode[r:r + n4, c:c + n4] = um
        fs.mi_size[r:r + n4, c:c + n4] = ms

    # ---------------------------------------------------------- the tree
    def _part_rate(self, td, r, c, bsize, part):
        fs = td.fs
        bw = BLOCK_DIMS[bsize][0]
        bsl = (bw >> 2).bit_length() - 1
        above = td._inside(r - 1, c) and (
            (BLOCK_DIMS[fs.mi_size[r - 1, c]][0] >> 2).bit_length() - 1 < bsl)
        left = td._inside(r, c - 1) and (
            (BLOCK_DIMS[fs.mi_size[r, c - 1]][1] >> 2).bit_length() - 1 < bsl)
        cdf = self.c["partition%d" % bw][left * 2 + above]
        return self._cost("partition", cdf)[part]

    def _node(self, td, r, c, bsize) -> int:
        """The cost of the node's best coding, which it leaves in the frame:
        a smooth node whole first (kept if close enough), then its four
        quarters, then the node whole where at least three quarters stayed
        whole; the cheaper of whole and split."""
        h = td.h
        if r >= h.mi_rows or c >= h.mi_cols:
            return 0
        half = BLOCK_DIMS[bsize][0] >> 3
        full = r + half < h.mi_rows and c + half < h.mi_cols
        key = (r, c, bsize)
        can_none = full and BLOCK_8X8 <= bsize <= BLOCK_64X64
        if bsize == BLOCK_8X8:
            self.parts[key] = PART_NONE
            return self._block(td, r, c, bsize) + self._rd(
                self._part_rate(td, r, c, bsize, PART_NONE), 0)
        sub = bsize - 3
        snap0 = self._snapshot(td, r, c, bsize) if can_none else None
        j_none = None
        if can_none and self._smooth(r, c, bsize):
            j_none = self._block(td, r, c, bsize) + self._rd(
                self._part_rate(td, r, c, bsize, PART_NONE), 0)
            n = BLOCK_DIMS[bsize][0]
            if 2 * self.last_sse <= n * n:
                self.parts[key] = PART_NONE
                return j_none
            snap_none = self._snapshot(td, r, c, bsize)
            self._restore(td, r, c, bsize, snap0)
        j_split = self._rd(self._part_rate(td, r, c, bsize, PART_SPLIT), 0) if full else 0
        whole = 0
        for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
            j_split += self._node(td, r + dr, c + dc, sub)
            whole += self.parts.get((r + dr, c + dc, sub), PART_NONE) == PART_NONE
        self.parts[key] = PART_SPLIT
        if j_none is not None:
            if j_none < j_split:
                self._restore(td, r, c, bsize, snap_none)
                self.parts[key] = PART_NONE
                return j_none
            return j_split
        if not can_none or whole < 3:
            return j_split
        snap_split = self._snapshot(td, r, c, bsize)
        self._restore(td, r, c, bsize, snap0)
        j_none = self._block(td, r, c, bsize) + self._rd(
            self._part_rate(td, r, c, bsize, PART_NONE), 0)
        if j_none < j_split:
            self.parts[key] = PART_NONE
            return j_none
        self._restore(td, r, c, bsize, snap_split)
        return j_split

    def _smooth(self, r, c, bsize):
        """A node worth trying whole before its quarters: its luma's mean
        absolute second difference across and down is at most 2."""
        n = BLOCK_DIMS[bsize][0]
        b = self.src[0][r * 4:r * 4 + n, c * 4:c * 4 + n]
        lap = (np.abs(b[:, 2:] - 2 * b[:, 1:-1] + b[:, :-2]).sum()
               + np.abs(b[2:] - 2 * b[1:-1] + b[:-2]).sum())
        return int(lap) <= 4 * n * (n - 2)

    # ------------------------------------------------------------ blocks
    def _visible(self, td, plane, x, y, w, h):
        seq, hd = td.seq, td.h
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        vw = ((hd.width + sx) >> sx) - x
        vh = ((hd.height + sy) >> sy) - y
        return max(0, min(w, vw)), max(0, min(h, vh))

    def _code(self, td, plane, x, y, t, tt, pred):
        """Quantize the block's residual, reconstruct it in the frame as the
        decoder does: (levels, sse, coefficient rate)."""
        tw, th = TX_DIMS[t]
        src = self.src[plane][y:y + th, x:x + tw]
        lv = self.levels(src - pred, tt, t, plane, x, y)
        frame = td.fs.planes[plane]
        frame[y:y + th, x:x + tw] = pred
        if lv.any():
            aw = lv.shape[1]
            nz = np.flatnonzero(lv)
            td.quant = {int(p): int(lv.flat[p]) for p in nz}
            td.quant_w = aw
            td.plane_tx_type = tt
            td._reconstruct(plane, x, y, t)
        vw, vh = self._visible(td, plane, x, y, tw, th)
        d = frame[y:y + vh, x:x + vw] - src[:vh, :vw]
        sse = int((d * d).sum())
        return lv, sse, self.coef_rate(lv, t, tt, plane)

    def _estimate(self, plane, x, y, t, tt, pred):
        """(levels, SSE estimated in the transform domain, coefficient
        rate) of a residual: the squared quantization error of the
        coefficients over the transform's energy gain (64 up to 16 x 16,
        16 at 32 x 32)."""
        tw, th = TX_DIMS[t]
        res = self.src[plane][y:y + th, x:x + tw] - pred
        co = av1_fwd_transform.forward_2d(res, tt)
        ls = av1_quantize.log_scale(tw, th)
        lv = av1_quantize.quantize_b(co, self.q, ls)
        step = np.full(lv.shape, int(av1_quantize.AC_Q[0, self.q]), np.int64)
        step[0, 0] = int(DC_Q[0, self.q])
        dq = (np.abs(lv) * step) >> ls
        e = np.abs(co) - dq
        return lv, int((e * e).sum()) >> (6 - 2 * ls), self.coef_rate(lv, t, tt, plane)

    def _mark(self, td, plane, x, y, t):
        tw, th = TX_DIMS[t]
        sub_r, sub_c = td._sub(plane, x, y)
        td.decoded[plane][sub_r + 1:sub_r + 1 + (th >> 2),
                          sub_c + 1:sub_c + 1 + (tw >> 2)] = 1

    def _block(self, td, r, c, bsize) -> int:
        fs, seq = td.fs, td.seq
        td.block_setup(r, c, bsize)
        td.is_inter_ = td.pal_y = td.pal_uv = 0
        td.use_filter_intra = 0
        td.skip = 0
        td.segment_id = 0
        td.lossless = False
        td.current_q = self.q
        n4 = BLOCK_DIMS[bsize][0] >> 2
        t = MAX_TX_RECT[bsize]
        x, y = c * 4, r * 4
        tw, th = TX_DIMS[t]
        src = self.src[0][y:y + th, x:x + tw]
        am = fs.y_mode[r - 1, c] if td.avail_u else 0
        lm = fs.y_mode[r, c - 1] if td.avail_l else 0
        ycost = self._cost("y", self.c["kf_y_mode"][INTRA_MODE_CONTEXT[am]]
                           [INTRA_MODE_CONTEXT[lm]])
        use_angle = bsize >= BLOCK_8X8

        # a DC block up to 32 x 32 codes its filter intra flag (0)
        fi_off = 0
        if seq.enable_filter_intra and max(BLOCK_DIMS[bsize]) <= 32:
            fi_off = self._cost("fi", self.c["filter_intra"][bsize])[0]

        def pred_luma(mode, delta):
            td.y_mode_, td.angle_y = mode, delta
            td.predict_tx(0, x, y, t, 0, 0)
            return fs.planes[0][y:y + th, x:x + tw].copy()

        def mode_rate(mode, delta):
            rate = ycost[mode]
            if use_angle and 1 <= mode <= 8:
                rate += self._cost("a", self.c["angle_delta"][mode - 1])[delta + 3]
            if mode == 0:
                rate += fi_off
            return rate

        lam = self.rdmult
        ranked = []
        npx = tw * th
        quiet = npx * int((src * src).sum()) - int(src.sum()) ** 2 <= 4 * npx * npx
        for mode in (QUIET_MODES if quiet else LUMA_MODES):
            p = pred_luma(mode, 0)
            ranked.append(((satd(src - p) << 11) + ((mode_rate(mode, 0) * lam) >> 9),
                           mode, 0, p))
        ranked.sort(key=lambda e: e[:3])
        if use_angle and not quiet:
            dirs = [e for e in ranked if e[1] in DIRECTIONAL][:1]
            for e in dirs:
                mode = e[1]
                for delta in (-3, -2, -1, 1, 2, 3):
                    p = pred_luma(mode, delta)
                    ranked.append(((satd(src - p) << 11)
                                   + ((mode_rate(mode, delta) * lam) >> 9),
                                   mode, delta, p))
            ranked.sort(key=lambda e: e[:3])
        tset = td._tx_set(t)
        types = [tt for tt in ((0,) if quiet else (0, 3)) if tt in TX_SETS[tset]]
        best = None
        for k, (_, mode, delta, p) in enumerate(ranked[:2]):
            for tt in (types if k == 0 else types[:1]):
                if tw == 64 or th == 64:
                    lv, sse, crate = self._code(td, 0, x, y, t, tt, p)
                else:
                    lv, sse, crate = self._estimate(0, x, y, t, tt, p)
                rate = mode_rate(mode, delta) + crate
                if lv.any() and tset > 0:
                    rate += self._tx_type_rate(t, tset, mode, tt)
                j = self._rd(rate, sse)
                if best is None or j < best[0]:
                    best = (j, mode, delta, tt, p, lv.any(), rate)
        _, mode, delta, tt, p, nonzero, rate = best
        pal = self._palette(td, r, c, bsize, x, y, tw, th)
        if pal is not None and pal[0] < best[0]:
            _, rate, pal = pal
            mode, delta, tt, p = 0, 0, 0, pal.pred
        else:
            pal = None
        td.y_mode_, td.angle_y = mode, delta
        dcost = self._cost("d", self.c["tx8"][0]) if (
            bsize == BLOCK_8X8 and td.h.tx_mode_select) else (0, 0)
        rate += dcost[0]
        lv, sse_y, _ = self._code(td, 0, x, y, t, tt, p)
        j_total = self._rd(rate, sse_y)
        nonzero = lv.any() and pal is None
        depth = 0
        if pal is None and bsize == BLOCK_8X8 and td.h.tx_mode_select \
                and sse_y > 64:
            snap = (fs.planes[0][y:y + 8, x:x + 8].copy(),
                    td.decoded[0].copy())
            j4, rate4, nz4, tt4, sse4 = self._split_tx(td, x, y, mode, delta,
                                                       mode_rate)
            j4 += self._rd(dcost[1], 0)
            if j4 < j_total:
                j_total, rate, nonzero, tt, sse_y = j4, rate4 + dcost[1], nz4, tt4, sse4
                depth = 1
            else:
                fs.planes[0][y:y + 8, x:x + 8] = snap[0]
                td.decoded[0][...] = snap[1]
        td.max_luma_w, td.max_luma_h = x + tw, y + th
        if not depth:
            self._mark(td, 0, x, y, t)
        rr, cc = min(r + n4, td.h.mi_rows), min(c + n4, td.h.mi_cols)
        fs.y_mode[r:rr, c:cc] = mode
        fs.mi_size[r:rr, c:cc] = bsize
        blk = SimpleNamespace(y_mode=mode, uv_mode=0, angles=[], cfl_sign=0,
                              cfl_alphas=[], filter_mode=None, tx_depth=depth,
                              tx_type=tt, palette=pal)
        if use_angle and 1 <= mode <= 8:
            blk.angles.append(delta)
        zero = not nonzero
        if td.has_chroma:
            jc, zc = self._chroma(td, r, c, bsize, blk)
            j_total += jc
            zero = zero and zc
        fs.uv_mode[r:rr, c:cc] = blk.uv_mode
        self.blocks[(r, c, bsize)] = blk
        self.last_zero = zero
        self.last_sse = sse_y
        return j_total

    def _cfl_ac(self, td, x, y, w, h):
        """The luma term of CfL (av1_intra.cfl's v - avg) for the block."""
        seq = td.seq
        subx, suby = seq.ssx, seq.ssy
        luma = td.fs.planes[0]
        cy = np.minimum(np.arange(y, y + h), (td.max_luma_h >> suby) - 1) << suby
        cx = np.minimum(np.arange(x, x + w), (td.max_luma_w >> subx) - 1) << subx
        t = np.zeros((h, w), np.int64)
        for dy in range(suby + 1):
            for dx in range(subx + 1):
                t += luma[(cy + dy)[:, None], (cx + dx)[None, :]]
        v = t << (3 - subx - suby)
        shift = (w * h).bit_length() - 1
        return v - ((int(v.sum()) + (1 << (shift - 1))) >> shift)

    def _split_tx(self, td, x, y, mode, delta, mode_rate):
        """An 8 x 8 block's luma as four 4 x 4 DCTs, each predicted from the
        ones before it: (J, rate, nonzero, type, SSE), its reconstruction
        and decoded flags left in place."""
        fs = td.fs
        best = None
        snap = (fs.planes[0][y:y + 8, x:x + 8].copy(), td.decoded[0].copy())
        for tt in (0,):
            fs.planes[0][y:y + 8, x:x + 8] = snap[0]
            td.decoded[0][...] = snap[1]
            rate, sse, nz = mode_rate(mode, delta), 0, False
            for i in range(4):
                px, py = x + 4 * (i & 1), y + 4 * (i >> 1)
                td.predict_tx(0, px, py, 0, i & 1, i >> 1)
                pred = fs.planes[0][py:py + 4, px:px + 4].copy()
                lv, e, crate = self._code(td, 0, px, py, 0, tt, pred)
                rate += crate
                if lv.any():
                    nz = True
                    rate += self._tx_type_rate(0, 1, mode, tt)
                sse += e
                self._mark(td, 0, px, py, 0)
            j = self._rd(rate, sse)
            if best is None or j < best[0]:
                best = (j, rate, nz, tt, sse, fs.planes[0][y:y + 8, x:x + 8].copy(),
                        td.decoded[0].copy())
        fs.planes[0][y:y + 8, x:x + 8] = best[5]
        td.decoded[0][...] = best[6]
        return best[:5]

    def _palette(self, td, r, c, bsize, x, y, tw, th):
        """A luma palette of the block's own values where it has two to
        eight (screen content tools on, 8 x 8 to 64 x 64): (J, rate,
        palette) with the exact prediction, or None."""
        h = td.h
        bw, bh = BLOCK_DIMS[bsize]
        if not h.allow_screen_content_tools or bw > 64 or bh > 64:
            return None
        ow = min(bw, (h.mi_cols - c) * 4)
        oh = min(bh, (h.mi_rows - r) * 4)
        src = self.src[0][y:y + oh, x:x + ow]
        colors = np.unique(src)
        n = len(colors)
        if not 2 <= n <= 8:
            return None
        m = np.zeros((bh, bw), np.int64)
        m[:oh, :ow] = np.searchsorted(colors, src)
        m[:oh, ow:] = m[:oh, ow - 1:ow]
        m[oh:] = m[oh - 1:oh]
        fs = td.fs
        bctx = (bw >> 2).bit_length() + (bh >> 2).bit_length() - 4
        ctx = int(td.avail_u and fs.pal_size[0, r - 1, c] > 0) + int(
            td.avail_l and fs.pal_size[0, r, c - 1] > 0)
        rate = self._cost("pm", self.c["palette_y_mode"][bctx][ctx])[1]
        rate += self._cost("ps", self.c["palette_y_size"][bctx])[n - 2]
        rate += (10 + 6 * (n - 2)) * BIT
        cdfs = self.c["palette_y_color%d" % n]
        costs = [self._cost("pc", cd) for cd in cdfs]
        ml = m.tolist()
        for rr, cc in av1_block.color_scan(ow, oh):
            k, order = av1_block.color_context(ml, rr, cc, n)
            rate += costs[k][order.index(ml[rr][cc])]
        rate += self.coef_rate(np.zeros((1, 1), np.int64), MAX_TX_RECT[bsize], 0, 0)
        rate += self._cost("y", self.c["kf_y_mode"][0][0])[0]
        pred = colors.astype(np.int64)[m][:th, :tw]
        pal = SimpleNamespace(colors=[int(v) for v in colors], map=m, pred=pred)
        return self._rd(rate, 0), rate, pal

    def _tx_type_rate(self, t, tset, mode, tt):
        if tset == 1:
            cdf = self.c["intra_tx_set1"][TX_SQR[t]][mode]
            return self._cost("t1", cdf)[TX_INV_SET1.index(tt)]
        cdf = self.c["intra_tx_set2"][TX_SQR[t]][mode]
        return self._cost("t2", cdf)[TX_INV_SET2.index(tt)]

    def _chroma(self, td, r, c, bsize, blk):
        fs, seq = td.fs, td.seq
        t = td._plane_tx(1)
        tw, th = TX_DIMS[t]
        x, y = (c >> seq.ssx) * 4, (r >> seq.ssy) * 4
        bw, bh = BLOCK_DIMS[bsize]
        cfl_ok = max(bw, bh) <= 32
        ucdf = self.c["uv_mode_cfl" if cfl_ok else "uv_mode_nocfl"][blk.y_mode]
        ucost = self._cost("uv", ucdf)
        use_angle = bsize >= BLOCK_8X8
        lam = self.rdmult
        srcs = [self.src[p][y:y + th, x:x + tw] for p in (1, 2)]
        npx = tw * th
        quiet = all(npx * int((s_ * s_).sum()) - int(s_.sum()) ** 2
                    <= 4 * npx * npx for s_ in srcs)
        modes = [0] if quiet else list(CHROMA_MODES)
        if blk.y_mode in DIRECTIONAL and not quiet:
            modes.append(blk.y_mode)
        ranked = []
        td.alpha_u = td.alpha_v = 0
        for mode in modes:
            td.uv_mode_ = mode
            td.angle_uv = blk.angles[0] if (mode == blk.y_mode and blk.angles) else 0
            preds = []
            cost = 0
            for p in (1, 2):
                td.predict_tx(p, x, y, t, 0, 0)
                pr = fs.planes[p][y:y + th, x:x + tw].copy()
                preds.append(pr)
                cost += satd(srcs[p - 1] - pr)
            rate = ucost[mode]
            if use_angle and 1 <= mode <= 8:
                rate += self._cost("a", self.c["angle_delta"][mode - 1])[td.angle_uv + 3]
            ranked.append(((cost << 11) + ((rate * lam) >> 9), mode, td.angle_uv,
                           preds, None))
        if cfl_ok:
            td.uv_mode_ = UV_CFL
            alphas = []
            preds = []
            ac = self._cfl_ac(td, x, y, tw, th)
            al = np.arange(-16, 17, dtype=np.int64)[:, None, None]
            dd = al * ac[None]
            scaled = np.where(dd < 0, -((-dd + 32) >> 6), (dd + 32) >> 6)
            for p in (1, 2):
                td.alpha_u = td.alpha_v = 0
                td.predict_tx(p, x, y, t, 0, 0)
                dc = fs.planes[p][y:y + th, x:x + tw]
                cand = np.clip(dc[None] + scaled, 0, td.maxv)
                err = ((cand - srcs[p - 1][None]) ** 2).sum(axis=(1, 2))
                k = int(np.argmin(err))
                alphas.append(k - 16)
                preds.append(cand[k])
            au, av = alphas
            if au or av:
                su = 0 if au == 0 else (1 if au < 0 else 2)
                sv = 0 if av == 0 else (1 if av < 0 else 2)
                signs = su * 3 + sv - 1
                rate = ucost[UV_CFL] + self._cost("cs", self.c["cfl_sign"])[signs]
                mags = []
                if su:
                    mags.append(abs(au) - 1)
                    rate += self._cost("ca", self.c["cfl_alpha"][(su - 1) * 3 + sv])[abs(au) - 1]
                if sv:
                    mags.append(abs(av) - 1)
                    rate += self._cost("ca", self.c["cfl_alpha"][(sv - 1) * 3 + su])[abs(av) - 1]
                cost = sum(satd(srcs[k] - preds[k]) for k in range(2))
                ranked.append(((cost << 11) + ((rate * lam) >> 9), UV_CFL, 0,
                               preds, (signs, mags, au, av)))
        ranked.sort(key=lambda e: (e[0], e[1]))
        _, mode, delta, preds, cfl = ranked[0]
        td.uv_mode_, td.angle_uv = mode, delta
        if cfl:
            td.alpha_u, td.alpha_v = cfl[2], cfl[3]
        tt = td._compute_tx_type(1, t, x >> 2, y >> 2)
        j = 0
        zero = True
        for p in (1, 2):
            lv, sse, crate = self._code(td, p, x, y, t, tt, preds[p - 1])
            j += self._rd(crate, sse)
            zero = zero and not lv.any()
            self._mark(td, p, x, y, t)
        rate = ucost[mode]
        if use_angle and 1 <= mode <= 8:
            rate += self._cost("a", self.c["angle_delta"][mode - 1])[delta + 3]
            blk.angles.append(delta)
        blk.uv_mode = mode
        if cfl:
            blk.cfl_sign, blk.cfl_alphas = cfl[0], list(cfl[1])
        return j + self._rd(rate, 0), zero
