"""JPEG 2000 tier 2 (T.800 Annex B), as OpenJPEG 2.5.4's tcd.c, pi.c,
t2.c, tgt.c and bio.c decode it.

``tile_geometry`` partitions a tile as opj_tcd_init_tile does: each
component's tile-component (the tile's corners divided by XRsiz / YRsiz,
rounded up), its resolutions, their sub-bands (LL; HL, LH, HH as bandno 1-3),
the precinct grid anchored at multiples of the precinct size on the
resolution's grid, and code-blocks clipped by precinct and band edges. A
band's step size (E-3, Rb without the sub-band gain on the 9/7 path, which
OpenJPEG folds into its inverse transform) and Mb = exponent + guard bits - 1
are set there too.

``packet_order`` walks the five progressions (LRCP, RLCP, RPCL, PCRL,
CPRL) with the POC entries' bounds, each packet once (pi.c's include
array), and ``read_packets`` reads each packet: SOP (a warning when
missing), the header bits with 0xFF bit stuffing (opj_bio), tag trees for
inclusion and zero bit-planes, the pass count code, Lblock, one length per
codeword segment (TERMALL ends a segment after every pass, BYPASS after
the first ten and then after every raw or MQ run; an HT code-block's
first segment takes one pass, the cleanup, and the next all the passes
the packet has left, as t2.c reads them), EPH (an error when missing),
and the data, which become each code-block's chunks. Headers come from PPM / PPT when the
codestream moved them there. Bits past the end of the header data read as
0, so a stream that stops early gives empty packets; a code-block segment
longer than the data left raises J2kError (strict mode)."""

from __future__ import annotations

import numpy as np

from .j2k_codestream import LAZY, TERMALL, HT, J2kError


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceilpow2(a: int, e: int) -> int:
    return -(-a >> e)


class Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs",
                 "chunks", "chunk_at", "newpasses")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.numlenbits = 0
        self.segs = []  # [maxpasses, numpasses, len, newlen, newpasses]
        self.chunks = []
        self.chunk_at = []  # each chunk's offset in the tile's data
        self.newpasses = 0


class TagTree:
    """tgt.c: leaves in raster order, then each coarser level."""

    def __init__(self, w: int, h: int):
        parent = []
        levels = [(w, h)]
        while levels[-1][0] * levels[-1][1] > 1:
            lw, lh = levels[-1]
            levels.append(((lw + 1) // 2, (lh + 1) // 2))
        base = 0
        for li, (lw, lh) in enumerate(levels):
            nxt = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    if li + 1 < len(levels):
                        pw = levels[li + 1][0]
                        parent.append(nxt + (j // 2) * pw + i // 2)
                    else:
                        parent.append(-1)
            base = nxt
        self.parent = parent
        self.reset()

    def reset(self):
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio, leaf: int, threshold: int) -> int:
        stk = []
        node = leaf
        parent, value, low_ = self.parent, self.value, self.low
        while parent[node] >= 0:
            stk.append(node)
            node = parent[node]
        low = 0
        while True:
            if low > low_[node]:
                low_[node] = low
            else:
                low = low_[node]
            while low < threshold:
                if low >= value[node]:
                    break
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            low_[node] = low
            if not stk:
                break
            node = stk.pop()
        return 1 if value[node] < threshold else 0


class Bio:
    """bio.c's bit reader: after a 0xFF byte the next byte gives 7 bits;
    past the end it reads 0."""

    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data, start: int, length: int):
        self.data, self.pos = data, start
        self.end = start + length
        self.buf = 0
        self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit()
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


class Band:
    __slots__ = ("bandno", "x0", "y0", "x1", "y1", "stepsize", "numbps",
                 "precincts")


class Precinct:
    __slots__ = ("x0", "y0", "x1", "y1", "cw", "ch", "cblks", "incl", "imsb")


class Res:
    __slots__ = ("x0", "y0", "x1", "y1", "pw", "ph", "pdx", "pdy", "bands")


class TileComp:
    __slots__ = ("x0", "y0", "x1", "y1", "dx", "dy", "numres", "res",
                 "resno_decoded")


def tile_geometry(cs, tileno: int, tcp):
    """((tx0, ty0, tx1, ty1), [TileComp]) of tile ``tileno``."""
    p, q = tileno % cs.tw, tileno // cs.tw
    tx0 = max(cs.tx0 + p * cs.tdx, cs.x0)
    ty0 = max(cs.ty0 + q * cs.tdy, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1)
    ty1 = min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
    comps = []
    for (prec, _sgnd, dx, dy), tccp in zip(cs.comps, tcp.tccps):
        if tccp.numres == 0:
            raise J2kError("tiles require at least one resolution")
        tc = TileComp()
        tc.dx, tc.dy = dx, dy
        tc.x0, tc.y0 = _ceildiv(tx0, dx), _ceildiv(ty0, dy)
        tc.x1, tc.y1 = _ceildiv(tx1, dx), _ceildiv(ty1, dy)
        tc.numres = tccp.numres
        tc.resno_decoded = 0
        tc.res = []
        step_i = 0
        for resno in range(tccp.numres):
            level = tccp.numres - 1 - resno
            r = Res()
            r.x0, r.y0 = _ceilpow2(tc.x0, level), _ceilpow2(tc.y0, level)
            r.x1, r.y1 = _ceilpow2(tc.x1, level), _ceilpow2(tc.y1, level)
            pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
            r.pdx, r.pdy = pdx, pdy
            px0 = (r.x0 >> pdx) << pdx
            py0 = (r.y0 >> pdy) << pdy
            px1 = _ceilpow2(r.x1, pdx) << pdx
            py1 = _ceilpow2(r.y1, pdy) << pdy
            r.pw = 0 if r.x0 == r.x1 else (px1 - px0) >> pdx
            r.ph = 0 if r.y0 == r.y1 else (py1 - py0) >> pdy
            if resno == 0:
                cbgx0, cbgy0, cbgw, cbgh, nbands = px0, py0, pdx, pdy, 1
            else:
                cbgx0, cbgy0 = _ceilpow2(px0, 1), _ceilpow2(py0, 1)
                cbgw, cbgh, nbands = pdx - 1, pdy - 1, 3
            cbw = min(tccp.cblkw, cbgw)
            cbh = min(tccp.cblkh, cbgh)
            r.bands = []
            for bandno in range(nbands):
                b = Band()
                if resno == 0:
                    b.bandno = 0
                    b.x0, b.y0, b.x1, b.y1 = r.x0, r.y0, r.x1, r.y1
                else:
                    b.bandno = bandno + 1
                    xb, yb = b.bandno & 1, b.bandno >> 1
                    b.x0 = _ceilpow2(tc.x0 - (xb << level), level + 1)
                    b.y0 = _ceilpow2(tc.y0 - (yb << level), level + 1)
                    b.x1 = _ceilpow2(tc.x1 - (xb << level), level + 1)
                    b.y1 = _ceilpow2(tc.y1 - (yb << level), level + 1)
                expn, mant = tccp.steps[step_i]
                step_i += 1
                gain = 0 if tccp.qmfbid == 0 else (0, 1, 1, 2)[b.bandno]
                b.stepsize = np.float32((1.0 + mant / 2048.0)
                                        * 2.0 ** (prec + gain - expn))
                b.numbps = expn + tccp.numgbits - 1
                b.precincts = []
                for precno in range(r.pw * r.ph):
                    cx0 = cbgx0 + (precno % r.pw) * (1 << cbgw)
                    cy0 = cbgy0 + (precno // r.pw) * (1 << cbgh)
                    pr = Precinct()
                    pr.x0, pr.y0 = max(cx0, b.x0), max(cy0, b.y0)
                    pr.x1 = min(cx0 + (1 << cbgw), b.x1)
                    pr.y1 = min(cy0 + (1 << cbgh), b.y1)
                    bx0 = (pr.x0 >> cbw) << cbw
                    by0 = (pr.y0 >> cbh) << cbh
                    bx1 = _ceilpow2(pr.x1, cbw) << cbw
                    by1 = _ceilpow2(pr.y1, cbh) << cbh
                    pr.cw = max(0, (bx1 - bx0) >> cbw)
                    pr.ch = max(0, (by1 - by0) >> cbh)
                    pr.cblks = []
                    for cb in range(pr.cw * pr.ch):
                        x = bx0 + (cb % pr.cw) * (1 << cbw)
                        y = by0 + (cb // pr.cw) * (1 << cbh)
                        pr.cblks.append(Cblk(max(x, pr.x0), max(y, pr.y0),
                                             min(x + (1 << cbw), pr.x1),
                                             min(y + (1 << cbh), pr.y1)))
                    n = pr.cw * pr.ch
                    pr.incl = TagTree(pr.cw, pr.ch) if n else None
                    pr.imsb = TagTree(pr.cw, pr.ch) if n else None
                    b.precincts.append(pr)
                r.bands.append(b)
            tc.res.append(r)
        comps.append(tc)
    return (tx0, ty0, tx1, ty1), comps


# ------------------------------ progressions ------------------------------

def _steps(comps):
    """pi.c's dx, dy: the smallest precinct step on the reference grid."""
    dx = dy = 0
    for tc in comps:
        for resno, r in enumerate(tc.res):
            lv = tc.numres - 1 - resno
            if r.pdx + lv < 32:
                v = tc.dx << (r.pdx + lv)
                if v <= 0xFFFFFFFF:
                    dx = v if not dx else min(dx, v)
            if r.pdy + lv < 32:
                v = tc.dy << (r.pdy + lv)
                if v <= 0xFFFFFFFF:
                    dy = v if not dy else min(dy, v)
    return dx, dy


def _precinct_at(tc, resno, x, y, tile):
    """The precinct of (x, y) on the reference grid at ``resno`` of
    component ``tc``, or None where pi.c skips the position."""
    tx0, ty0, tx1, ty1 = tile
    r = tc.res[resno]
    lv = tc.numres - 1 - resno
    trx0, try0 = _ceildiv(tx0, tc.dx << lv), _ceildiv(ty0, tc.dy << lv)
    trx1, try1 = _ceildiv(tx1, tc.dx << lv), _ceildiv(ty1, tc.dy << lv)
    rpx, rpy = r.pdx + lv, r.pdy + lv
    if not (y % (tc.dy << rpy) == 0
            or (y == ty0 and (try0 << lv) % (1 << rpy))):
        return None
    if not (x % (tc.dx << rpx) == 0
            or (x == tx0 and (trx0 << lv) % (1 << rpx))):
        return None
    if r.pw == 0 or r.ph == 0 or trx0 == trx1 or try0 == try1:
        return None
    prci = (_ceildiv(x, tc.dx << lv) >> r.pdx) - (trx0 >> r.pdx)
    prcj = (_ceildiv(y, tc.dy << lv) >> r.pdy) - (try0 >> r.pdy)
    return prci + prcj * r.pw


def packet_order(tcp, comps, tile):
    """(layer, resno, compno, precno) of every packet in the tile's order."""
    numlayers = tcp.numlayers
    maxres = max(tc.numres for tc in comps)
    ncomp = len(comps)
    if tcp.pocs:
        entries = [(r0, c0, min(l1, numlayers), r1, c1, prg)
                   for r0, c0, l1, r1, c1, prg in tcp.pocs]
    else:
        entries = [(0, 0, numlayers, maxres, ncomp, tcp.prg)]
    seen = set()
    order = []
    tx0, ty0, tx1, ty1 = tile

    def emit(l, r, c, p):
        if (l, r, c, p) not in seen:
            seen.add((l, r, c, p))
            order.append((l, r, c, p))

    for r0, c0, l1, r1, c1, prg in entries:
        if prg == -1:
            raise J2kError("Unknown progression order in COD marker")
        if prg > 4 or c0 >= ncomp or c1 >= ncomp + 1:
            continue  # pi.c: an unknown POC order or bad components end the entry
        if prg in (0, 1):  # LRCP, RLCP
            outer = [(l, r) for l in range(l1) for r in range(r0, r1)] \
                if prg == 0 else [(l, r) for r in range(r0, r1) for l in range(l1)]
            for l, r in outer:
                for c in range(c0, c1):
                    if r < comps[c].numres:
                        res = comps[c].res[r]
                        for p in range(res.pw * res.ph):
                            emit(l, r, c, p)
            continue
        if prg == 4:  # CPRL: steps per component
            for c in range(c0, c1):
                dx, dy = _steps([comps[c]])
                if dx == 0 or dy == 0:
                    break
                for y in _positions(ty0, ty1, dy):
                    for x in _positions(tx0, tx1, dx):
                        for r in range(r0, min(r1, comps[c].numres)):
                            p = _precinct_at(comps[c], r, x, y, tile)
                            if p is not None:
                                for l in range(l1):
                                    emit(l, r, c, p)
            continue
        dx, dy = _steps(comps)
        if dx == 0 or dy == 0:
            continue
        if prg == 2:  # RPCL
            for r in range(r0, r1):
                for y in _positions(ty0, ty1, dy):
                    for x in _positions(tx0, tx1, dx):
                        for c in range(c0, c1):
                            if r >= comps[c].numres:
                                continue
                            p = _precinct_at(comps[c], r, x, y, tile)
                            if p is not None:
                                for l in range(l1):
                                    emit(l, r, c, p)
        else:  # PCRL
            for y in _positions(ty0, ty1, dy):
                for x in _positions(tx0, tx1, dx):
                    for c in range(c0, c1):
                        for r in range(r0, min(r1, comps[c].numres)):
                            p = _precinct_at(comps[c], r, x, y, tile)
                            if p is not None:
                                for l in range(l1):
                                    emit(l, r, c, p)
    return order


def _positions(v0, v1, step):
    v = v0
    while v < v1:
        yield v
        v += step - v % step


# -------------------------------- packets ---------------------------------

def _numpasses(bio) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _new_seg(cblk, cblksty, first: bool):
    if cblksty & TERMALL:
        maxp = 1
    elif cblksty & LAZY:
        if first:
            maxp = 10
        else:
            prev = cblk.segs[-1][0]
            maxp = 2 if prev in (1, 10) else 1
    else:
        maxp = 109
    cblk.segs.append([maxp, 0, 0, 0, 0])


def read_packets(tcp, comps, tile, data: bytes, ppm):
    """Read the tile's packets from ``data`` (headers from ``ppm``, the
    codestream's PPM state, or the tile's PPT data when present) into the
    code-blocks; sets each component's resno_decoded."""
    order = packet_order(tcp, comps, tile)
    sop, eph = tcp.csty & 2, tcp.csty & 4
    pos, end = 0, len(data)
    if ppm is not None:
        hsrc = ppm
    elif tcp.ppt_data is not None:
        hsrc = [tcp.ppt_data, 0]
    else:
        hsrc = None
    for layno, resno, compno, precno in order:
        tc = comps[compno]
        res = tc.res[resno]
        cblksty = tcp.tccps[compno].cblksty
        tc.resno_decoded = max(tc.resno_decoded, resno)
        bands = [b for b in res.bands if b.x1 > b.x0 and b.y1 > b.y0]
        if layno == 0:
            for b in bands:
                if precno >= len(b.precincts):
                    raise J2kError("Invalid precinct")
                pr = b.precincts[precno]
                if pr.incl is not None:
                    pr.incl.reset()
                    pr.imsb.reset()
                for cb in pr.cblks:
                    cb.segs = []
                    cb.chunks = []
                    cb.chunk_at = []
        if sop:
            if end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
                pos += 6
        if hsrc is None:
            hdata, hpos, hlen = data, pos, end - pos
        else:
            hdata, hpos = hsrc
            hlen = len(hdata) - hpos
        bio = Bio(hdata, hpos, hlen)
        present = bio.bit()
        included = []
        if present:
            for b in bands:
                pr = b.precincts[precno]
                for cbno, cb in enumerate(pr.cblks):
                    if not cb.segs:
                        inc = pr.incl.decode(bio, cbno, layno + 1)
                    else:
                        inc = bio.bit()
                    if not inc:
                        cb.newpasses = 0
                        continue
                    if not cb.segs:
                        i = 0
                        while not pr.imsb.decode(bio, cbno, i):
                            i += 1
                            if i > 1000:
                                raise J2kError("Invalid zero bit-plane count")
                        cb.numbps = b.numbps + 1 - i
                        cb.numlenbits = 3
                    cb.newpasses = _numpasses(bio)
                    inc = 0
                    while bio.bit():
                        inc += 1
                    cb.numlenbits += inc
                    if not cb.segs:
                        _new_seg(cb, cblksty, True)
                        segno = 0
                    else:
                        segno = len(cb.segs) - 1
                        if cb.segs[segno][1] == cb.segs[segno][0]:
                            _new_seg(cb, cblksty, False)
                            segno += 1
                    n = cb.newpasses
                    first_seg = segno
                    while True:
                        seg = cb.segs[segno]
                        if cblksty & HT:   # the cleanup pass, then the rest
                            seg[4] = 1 if segno == 0 else n
                        else:
                            seg[4] = min(seg[0] - seg[1], n)
                        bits = cb.numlenbits + (seg[4].bit_length() - 1)
                        if bits > 32:
                            raise J2kError(f"Invalid bit number {bits} in a packet header")
                        seg[3] = bio.read(bits)
                        n -= seg[4]
                        if n <= 0:
                            break
                        _new_seg(cb, cblksty, False)
                        segno += 1
                    included.append((cb, first_seg))
        bio.inalign()
        hpos2 = bio.pos
        if eph:
            if (hlen - (hpos2 - hpos)) < 2 or hdata[hpos2] != 0xFF \
                    or hdata[hpos2 + 1] != 0x92:
                raise J2kError("Expected EPH marker")
            hpos2 += 2
        if hsrc is None:
            pos = hpos2
        else:
            hsrc[1] = hpos2
        # the packet's data
        for cb, segno in included:
            while cb.newpasses > 0:
                seg = cb.segs[segno]
                if pos + seg[3] > end:
                    raise J2kError("read: segment too long for a code-block")
                cb.chunks.append(data[pos:pos + seg[3]])
                cb.chunk_at.append(pos)
                pos += seg[3]
                seg[2] += seg[3]
                seg[1] += seg[4]
                cb.newpasses -= seg[4]
                if cb.newpasses > 0:
                    segno += 1
