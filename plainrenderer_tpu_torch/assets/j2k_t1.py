"""JPEG 2000 tier 1 (T.800 Annexes C and D): the MQ decoder and EBCOT's
three coding passes, as OpenJPEG 2.5.4's t1.c and mqc.c decode them.

``decode_cblk`` turns a code-block's segments into its coefficients with
one extra low bit (OpenJPEG's ``oneplushalf`` reconstruction; the caller
halves them). The MQ decoder is T.800's, with its 47-state table, C.3.2's
DECODE, RENORMD and BYTEIN (after 0xFF, a byte above 0x8F is a marker and
ones are fed instead), and each segment followed by 0xFF 0xFF, as mqc.c
appends them, so a segment that ends early reads ones. Raw (BYPASS)
segments read bits with the same 0xFF rule.

Contexts: zero coding per sub-band orientation (LL and LH, HL with the
horizontal and vertical counts swapped, HH), sign coding with its XOR bit
from the four direct neighbours, magnitude refinement (first refinement
with or without significant neighbours, later ones), run-length (AGG) and
UNIFORM; the run-length mode of the cleanup pass for full stripe columns
whose four coefficients and their neighbourhoods are all insignificant.
Code-block styles: BYPASS (sig and ref passes raw from the fifth bit-plane
on, OpenJPEG's test on the bit-plane counter including the ROI shift),
RESET (contexts reset after each MQ pass), TERMALL (one segment per pass,
by tier 2), VSC (the next stripe's coefficients never count as
significant), PTERM (nothing to do when decoding) and SEGSYM (four UNIFORM
symbols after each cleanup pass, read and not checked).

Significance state is kept per coefficient in a padded flag list: the eight
neighbours' significance, the four direct neighbours' signs, and the
coefficient's own significance, visited (this bit-plane's sig pass) and
refined flags; a coefficient that becomes significant updates its
neighbours (but not the stripe above with VSC). Each pass visits only its
candidates: the sig pass walks a heap of scan positions seeded with the
coefficients that have a significant neighbour and fed as significance
spreads forward, the ref pass the significant ones, the cleanup pass the
stripe columns that hold an unvisited insignificant coefficient, and a run
of run-length columns decodes its AGG symbols in bulk while the MQ
decoder stays on its fast MPS path."""

from __future__ import annotations

import heapq

import numpy as np

from .j2k_codestream import LAZY, RESET, SEGSYM, VSC, J2kError

# T.800 Table C.2: Qe, NMPS, NLPS, SWITCH
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
         17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
         33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0,
           0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
           0, 0, 0)
# a context's state is 2 * index + mps; per state: Qe, the state after an
# MPS and after an LPS decision
QE = tuple(_QE[s >> 1] for s in range(94))
NEXT_MPS = tuple(2 * _NMPS[s >> 1] + (s & 1) for s in range(94))
NEXT_LPS = tuple(2 * _NLPS[s >> 1] + ((s & 1) ^ _SWITCH[s >> 1])
                 for s in range(94))
CTX_AGG, CTX_UNI = 17, 18
INIT = [0] * 19
INIT[0], INIT[CTX_AGG], INIT[CTX_UNI] = 2 * 4, 2 * 3, 2 * 46

# flag bits: neighbour significance, neighbour signs, own state
NW, N, NE, W, E, SW, S, SE = 1, 2, 4, 8, 16, 32, 64, 128
NSGN, SSGN, WSGN, ESGN = 256, 512, 1024, 2048
SIG, PI, MU = 4096, 8192, 16384


def _zc_table(orient: int):
    out = []
    for f in range(256):
        h = bool(f & W) + bool(f & E)
        v = bool(f & N) + bool(f & S)
        d = bool(f & NW) + bool(f & NE) + bool(f & SW) + bool(f & SE)
        if orient == 1:  # HL: vertical neighbours count first
            h, v = v, h
        if orient == 3:
            hv = h + v
            if d == 0:
                n = min(hv, 2)
            elif d == 1:
                n = 3 + min(hv, 2)
            elif d == 2:
                n = 6 if hv == 0 else 7
            else:
                n = 8
        elif h == 0:
            n = (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else \
                (3 if v == 1 else 4)
        elif h == 1:
            n = (5 if d == 0 else 6) if v == 0 else 7
        else:
            n = 8
        out.append(n)
    return tuple(out)


ZC = tuple(_zc_table(o) for o in range(4))


def _sc_table():
    """(context, xor bit) by the 12 low flag bits (Table D.3)."""
    ctx, xor = [], []
    for f in range(4096):
        def contrib(sig, neg):
            return 0 if not f & sig else (-1 if f & neg else 1)
        hc = max(-1, min(1, contrib(W, WSGN) + contrib(E, ESGN)))
        vc = max(-1, min(1, contrib(N, NSGN) + contrib(S, SSGN)))
        x = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, x = -hc, -vc, 1
        c = {(1, 1): 13, (1, 0): 12, (1, -1): 11, (0, 1): 10, (0, 0): 9}[(hc, vc)]
        ctx.append(c)
        xor.append(x)
    return tuple(ctx), tuple(xor)


SC_CTX, SC_XOR = _sc_table()
_SCAN: dict = {}


def _scan_tables(w: int, h: int):
    """Per code-block size: each padded flat index's scan rank (-1 on the
    border) and row, the index of each scan rank, and each index's stripe
    column (-1 on the border)."""
    key = (w, h)
    if key not in _SCAN:
        stride = w + 2
        size = (h + 2) * stride
        order = [(y + 1) * stride + x + 1 for k in range(0, h, 4)
                 for x in range(w) for y in range(k, min(k + 4, h))]
        rank = [-1] * size
        col = [-1] * size
        for r, i in enumerate(order):
            rank[i] = r
            y, x = i // stride - 1, i % stride - 1
            col[i] = (y // 4) * w + x
        # each coefficient's neighbours inside the block: all eight, and
        # without the row above (VSC, first row of a stripe)
        nb8, nb5 = [()] * size, [()] * size
        for i in order:
            nb8[i] = tuple(j for j in (
                i - stride - 1, i - stride, i - stride + 1, i - 1, i + 1,
                i + stride - 1, i + stride, i + stride + 1) if rank[j] >= 0)
            nb5[i] = tuple(j for j in (
                i - 1, i + 1, i + stride - 1, i + stride, i + stride + 1)
                if rank[j] >= 0)
        _SCAN[key] = (order, rank, [i // stride - 1 for i in range(size)],
                      col, nb8, nb5)
    return _SCAN[key]


def decode_cblk(segments, w: int, h: int, orient: int, numbps: int,
                roishift: int, cblksty: int) -> np.ndarray:
    """(h, w) int64 coefficients of a code-block from ``segments``, a
    list of (bytes, number of passes)."""
    stride = w + 2
    size = (h + 2) * stride
    flags = [0] * size
    val = [0] * size
    zc = ZC[orient]
    vsc = cblksty & VSC
    order, rank, row_of, col_of, nb8, nb5 = _scan_tables(w, h)
    ctx = list(INIT)
    bpno = roishift + numbps
    if bpno >= 31:
        raise J2kError(f"unsupported bpno_plus_one = {bpno} >= 31")
    passtype = 2
    # insignificant coefficients with a significant neighbour (sig-pass
    # candidates), the significant ones by scan rank as of the last
    # cleanup (ref-pass candidates), the ranks that became significant
    # since, the coefficients the sig pass visited, and the insignificant
    # coefficients left in each stripe column
    frontier = set()
    refine: list = []
    fresh: list = []
    visited: list = []
    left = [0] * (((h + 3) // 4) * w)
    for i in order:
        left[col_of[i]] += 1

    # MQ / raw decoder state
    buf = b""
    bp = a = c = ct = 0

    def bytein():
        nonlocal bp, c, ct
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                c += 0xFF00
                ct = 8
            else:
                bp += 1
                c += buf[bp] << 9
                ct = 7
        else:
            bp += 1
            c += buf[bp] << 8
            ct = 8

    def dec(cx):
        nonlocal a, c, ct
        s = ctx[cx]
        qe = QE[s]
        a -= qe
        if (c >> 16) < qe:
            if a < qe:
                a = qe
                d = s & 1
                ctx[cx] = NEXT_MPS[s]
            else:
                a = qe
                d = (s & 1) ^ 1
                ctx[cx] = NEXT_LPS[s]
        else:
            c -= qe << 16
            if a & 0x8000:
                return s & 1
            if a < qe:
                d = (s & 1) ^ 1
                ctx[cx] = NEXT_LPS[s]
            else:
                d = s & 1
                ctx[cx] = NEXT_MPS[s]
        while True:
            if ct == 0:
                bytein()
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                return d

    def agg_zeros(limit):
        """Decode AGG symbols until one is 1 or ``limit`` zeros were
        decoded; the number of zeros."""
        nonlocal a, c
        done = 0
        while done < limit:
            s = ctx[CTX_AGG]
            if not s & 1:
                qe = QE[s]
                k = min((a - 0x8000) // qe, (c >> 16) // qe, limit - done)
                if k > 0:
                    a -= k * qe
                    c -= (k * qe) << 16
                    done += k
                    continue
            if dec(CTX_AGG):
                return done
            done += 1
        return done

    def raw():
        nonlocal bp, c, ct
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    c = 0xFF
                    ct = 8
                else:
                    c = buf[bp]
                    bp += 1
                    ct = 7
            else:
                c = buf[bp]
                bp += 1
                ct = 8
        ct -= 1
        return (c >> ct) & 1

    def significant(i, neg, one):
        """Mark coefficient i significant with sign ``neg``; returns its
        insignificant neighbours later in scan order."""
        val[i] = -one if neg else one
        flags[i] |= SIG
        frontier.discard(i)
        fresh.append(rank[i])
        left[col_of[i]] -= 1
        if neg:
            flags[i - 1] |= E | ESGN
            flags[i + 1] |= W | WSGN
            flags[i + stride] |= N | NSGN
        else:
            flags[i - 1] |= E
            flags[i + 1] |= W
            flags[i + stride] |= N
        flags[i + stride - 1] |= NE
        flags[i + stride + 1] |= NW
        if vsc and row_of[i] % 4 == 0:
            nbrs = nb5[i]
        else:
            flags[i - stride] |= (S | SSGN) if neg else S
            flags[i - stride - 1] |= SE
            flags[i - stride + 1] |= SW
            nbrs = nb8[i]
        for j in nbrs:
            if not flags[j] & SIG:
                frontier.add(j)
        return nbrs

    def sign_of(i):
        f = flags[i] & 0xFFF
        return dec(SC_CTX[f]) ^ SC_XOR[f]

    for seg, npasses in segments:
        lazy = (bpno <= numbps - 4 and passtype < 2 and cblksty & LAZY)
        buf = seg + b"\xff\xff"
        bp = 0
        if lazy:
            c = ct = 0
        else:
            c = buf[0] << 16
            bytein()
            c = (c << 7) & 0xFFFFFFFF
            ct -= 7
            a = 0x8000
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            half = one >> 1
            oph = one | half
            if passtype == 0:  # significance propagation
                heap = sorted(rank[i] for i in frontier)
                while heap:
                    r = heapq.heappop(heap)
                    i = order[r]
                    f = flags[i]
                    if f & (SIG | PI) or not f & 0xFF:
                        continue
                    if lazy:
                        hit = raw()
                        if hit:
                            nbrs = significant(i, raw(), oph)
                    else:
                        hit = dec(zc[f & 0xFF])
                        if hit:
                            nbrs = significant(i, sign_of(i), oph)
                    flags[i] |= PI
                    visited.append(i)
                    if hit:
                        for j in nbrs:
                            rj = rank[j]
                            if rj > r and j in frontier and not flags[j] & PI:
                                heapq.heappush(heap, rj)
            elif passtype == 1 and lazy:  # magnitude refinement, raw
                for r in refine:
                    i = order[r]
                    v = raw()
                    cur = val[i]
                    val[i] = cur + (half if v ^ (cur < 0) else -half)
                    flags[i] |= MU
            elif passtype == 1:  # magnitude refinement (the MQ decode inline)
                for r in refine:
                    i = order[r]
                    f = flags[i]
                    cx = 16 if f & MU else (15 if f & 0xFF else 14)
                    st = ctx[cx]
                    qe = QE[st]
                    a -= qe
                    if (c >> 16) < qe:
                        if a < qe:
                            v = st & 1
                            ctx[cx] = NEXT_MPS[st]
                        else:
                            v = (st & 1) ^ 1
                            ctx[cx] = NEXT_LPS[st]
                        a = qe
                    else:
                        c -= qe << 16
                        if a & 0x8000:
                            v = st & 1
                        else:
                            if a < qe:
                                v = (st & 1) ^ 1
                                ctx[cx] = NEXT_LPS[st]
                            else:
                                v = st & 1
                                ctx[cx] = NEXT_MPS[st]
                    while a < 0x8000:
                        if ct == 0:
                            bytein()
                        a <<= 1
                        c = (c << 1) & 0xFFFFFFFF
                        ct -= 1
                    cur = val[i]
                    val[i] = cur + (half if v ^ (cur < 0) else -half)
                    flags[i] = f | MU
            else:  # cleanup
                for k in range(0, h, 4):
                    full = k + 4 <= h
                    base = (k + 1) * stride
                    cbase = (k // 4) * w
                    x = 0
                    while x < w:
                        if not left[cbase + x]:
                            x += 1
                            continue
                        i0 = base + x + 1
                        if full:
                            f0, f1 = flags[i0], flags[i0 + stride]
                            f2, f3 = flags[i0 + 2 * stride], flags[i0 + 3 * stride]
                            if not (f0 | f1 | f2 | f3):
                                # a run of run-length columns
                                run = 1
                                while x + run < w:
                                    j = i0 + run
                                    if (flags[j] | flags[j + stride]
                                            | flags[j + 2 * stride]
                                            | flags[j + 3 * stride]):
                                        break
                                    run += 1
                                zeros = agg_zeros(run)
                                x += zeros
                                if zeros == run:
                                    continue
                                i0 = base + x + 1
                                rl = dec(CTX_UNI) << 1
                                rl |= dec(CTX_UNI)
                                i = i0 + rl * stride
                                significant(i, sign_of(i), oph)
                                for ci in range(rl + 1, 4):
                                    i = i0 + ci * stride
                                    if dec(zc[flags[i] & 0xFF]):
                                        significant(i, sign_of(i), oph)
                                x += 1
                                continue
                        for ci in range(4 if full else h - k):
                            i = i0 + ci * stride
                            f = flags[i]
                            if f & (SIG | PI):
                                continue
                            if dec(zc[f & 0xFF]):
                                significant(i, sign_of(i), oph)
                        x += 1
                for i in visited:
                    flags[i] &= ~PI
                visited.clear()
                if fresh:
                    fresh.sort()
                    refine = sorted(refine + fresh) if refine else list(fresh)
                    fresh.clear()
                if cblksty & SEGSYM:
                    for _s in range(4):
                        dec(CTX_UNI)
            if cblksty & RESET and not lazy:
                ctx[:] = INIT
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(val, np.int64).reshape(h + 2, stride)[1:h + 1, 1:w + 1]
    return out
