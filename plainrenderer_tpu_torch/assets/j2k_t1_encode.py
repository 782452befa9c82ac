"""JPEG 2000 tier-1 encoding (T.800 Annexes C and D), as OpenJPEG 2.5.4's
t1.c and mqc.c encode a code-block with code-block style 0: EBCOT's three
coding passes over the magnitude bit-planes, every pass coded by one MQ
coder that is flushed once, after the last cleanup pass.

A code-block's ``numbps`` is the bit length of its largest magnitude
(t1.c shifts the coefficients up by T1_NMSEDEC_FRACBITS and takes them
off again; the bit-planes are the same). An all-zero code-block has no
passes. The passes are the cleanup pass of the top bit-plane, then the
significance propagation, refinement and cleanup passes of each plane
below: 3 * numbps - 2 in all. With one quality layer that takes every
pass (PIL's default save: one layer at rate 0), the code-block's length
is the MQ coder's byte count after its flush; the per-pass rates of
``opj_t1_encode_cblk`` (3 bytes added to an unterminated pass, made
non-increasing from the last pass down, one byte less where a pass would
end on 0xFF) never reach the stream.

The symbols of a pass do not depend on the MQ coder, so they are worked
out for every code-block of the image at once, plane by plane, in numpy,
and only the MQ coder runs symbol by symbol. The coefficients sit in a
padded (block, stripe, column, row) array whose flat order is OpenJPEG's
scan order (stripes of four rows, columns left to right, rows top down),
so that a neighbour is a fixed offset by row and "was visited earlier in
this pass" is a fixed rule by direction and row. A neighbour counts as
significant for a symbol where it was significant before the pass, or
became significant earlier in the same pass. Per pass:

  - significance propagation: the insignificant coefficients with a
    significant neighbour, each coded with its zero-coding context and,
    where it becomes significant, its sign; significance spreads forward
    within the pass, which is followed from the coefficients that became
    significant to their later neighbours until none is added;
  - refinement: every coefficient significant before the plane, by its
    magnitude context (first refinement with or without a significant
    neighbour, later ones);
  - cleanup: every other insignificant coefficient; a full stripe column
    whose four coefficients and whose neighbourhood are all insignificant
    when the scan reaches it is coded in run-length mode (one AGG symbol,
    then two UNIFORM symbols giving the first significant row and its
    sign, then the rows below it as usual).

The MQ encoder is T.800's (C.2): CODEMPS / CODELPS, RENORME, BYTEOUT with
bit stuffing after 0xFF and carry into the previous byte, and FLUSH
(SETBITS, two BYTEOUTs, a final 0xFF not counted), with OpenJPEG's
initial states (UNIFORM 46, AGG 3, zero-coding context 0 state 4)."""

from __future__ import annotations

import numpy as np

from .j2k_t1 import (CTX_AGG, CTX_UNI, INIT, NEXT_LPS, NEXT_MPS, QE, SC_CTX,
                     SC_XOR, ZC)

_ZC = np.array(ZC, np.int16)
_SC_CTX = np.array(SC_CTX, np.int16)
_SC_XOR = np.array(SC_XOR, np.bool_)
# by interval ``a`` below 0x8000: the doublings RENORME makes
_SHIFTS = [0] + [16 - a.bit_length() for a in range(1, 0x8000)]
# the eight neighbours in j2k_t1's flag bits: (flag bit, sign flag bit,
# (dy, dx), visited before the centre by its row in the stripe, the same
# at the moment the cleanup scan reaches the centre's stripe column)
_DIRS = (
    (1, 0, (-1, -1), (1, 1, 1, 1), (1, 1, 1, 1)),      # NW
    (2, 256, (-1, 0), (1, 1, 1, 1), (1, 0, 0, 0)),     # N
    (4, 0, (-1, 1), (1, 0, 0, 0), (1, 0, 0, 0)),       # NE
    (8, 1024, (0, -1), (1, 1, 1, 1), (1, 1, 1, 1)),    # W
    (16, 2048, (0, 1), (0, 0, 0, 0), (0, 0, 0, 0)),    # E
    (32, 0, (1, -1), (1, 1, 1, 0), (1, 1, 1, 0)),      # SW
    (64, 512, (1, 0), (0, 0, 0, 0), (0, 0, 0, 0)),     # S
    (128, 0, (1, 1), (0, 0, 0, 0), (0, 0, 0, 0)))      # SE


class _Layout:
    """The padded (block, stripe, column, row) arrays of a set of
    code-blocks: a stripe and a column of zeros around each block, so
    every neighbour offset stays inside the block's own slab."""

    def __init__(self, blocks):
        self.nblocks = len(blocks)
        hs = max(-(-c.shape[0] // 4) for c, _ in blocks)
        ws = max(c.shape[1] for c, _ in blocks)
        wp = ws + 2
        q = 4 * wp  # one stripe
        self.stride = (hs + 2) * q  # one block
        shape = (self.nblocks, hs + 2, wp, 4)
        mag = np.zeros(shape, np.int32)
        neg = np.zeros(shape, np.bool_)
        valid = np.zeros(shape, np.bool_)
        for b, (c, _) in enumerate(blocks):
            h, w = c.shape
            ns = -(-h // 4)
            t = np.zeros((ns * 4, w), np.int32)
            t[:h] = c
            t = t.reshape(ns, 4, w).transpose(0, 2, 1)
            mag[b, 1:ns + 1, 1:w + 1] = np.abs(t)
            neg[b, 1:ns + 1, 1:w + 1] = t < 0
            rows = (np.arange(ns)[:, None] * 4 + np.arange(4)) < h
            valid[b, 1:ns + 1, 1:w + 1] = rows[:, None, :]
        self.mag, self.neg, self.valid = (a.ravel() for a in (mag, neg, valid))
        self.orient = np.array([o for _, o in blocks], np.int64)
        peak = mag.reshape(self.nblocks, -1).max(axis=1)
        self.numbps = np.array([int(v).bit_length() for v in peak], np.int64)
        # flat offsets of each neighbour by the centre's row in the stripe
        self.dirs = [(bit, sgn, _offsets(q, dy, dx), np.array(early, np.bool_),
                      np.array(early_agg, np.bool_))
                     for bit, sgn, (dy, dx), early, early_agg in _DIRS]
        # the neighbours visited after a coefficient: S, E and SE always,
        # NE below a stripe's first row, SW from its last row
        self.later = [_offsets(q, 1, 0), _offsets(q, 0, 1), _offsets(q, 1, 1)]
        self.ne, self.sw = _offsets(q, -1, 1), _offsets(q, 1, -1)


def _offsets(q: int, dy: int, dx: int) -> np.ndarray:
    """Flat offsets of neighbour (dy, dx) by the centre's row in its
    stripe, in a layout of stripes of ``q`` entries."""
    out = []
    for r in range(4):
        s, rr = divmod(r + dy, 4)
        out.append(s * q + dx * 4 + rr - r)
    return np.array(out, np.int64)


def _neighbourhood(lay, idx, sig, late, agg=False):
    """The 12-bit j2k_t1 flags (neighbour significance and the four
    direct neighbours' signs) of flat positions ``idx``: a neighbour is
    significant where ``sig`` holds, or ``late`` holds and the scan
    visited it before the centre (before the centre's stripe column with
    ``agg``)."""
    r = idx & 3
    flags = np.zeros(idx.shape, np.int16)
    for bit, sgn, off, early, early_agg in lay.dirs:
        j = idx + off[r]
        s = sig[j] | (late[j] & (early_agg if agg else early)[r])
        flags |= s * np.int16(bit)
        if sgn:
            flags |= (s & lay.neg[j]) * np.int16(sgn)
    return flags


def _symbols(lay, idx, flags, bits):
    """Zero-coding symbols (context * 2 + bit) of positions ``idx``."""
    ctx = _ZC[lay.orient[idx // lay.stride], flags & 0xFF]
    return ctx.astype(np.int32) * 2 + bits


def _signs(lay, idx, flags):
    """Sign-coding symbols of positions ``idx``."""
    return (_SC_CTX[flags].astype(np.int32) * 2
            + (lay.neg[idx] ^ _SC_XOR[flags]))


def _interleave(first, second, has_second):
    """Per position one symbol, then another where ``has_second``."""
    both = np.stack([first, second], axis=1)
    keep = np.stack([np.ones_like(has_second), has_second], axis=1)
    return both[keep]


def _near(lay, sig):
    """Positions with a significant neighbour among their eight."""
    out = np.zeros_like(sig)
    n = sig.size
    for _bit, _sgn, off, _e, _a in lay.dirs:
        for r in range(4):
            o = int(off[r])
            # out[i] |= sig[i + o] for the positions i of row r
            lo, hi = max(0, -o), min(n, n - o)
            lo += (r - lo) % 4
            out[lo:hi:4] |= sig[lo + o:hi + o:4]
    return out


def _significance_pass(lay, bit, sig):
    """The coefficients the significance propagation pass visits, those
    that become significant in it, and its symbols (block per symbol,
    symbol)."""
    coded = lay.valid & ~sig & _near(lay, sig)
    new = coded & bit
    front = np.flatnonzero(new)
    while front.size:  # significance spreads to the later neighbours
        r = front & 3
        nxt = np.concatenate([front + off[r] for off in lay.later]
                             + [(front + lay.ne[r])[r > 0],
                                (front + lay.sw[r])[r == 3]])
        nxt = np.unique(nxt[lay.valid[nxt] & ~sig[nxt] & ~coded[nxt]])
        coded[nxt] = True
        front = nxt[bit[nxt]]
        new[front] = True
    idx = np.flatnonzero(coded)
    flags = _neighbourhood(lay, idx, sig, new)
    hit = bit[idx]
    return coded, new, (_interleave(idx, idx, hit) // lay.stride,
                        _interleave(_symbols(lay, idx, flags, hit),
                                    _signs(lay, idx, flags), hit))


def _refinement_pass(lay, bit, sig, after, mu):
    """The magnitude refinement pass's symbols."""
    idx = np.flatnonzero(sig)
    r = idx & 3
    near = np.zeros(idx.shape, np.bool_)
    for _bit, _sgn, off, _early, _early_agg in lay.dirs:
        near |= after[idx + off[r]]
    ctx = np.where(mu[idx], 16, np.where(near, 15, 14)).astype(np.int32)
    return idx // lay.stride, ctx * 2 + bit[idx]


def _cleanup_pass(lay, bit, clean, after):
    """The coefficients that become significant in the cleanup pass over
    ``clean``, and its symbols."""
    late = clean & bit
    # run-length columns: full stripe columns left to the cleanup whose
    # neighbourhood is insignificant when the scan reaches them
    cols = np.flatnonzero(clean.reshape(-1, 4).all(axis=1))
    quad = (cols[:, None] * 4 + np.arange(4)).ravel()
    flags = _neighbourhood(lay, quad, after, late, agg=True)
    cols = cols[~(flags & 0xFF).reshape(-1, 4).any(axis=1)]
    rows = bit.reshape(-1, 4)[cols]
    hit = rows.any(axis=1)
    runlen = np.where(hit, rows.argmax(axis=1), 4)
    # a run-length column codes no zero-coding symbol down to its first
    # significant row
    skip = np.zeros(clean.shape, np.bool_)
    for r in range(4):
        skip[cols[runlen >= r] * 4 + r] = True
    idx = np.flatnonzero(clean)
    flags = _neighbourhood(lay, idx, after, late)
    zc = ~skip[idx]
    sg = bit[idx]
    # each symbol's place: 8 slots per coefficient, a column's AGG and
    # UNIFORM symbols in its first row's
    head = cols * 32
    keys = np.concatenate([idx[zc] * 8 + 3, idx[sg] * 8 + 4, head,
                           head[hit] + 1, head[hit] + 2])
    syms = np.concatenate([
        _symbols(lay, idx[zc], flags[zc], bit[idx[zc]]),
        _signs(lay, idx[sg], flags[sg]),
        CTX_AGG * 2 + hit.astype(np.int32),
        CTX_UNI * 2 + (runlen[hit] >> 1), CTX_UNI * 2 + (runlen[hit] & 1)])
    order = np.argsort(keys)
    return late, (keys[order] // (8 * lay.stride), syms[order])


def encode_cblks(blocks):
    """[(bytes, numbps, passes)] of code-blocks ``blocks``, a list of
    ((h, w) integer coefficients, sub-band orientation 0-3)."""
    if not blocks:
        return []
    lay = _Layout(blocks)
    sig = np.zeros(lay.mag.size, np.bool_)
    mu = np.zeros(lay.mag.size, np.bool_)
    pieces = []  # (block per symbol, symbol) of each pass in coding order
    for p in range(int(lay.numbps.max()) - 1, -1, -1):
        bit = lay.valid & ((lay.mag >> p) & 1).astype(np.bool_)
        coded, new, symbols = _significance_pass(lay, bit, sig)
        pieces.append(symbols)
        after = sig | new
        pieces.append(_refinement_pass(lay, bit, sig, after, mu))
        mu |= sig
        # the cleanup pass, in the blocks whose top plane this is or is
        # above
        clean = (lay.valid & ~after & ~coded
                 & np.repeat(lay.numbps > p, lay.stride))
        late, symbols = _cleanup_pass(lay, bit, clean, after)
        pieces.append(symbols)
        sig = after | late
    blk = np.concatenate([b for b, _s in pieces] + [[]]).astype(np.int32)
    sym = np.concatenate([s for _b, s in pieces] + [[]]).astype(np.int32)
    sym = sym[np.argsort(blk, kind="stable")]
    ends = np.cumsum(np.bincount(blk, minlength=lay.nblocks))
    out = []
    for b, n in enumerate(lay.numbps.tolist()):
        if n:
            start = int(ends[b - 1]) if b else 0
            out.append((mq_encode(sym[start:ends[b]].tolist()), n, 3 * n - 2))
        else:
            out.append((b"", 0, 0))
    return out


def mq_encode(symbols) -> bytes:
    """The MQ coder's bytes for ``symbols`` (context * 2 + decision, the
    contexts of j2k_t1), flushed as opj_mqc_flush flushes, without the
    final 0xFF the flush leaves uncounted."""
    st = list(INIT)
    a, c, ct = 0x8000, 0, 12
    out = bytearray(b"\0")  # the byte before the stream, as in tcd.c

    def byteout():
        nonlocal c, ct
        if out[-1] == 0xFF:
            out.append((c >> 20) & 0xFF)
            c &= 0xFFFFF
            ct = 7
            return
        if c & 0x8000000:  # carry into the byte before
            out[-1] += 1
            if out[-1] == 0xFF:
                c &= 0x7FFFFFF
                out.append((c >> 20) & 0xFF)
                c &= 0xFFFFF
                ct = 7
                return
        out.append((c >> 19) & 0xFF)
        c &= 0x7FFFF
        ct = 8

    qe_of, nmps, nlps, shifts = QE, NEXT_MPS, NEXT_LPS, _SHIFTS
    for s in symbols:
        cx = s >> 1
        k = st[cx]
        qe = qe_of[k]
        a -= qe
        if not (s ^ k) & 1:  # the more probable symbol
            if a & 0x8000:
                c += qe
                continue
            if a < qe:
                a = qe
            else:
                c += qe
            st[cx] = nmps[k]
        else:
            if a < qe:
                c += qe
            else:
                a = qe
            st[cx] = nlps[k]
        n = shifts[a]  # RENORME
        while n >= ct:
            a <<= ct
            c <<= ct
            n -= ct
            byteout()
        a <<= n
        c <<= n
        ct -= n
    top = c + a  # FLUSH: SETBITS, then two BYTEOUTs
    c |= 0xFFFF
    if c >= top:
        c -= 0x8000
    c <<= ct
    byteout()
    c <<= ct
    byteout()
    end = len(out) - 1 if out[-1] == 0xFF else len(out)
    return bytes(out[1:end])
