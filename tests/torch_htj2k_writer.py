"""A writer of HTJ2K (JPEG 2000 Part 15) codestreams for the tests (a
helper, not collected): nothing on this machine writes HTJ2K, and the
port reads it only (PIL writes none), so the fixtures of
tests/test_torch_formats_htj2k.py come from here and are held to PIL's
decode of them, never to this writer's input.

  - ``encode_block``: one code-block's HT cleanup pass (T.814: MEL, VLC
    and UVLC written backward, MagSgn forward, with their bit stuffing,
    the MEL / VLC termination and the 12-bit Scup) at cleanup bit-plane
    p, and with passes 2 or 3 its SigProp (and MagRef) pass one bit-plane
    below, the codewords taken from the port's copy of OpenJPEG's VLC
    tables (assets/j2k_ht.py) in the contexts its decoder forms;
  - ``encode_image``: a codestream (or a JP2 file) around such blocks:
    SIZ with Rsiz's Part 15 flag, CAP, COD with the HT code-block style,
    QCD (the reversible 5/3 with no quantisation, or the 9/7 with
    expounded step sizes), any tile grid, code-block size, precincts,
    layers, progression, components (ICT / RCT on the first three) and
    precision, the tier-2 packets as OpenJPEG reads HT code-blocks: the
    cleanup pass as the first codeword segment, the refinement passes as
    the second, each length in Lblock + floor(log2(passes)) bits.

The 9/7 analysis is the float64 inverse of the port's synthesis
(assets/j2k_recon.py), so the decoder's step sizes scale it back."""

import struct
import types

import numpy as np

from plainrenderer_tpu_torch.assets import j2k_ht, j2k_recon, j2k_t2
from plainrenderer_tpu_torch.assets.j2k_codestream import HT, VSC, Tcp
from plainrenderer_tpu_torch.assets.j2k_recon import band_origin, line_layout
from plainrenderer_tpu_torch.assets.j2k_t2_encode import (
    BitWriter, TagTreeEncoder, _floorlog2, _numpasses)

def _vlc_codes(tbl):
    """(context, rho, u_off) -> [(e_k, e_1, codeword, length)]."""
    out = {}
    for c in range(8):
        seen = set()
        for i in range(128):
            e = tbl[(c << 7) | i]
            n = e & 7
            key = (c, (e >> 4) & 15, (e >> 3) & 1)
            code = ((e >> 12) & 15, (e >> 8) & 15, i & ((1 << n) - 1), n)
            if (key, code) not in seen:
                seen.add((key, code))
                out.setdefault(key, []).append(code)
    return out


CODES0 = _vlc_codes(j2k_ht.VLC0)
CODES1 = _vlc_codes(j2k_ht.VLC1)


class _Fwd:
    """MagSgn / SigProp: bits LSB first, 7 bits after a 0xFF byte."""

    def __init__(self, fill_ones):
        self.buf = bytearray()
        self.tmp = self.used = 0
        self.max = 8
        self.ones = fill_ones

    def put(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == self.max:
                self.buf.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def end(self) -> bytes:
        if self.used:
            if self.ones:
                self.tmp |= (0xFF << self.used) & ((1 << self.max) - 1)
                if self.tmp != 0xFF:
                    self.buf.append(self.tmp)
            else:
                self.buf.append(self.tmp)
        elif self.max == 7 and self.ones:
            self.buf.pop()
        return bytes(self.buf)


class _Rev:
    """VLC / MagRef: bits LSB first into bytes written backward; after a
    byte above 0x8F a byte whose low 7 bits are all set keeps its top bit
    0. VLC starts in the upper nibble of the byte that ends in Scup."""

    def __init__(self, vlc):
        self.buf = []               # bytes in writing order
        if vlc:
            self.tmp, self.used, self.gt8f = 0xF, 4, True
        else:
            self.tmp, self.used, self.gt8f = 0, 0, True

    def put(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            avail = 8 - self.gt8f - self.used
            if avail == 0:
                if self.gt8f and self.tmp != 0x7F:
                    self.gt8f = False
                    continue
                self.buf.append(self.tmp)
                self.gt8f = self.tmp > 0x8F
                self.tmp = self.used = 0


class _Mel:
    def __init__(self):
        self.buf = bytearray()
        self.tmp = 0
        self.rem = 8
        self.run = 0
        self.k = 0
        self.threshold = 1

    def _bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, bit):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << j2k_ht.MEL_EXP[self.k]
        else:
            self._bit(0)
            t = j2k_ht.MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << j2k_ht.MEL_EXP[self.k]


def _uvlc_bits(c):
    """The prefix and suffix of a UVLC value c >= 1, as (bits, n) pairs."""
    if c == 1:
        return (1, 1), (0, 0)
    if c == 2:
        return (2, 2), (0, 0)
    if c <= 4:
        return (4, 3), (c - 3, 1)
    return (0, 3), (c - 5, 5)


def _cleanup(mu, neg, p_bits):
    """The cleanup segment of magnitudes mu (h, w) with signs neg."""
    h, w = mu.shape
    vlc = _Rev(True)
    mel = _Mel()
    ms = _Fwd(True)
    E = np.zeros((h, w), np.int64)
    nz = mu > 0
    E[nz] = np.array([int(2 * m - 1).bit_length() for m in mu[nz]])
    nq = (w + 1) // 2
    line = [0] * (nq + 2)   # as the decoder: sigma bit 7, E bits 0-6
    for y in range(0, h, 2):
        initial = y == 0
        codes = CODES0 if initial else CODES1
        c_q = 0
        ls0 = line[0]
        if not initial:
            line[0] = 0
        for x in range(0, w, 4):
            qi = x >> 1
            quads = []
            for k in (0, 1):
                xs = x + 2 * k
                if k and x + 2 >= w:
                    break
                cells = [(y, xs), (y + 1, xs), (y, xs + 1), (y + 1, xs + 1)]
                inside = [yy < h and xx < w for yy, xx in cells]
                rho = sum(1 << i for i, (yy, xx) in enumerate(cells)
                          if inside[i] and mu[yy, xx] > 0)
                es = [int(E[yy, xx]) if inside[i] else 0
                      for i, (yy, xx) in enumerate(cells)]
                if initial:
                    cq = c_q
                    kappa = 1
                else:
                    cq = c_q | ((ls0 if k == 0 else line[qi + 1]) >> 7) | (
                        (line[qi + 1 + k] >> 5) & 4)
                    kappa = 1
                    if rho & (rho - 1):
                        e = max((ls0 if k == 0 else line[qi + 1]) & 0x7F,
                                line[qi + 1 + k] & 0x7F)
                        kappa = max(1, e - 1)
                emax = max(es)
                uq = max(emax, kappa)
                u = uq - kappa
                uoff = int(u > 0)
                best = None
                for ek, e1, cw, n in codes.get((cq, rho, uoff), []):
                    if ek & ~rho:
                        continue
                    if any(((ek >> i) & 1) and ((e1 >> i) & 1)
                           != (es[i] == uq) for i in range(4)):
                        continue
                    if best is None or n < best[3]:
                        best = (ek, e1, cw, n)
                if cq == 0:
                    mel.event(1 if rho else 0)
                if cq != 0 or rho:
                    assert best is not None, (cq, rho, uoff, es, uq)
                    vlc.put(best[2], best[3])
                    ek = best[0]
                else:
                    ek = 0
                if initial:
                    c_q = (rho & 1) | ((rho >> 1) & 7)
                else:
                    c_q = ((rho >> 2) & 1 | (rho >> 3) & 1) << 1
                quads.append((cells, inside, rho, uq, u, ek, es))
            us = [q[4] for q in quads] + [0]
            mode = int(us[0] > 0) | (int(us[1] > 0) << 1)
            if initial and mode == 3:
                big = us[0] > 2 and us[1] > 2
                mel.event(int(big))
                if big:
                    (a, na), (sa, nsa) = _uvlc_bits(us[0] - 2)
                    (b, nb), (sb, nsb) = _uvlc_bits(us[1] - 2)
                    for v, n in ((a, na), (b, nb), (sa, nsa), (sb, nsb)):
                        vlc.put(v, n)
                elif us[0] > 2:
                    (a, na), (sa, nsa) = _uvlc_bits(us[0])
                    vlc.put(a, na)
                    vlc.put(us[1] - 1, 1)
                    vlc.put(sa, nsa)
                else:
                    (a, na), (sa, nsa) = _uvlc_bits(us[0])
                    (b, nb), (sb, nsb) = _uvlc_bits(us[1])
                    for v, n in ((a, na), (b, nb), (sa, nsa), (sb, nsb)):
                        vlc.put(v, n)
            elif mode:
                pre, suf = [], []
                for k in (0, 1):
                    if (mode >> k) & 1:
                        a, s = _uvlc_bits(us[k])
                        pre.append(a)
                        suf.append(s)
                for v, n in pre + suf:
                    vlc.put(v, n)
            if not initial:
                ls0 = line[qi + 2]
                line[qi + 1] = line[qi + 2] = 0
            for k, (cells, inside, rho, uq, u, ek, es) in enumerate(quads):
                li = qi + k
                for i, (yy, xx) in enumerate(cells):
                    if i == 3 and initial:
                        line[li + 1] = 0
                    if not (rho >> i) & 1:
                        continue
                    v = 2 * (int(mu[yy, xx]) - 1) + int(neg[yy, xx])
                    m = uq - ((ek >> i) & 1)
                    ms.put(v, m)
                    if i == 1:
                        line[li] = 0x80 | max(line[li] & 0x7F, es[i])
                    elif i == 3:
                        line[li + 1] = 0x80 | es[i]
    # MEL / VLC termination and the Scup
    if mel.run > 0:
        mel._bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used) if vlc.used else 0
    mbuf = bytearray(mel.buf)
    vbuf = list(vlc.buf)
    if mel_mask | vlc_mask:
        fuse = mel_tmp | vlc.tmp
        if ((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask))
                == 0 and fuse != 0xFF and vbuf):
            mbuf.append(fuse)
        else:
            mbuf.append(mel_tmp)
            vbuf.append(vlc.tmp)
    msb = ms.end()
    vlc_bytes = bytes(reversed(vbuf)) + b"\xff"
    scup = len(mbuf) + len(vlc_bytes)
    seg = bytearray(msb + bytes(mbuf) + vlc_bytes)
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    assert 2 <= scup <= 4079
    return bytes(seg)


def _refinement(c, mu, p_cup, passes, vsc):
    """The SigProp (and MagRef) segment one bit-plane below p_cup."""
    h, w = c.shape
    a = np.abs(c)
    sig = mu > 0
    new = np.zeros_like(sig)
    bit = (a >> (p_cup - 1)) & 1
    sp = _Fwd(False)
    for y0 in range(0, h, 4):
        rows = range(y0, min(y0 + 4, h))
        for gx in range(0, w, 4):
            found = []
            for x in range(gx, min(gx + 4, w)):
                for y in rows:
                    if sig[y, x]:
                        continue
                    if _member(sig, new, y, x, y0, h, w, vsc):
                        sp.put(int(bit[y, x]), 1)
                        if bit[y, x]:
                            new[y, x] = True
                            found.append((y, x))
            for y, x in found:
                sp.put(int(c[y, x] < 0), 1)
    sp_bytes = sp.end()
    mr = b""
    if passes > 2:
        rev = _Rev(False)
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        rev.put(int(bit[y, x]), 1)
        buf = list(rev.buf)
        if rev.used:
            buf.append(rev.tmp)
        mr = bytes(reversed(buf))
    seg = sp_bytes + mr
    return seg or b"\x00"


def _member(sig, new, y, x, y0, h, w, vsc):
    """SigProp membership: a significant neighbour after the cleanup, or
    one that became significant earlier in the scan."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if not dy and not dx:
                continue
            yy, xx = y + dy, x + dx
            if not (0 <= yy < h and 0 <= xx < w):
                continue
            if vsc and yy >= y0 + 4:
                continue
            if sig[yy, xx]:
                return True
            earlier = xx < x or (xx == x and yy < y) or yy < y0
            if earlier and new[yy, xx]:
                return True
    return False


def encode_block(c: np.ndarray, p_cup: int, passes: int = 1, vsc=False):
    """A code-block of integer coefficients ``c``: (segments [(bytes,
    passes)], numbps = p_cup + 1), or None where it codes nothing."""
    c = np.asarray(c, np.int64)
    mu = np.abs(c) >> p_cup
    if not mu.any():
        return None
    segs = [(_cleanup(mu, c < 0, p_cup + 1), 1)]
    if passes > 1 and p_cup > 0:
        segs.append((_refinement(c, mu, p_cup, passes, vsc), passes - 1))
    return segs, p_cup + 1


# ------------------------------ the codestream ------------------------------

def _fdwt97(x, cas):
    """The float64 inverse of j2k_recon._idwt97 along the last axis."""
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    low, high, ll, lr, hl, hr = line_layout(n, cas)
    s = x.astype(np.float64).copy()
    lift = [float(v) for v in j2k_recon.LIFT]
    for step in range(3, -1, -1):
        if step % 2 == 0:
            s[..., low] -= (s[..., ll] + s[..., lr]) * lift[step]
        else:
            s[..., high] -= (s[..., hl] + s[..., hr]) * lift[step]
    return np.concatenate([s[..., low] / float(j2k_recon.K),
                           s[..., high] / float(j2k_recon.TWO_INVK)], -1)


def _forward(plane, tc, irrev):
    from plainrenderer_tpu_torch.assets import j2k_fdwt
    if not irrev:
        j2k_fdwt.forward_dwt(plane, tc)
        return plane
    for resno in range(tc.numres - 1, 0, -1):
        r = tc.res[resno]
        rw, rh = r.x1 - r.x0, r.y1 - r.y0
        if rw and rh:
            plane[:rh, :rw] = _fdwt97(plane[:rh, :rw].T, r.y0 % 2).T
            plane[:rh, :rw] = _fdwt97(plane[:rh, :rw], r.x0 % 2)
    return plane


def _segment(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_image(img, *, irreversible=False, levels=3, cblk=(6, 6),
                 passes=1, p_cup=0, step=1.0, layers=1, tile=None,
                 precincts=None, prog=0, mct=None, prec=8, guard=2,
                 vsc=False, rsiz=0x4000, cap=True, jp2=False,
                 spread=False, tamper=None, rgn=None,
                 layout=None) -> bytes:
    """img (H, W[, C]) unsigned ints of ``prec`` bits -> an HTJ2K
    codestream (or JP2 file). The 5/3 path codes every coefficient
    exactly at p_cup 0; at p_cup > 0 the cleanup stops above the low
    bit-planes and the refinement passes add one. ``step`` scales the 9/7
    step sizes. With several layers, layer 0 holds the cleanup passes and
    the last layer the refinement passes, or (``spread``) block k of a
    tile sends all its passes in layer k % layers. ``tamper(k, segs,
    numbps)`` may return other segments and bit-planes for block k (a
    malformed block); ``rgn`` adds an RGN marker with that ROI shift;
    ``layout``, a list, receives the file offsets of every marker,
    packet and codeword segment (of the codestream, not the JP2 box)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    tw, th = tile or (w, h)
    if mct is None:
        mct = nc >= 3
    numres = levels + 1
    cs = types.SimpleNamespace(x0=0, y0=0, x1=w, y1=h, tx0=0, ty0=0,
                               tdx=tw, tdy=th, tw=-(-w // tw),
                               th=-(-h // th), comps=[(prec, 0, 1, 1)] * nc)
    tcp = Tcp(nc)
    tcp.numlayers = layers
    tcp.prg = prog
    tcp.csty = 1 if precincts else 0
    exps = []
    for b in range(3 * levels + 1):
        if irreversible:
            lvl = levels - (b + 2) // 3 if b else levels
            target = step * (2.0 ** (-0.5 * lvl))
            e = int(np.floor(np.log2(target)))
            mant = int(round((target / 2.0 ** e - 1) * 2048))
            mant = min(max(mant, 0), 2047)
            exps.append((prec - e, mant))
        else:
            gain = 0 if b == 0 else (1, 1, 2)[(b - 1) % 3]
            exps.append((prec + gain, 0))
    for t in tcp.tccps:
        t.numres = numres
        t.cblkw, t.cblkh = cblk
        t.qmfbid = 0 if irreversible else 1
        t.numgbits = guard
        t.cblksty = HT | (VSC if vsc else 0)
        t.steps = list(exps)
        if precincts:
            t.prcw = [precincts[0]] * numres
            t.prch = [precincts[1]] * numres
        else:
            t.prcw = t.prch = [15] * numres
    tiles = []
    for tno in range(cs.tw * cs.th):
        tile_rect, comps = j2k_t2.tile_geometry(cs, tno, tcp)
        encs = {}
        x0, y0, x1, y1 = tile_rect
        sub = img[y0:y1, x0:x1].astype(np.float64 if irreversible
                                       else np.int64)
        sub = sub - (1 << (prec - 1))
        if mct and nc >= 3:
            r, g, b_ = sub[..., 0].copy(), sub[..., 1].copy(), sub[..., 2].copy()
            if irreversible:
                sub[..., 0] = 0.299 * r + 0.587 * g + 0.114 * b_
                sub[..., 1] = -0.16875 * r - 0.33126 * g + 0.5 * b_
                sub[..., 2] = 0.5 * r - 0.41869 * g - 0.08131 * b_
            else:
                sub[..., 0] = (r + 2 * g + b_) >> 2
                sub[..., 1] = b_ - g
                sub[..., 2] = r - g
        for ci, tc in enumerate(comps):
            plane = sub[..., ci].astype(np.float64 if irreversible
                                        else np.int32).copy()
            _forward(plane, tc, irreversible)
            for resno, res in enumerate(tc.res):
                for b in res.bands:
                    xoff, yoff = band_origin(tc, resno, b)
                    for pr in b.precincts:
                        for cbk in pr.cblks:
                            bx0 = cbk.x0 - b.x0 + xoff
                            by0 = cbk.y0 - b.y0 + yoff
                            v = plane[by0:by0 + cbk.y1 - cbk.y0,
                                      bx0:bx0 + cbk.x1 - cbk.x0]
                            if irreversible:
                                q = np.floor(np.abs(v) / float(b.stepsize))
                                v = (np.sign(v) * q).astype(np.int64)
                            enc = encode_block(v, p_cup, passes, vsc)
                            if tamper is not None and enc is not None:
                                enc = tamper(len(encs), *enc)
                            encs[id(cbk)] = enc
                            if enc is not None:
                                assert enc[1] <= b.numbps, (
                                    "guard bits too few", enc[1], b.numbps)
        if spread:
            for k, key in enumerate(encs):
                if encs[key] is not None:
                    encs[key] = encs[key] + (k % layers,)
        data, offs = _packets(tcp, comps, tile_rect, layers, encs)
        tiles.append((data, offs))
    out = bytearray(struct.pack(">H", 0xFF4F))
    siz = struct.pack(">HIIIIIIIIH", rsiz, w, h, 0, 0, tw, th, 0, 0, nc) \
        + bytes([prec - 1, 1, 1]) * nc
    out += _segment(0xFF51, siz)
    if cap:
        out += _segment(0xFF50, struct.pack(">IH", 0x00020000, 0))
    cod = bytes([tcp.csty, prog]) + struct.pack(">H", layers) + bytes(
        [int(mct), levels, cblk[0] - 2, cblk[1] - 2, tcp.tccps[0].cblksty,
         0 if irreversible else 1])
    if precincts:
        cod += bytes([precincts[0] | (precincts[1] << 4)] * numres)
    out += _segment(0xFF52, cod)
    if irreversible:
        qcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for e, m in exps)
    else:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e, _ in exps)
    out += _segment(0xFF5C, qcd)
    if rgn is not None:
        for c in range(nc):
            out += _segment(0xFF5E, bytes([c, 0, rgn]) if nc < 257 else b"")
    for tno, (data, offs) in enumerate(tiles):
        marks = [len(out), len(out) + 12]
        out += _segment(0xFF90, struct.pack(">HIBB", tno, 14 + len(data),
                                            0, 1))
        out += struct.pack(">H", 0xFF93)
        if layout is not None:
            layout.extend(marks + [len(out) + o for o in offs])
        out += data
    if layout is not None:
        layout.append(len(out))
    out += struct.pack(">H", 0xFFD9)
    if jp2:
        return jp2_wrap(bytes(out), w, h, nc, prec)
    return bytes(out)


def _packets(tcp, comps, tile, layers, encs):
    """Every packet of the tile: each block's segments spread over the
    layers (the cleanup in layer 0, the refinement in the last)."""
    state = {}
    lblock = {}
    out = bytearray()
    offs = []
    for layno, resno, compno, precno in j2k_t2.packet_order(tcp, comps,
                                                            tile):
        bands = [b for b in comps[compno].res[resno].bands
                 if b.x1 > b.x0 and b.y1 > b.y0]
        key = (resno, compno, precno)
        if key not in state:
            trees = []
            for b in bands:
                pr = b.precincts[precno]
                incl = TagTreeEncoder(pr.cw, pr.ch)
                imsb = TagTreeEncoder(pr.cw, pr.ch)
                for cbno, cb in enumerate(pr.cblks):
                    enc = encs.get(id(cb))
                    first = _first_layer(enc, layers)
                    if first is not None:
                        incl.set_value(cbno, first)
                    imsb.set_value(cbno, b.numbps - (enc[1] if enc else 0))
                    lblock[id(cb)] = 3
                trees.append((incl, imsb))
            state[key] = trees
        bw = BitWriter()
        body = []
        offs.append(len(out))
        if not any(_layer_segs(encs.get(id(cb)), layers, layno)
                   for b in bands for cb in b.precincts[precno].cblks):
            bw.bit(0)
            out += bw.flush()
            continue
        bw.bit(1)
        for b, (incl, imsb) in zip(bands, state[key]):
            pr = b.precincts[precno]
            for cbno, cb in enumerate(pr.cblks):
                enc = encs.get(id(cb))
                segs = _layer_segs(enc, layers, layno)
                first = _first_layer(enc, layers)
                if first is None or first > layno:
                    incl.encode(bw, cbno, layno + 1)
                    continue
                if first == layno:
                    incl.encode(bw, cbno, layno + 1)
                else:
                    bw.bit(1 if segs else 0)
                if not segs:
                    continue
                if first == layno:
                    imsb.encode(bw, cbno, 999)
                n = sum(p for _, p in segs)
                _numpasses(bw, n)
                inc = max(0, max(len(d).bit_length() - (lblock[id(cb)]
                                                        + _floorlog2(p))
                                 for d, p in segs))
                bw.write((1 << (inc + 1)) - 2, inc + 1)
                lblock[id(cb)] += inc
                for d, p in segs:
                    bw.write(len(d), lblock[id(cb)] + _floorlog2(p))
                    body.append(d)
        head = bw.flush()
        at = len(out) + len(head)
        for d in body:
            offs.append(at)
            at += len(d)
        out += head + b"".join(body)
    return bytes(out), offs


def _first_layer(enc, layers):
    if enc is None:
        return None
    return enc[2] if len(enc) > 2 else 0


def _layer_segs(enc, layers, layno):
    """The segments a block sends in layer ``layno``."""
    if enc is None:
        return []
    segs = enc[0]
    if len(enc) > 2:
        return segs if layno == enc[2] else []
    if layers == 1:
        return segs if layno == 0 else []
    if layno == 0:
        return segs[:1]
    if layno == layers - 1:
        return segs[1:]
    return []


def jp2_wrap(cs: bytes, w, h, nc, prec) -> bytes:
    """A JP2 file: signature, ftyp 'jp2 ', jp2h (ihdr, colr enumerated
    sRGB or greyscale), jp2c."""
    def box(t, b):
        return struct.pack(">I", 8 + len(b)) + t + b
    ihdr = struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 16 if nc >= 3 else 17)
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr))
            + box(b"jp2c", cs))
