"""JPEG 2000 codestream markers (ITU-T T.800 Annex A), read as OpenJPEG
2.5.4's j2k.c reads them for PIL's tile-by-tile decode.

``Codestream(data, ihdr)`` reads the main header: SOC, then SIZ (image and
tile grid, per-component precision 1-31 bits, signedness, XRsiz / YRsiz),
then COD, COC, QCD, QCC, RGN, POC, PPM, TLM, PLM, CRG, COM, CAP and Part
2's CBD (new bit depths) and MCT (checked, unused) in any order up to the
first SOT; Part 2's MCC and MCO are refused by name. Part 15 (HTJ2K) needs
nothing of SIZ's Rsiz flag or of CAP, whose body OpenJPEG reads as an
empty segment of any length: the HT code-block style bit of COD / COC
alone sends a block to assets/j2k_ht.py; the mixed HT style is refused,
as OpenJPEG refuses it. Markers apply in the order they come, as in
j2k.c: a COD sets every component's coding style (a COC before it is
overwritten), a QCD every component's quantisation, a POC in a tile header
appends to the progressions the main header gave. An unknown marker in the
main header is skipped two bytes at a time up to the next known one.

``tiles()`` then yields ``(tile number, Tcp, tile data)`` in the order
OpenJPEG hands tiles to PIL: tile-parts are read (SOT, the tile-part
header's COD / COC / QCD / QCC / RGN / POC / PPT / PLT / COM, SOD, data)
until the tile's last part (TPsot + 1 == TNsot) is in, Psot 0 meaning the
rest of the stream but its last two bytes. A tile's PPT segments are
joined in Zppt order; the PPM segments of the main header are joined
without their Nppm fields into one stream of packet headers. The checks
are j2k.c's, with strict mode on as PIL leaves it: a tile-part longer than
the stream, a part out of order, a marker out of place, or a stream that
stops after a decoded tile where another marker should follow raise
J2kError. A stream that stops right after a tile-part's SOT marker code
ends the image, with the tiles that were read."""

from __future__ import annotations

import struct

SOC, SIZ, COD, COC, TLM, PLM, PLT, QCD, QCC, RGN, POC, PPM, PPT, CRG, COM = (
    0xFF4F, 0xFF51, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58, 0xFF5C, 0xFF5D,
    0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63, 0xFF64)
SOT, SOD, EOC, CAP, CPF = 0xFF90, 0xFF93, 0xFFD9, 0xFF50, 0xFF59
SOP, EPH = 0xFF91, 0xFF92
MCT, MCC, MCO, CBD = 0xFF74, 0xFF75, 0xFF77, 0xFF78
MAXRLVLS = 33
MAXBANDS = 3 * MAXRLVLS - 2
# code-block style bits
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM, HT, HTMIXED = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80)
# decoder states (j2k.h)
_MHSIZ, _MH, _TPHSOT, _TPH, _NEOC, _EOC = 0x02, 0x04, 0x08, 0x10, 0x40, 0x100
_KNOWN = {SOT: _MH | _TPHSOT, COD: _MH | _TPH, COC: _MH | _TPH,
          RGN: _MH | _TPH, QCD: _MH | _TPH, QCC: _MH | _TPH,
          POC: _MH | _TPH, SIZ: _MHSIZ, TLM: _MH, PLM: _MH, PLT: _TPH,
          PPM: _MH, PPT: _TPH, SOP: 0, CRG: _MH, COM: _MH | _TPH,
          MCT: _MH | _TPH, CBD: _MH, CAP: _MH, CPF: _MH,
          MCC: _MH | _TPH, MCO: _MH | _TPH}
_UNKNOWN_STATES = _MH | _TPH


class J2kError(ValueError):
    """A codestream OpenJPEG refuses (PIL raises OSError for it)."""


class Tccp:
    """One component's coding and quantisation parameters in a tile."""

    def __init__(self):
        self.csty = 0
        self.numres = 0
        self.cblkw = self.cblkh = 0
        self.cblksty = 0
        self.qmfbid = 0
        self.prcw = [0] * MAXRLVLS
        self.prch = [0] * MAXRLVLS
        self.qntsty = 0
        self.numgbits = 0
        self.steps = [(0, 0)] * MAXBANDS  # (exponent, mantissa)
        self.roishift = 0

    def copy(self) -> "Tccp":
        t = Tccp.__new__(Tccp)
        t.__dict__.update(self.__dict__)
        t.prcw, t.prch, t.steps = list(self.prcw), list(self.prch), list(self.steps)
        return t


class Tcp:
    """A tile's coding parameters (the main header's defaults, then the
    tile-part headers' markers), its progressions and its data."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.prg = 0
        self.numlayers = 0
        self.mct = 0
        self.tccps = [Tccp() for _ in range(ncomp)]
        self.pocs: list = []  # (resno0, compno0, layno1, resno1, compno1, prg)
        self.ppt: dict = {}
        self.ppt_data = None
        self.parts = -1  # TPsot of the last part read
        self.nparts = 0  # TNsot, 0 while unknown
        self.data = None  # bytearray once a part's data was read

    def copy(self) -> "Tcp":
        t = Tcp.__new__(Tcp)
        t.__dict__.update(self.__dict__)
        t.tccps = [c.copy() for c in self.tccps]
        t.pocs, t.ppt = list(self.pocs), dict(self.ppt)
        return t


class Codestream:
    """The main header of a JPEG 2000 codestream starting at ``data[0]``
    (SOC); ``ihdr`` is a JP2 file's (width, height), which SIZ must
    match."""

    def __init__(self, data: bytes, ihdr=None):
        self.data = data
        self.ihdr = ihdr
        self.ppm_markers: dict = {}
        self.ppm = None  # bytearray of every PPM packet header, or None
        self.pos = 0
        if len(data) < 2 or self._u16() != SOC:
            raise J2kError("Expected a SOC marker")
        self.state = _MHSIZ
        self.tcp = None
        self.has = set()
        marker = self._u16()
        while marker != SOT:
            if marker < 0xFF00:
                raise J2kError(f"A marker ID was expected instead of {marker:#x}")
            if marker not in _KNOWN:
                marker = self._skip_unknown()
                if marker == SOT:
                    break
            self.has.add(marker)
            if not self.state & _KNOWN[marker]:
                raise J2kError("Marker is not compliant with its position")
            body = self._segment()
            self._handle(marker, body, self.tcp)
            marker = self._u16()
        for m, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if m not in self.has:
                raise J2kError(f"required {name} marker not found in main header")
        self.ppm = _merge_ppm(self.ppm_markers) if self.ppm_markers else None
        self.state = _TPHSOT
        self.tcps = [self.tcp.copy() for _ in range(self.tw * self.th)]
        self.tileno = 0
        self.sot_length = 0
        self.last_part = False

    # -------------------------- reading bytes --------------------------

    def _u16(self) -> int:
        if self.pos + 2 > len(self.data):
            raise J2kError("Stream too short")
        v = self.data[self.pos] << 8 | self.data[self.pos + 1]
        self.pos += 2
        return v

    def _segment(self) -> bytes:
        size = self._u16()
        if size < 2:
            raise J2kError("Invalid marker size")
        body = self.data[self.pos:self.pos + size - 2]
        if len(body) != size - 2:
            raise J2kError("Stream too short")
        self.pos += size - 2
        return body

    def _skip_unknown(self) -> int:
        while True:
            m = self._u16()
            if m >= 0xFF00:
                states = _KNOWN.get(m, _UNKNOWN_STATES)
                if not self.state & states:
                    raise J2kError("Marker is not compliant with its position")
                if m in _KNOWN:
                    return m

    # ------------------------------ markers -----------------------------

    def _handle(self, marker: int, body: bytes, tcp: Tcp):
        handler = {SIZ: self._siz, COD: self._cod, COC: self._coc,
                   QCD: self._qcd, QCC: self._qcc, RGN: self._rgn,
                   POC: self._poc, PPM: self._ppm, PPT: self._ppt,
                   TLM: _tlm, PLM: _plm, PLT: _plt, CRG: self._crg,
                   COM: _ignore, CAP: _ignore, CPF: _ignore, CBD: self._cbd,
                   MCT: _mct, MCC: _part2, MCO: _part2}[marker]
        handler(body, tcp)

    def _siz(self, b: bytes, _tcp):
        if len(b) < 36 or (len(b) - 36) % 3:
            raise J2kError("Error with SIZ marker size")
        (self.rsiz, self.x1, self.y1, self.x0, self.y0, self.tdx, self.tdy,
         self.tx0, self.ty0, n) = struct.unpack_from(">HIIIIIIIIH", b)
        if n >= 16385 or n != (len(b) - 36) // 3:
            raise J2kError("Error with SIZ marker: number of components")
        if self.x0 >= self.x1 or self.y0 >= self.y1:
            raise J2kError("Error with SIZ marker: negative or zero image size")
        if self.tdx == 0 or self.tdy == 0:
            raise J2kError("Error with SIZ marker: invalid tile size")
        if (self.tx0 > self.x0 or self.ty0 > self.y0
                or min(self.tx0 + self.tdx, 0xFFFFFFFF) <= self.x0
                or min(self.ty0 + self.tdy, 0xFFFFFFFF) <= self.y0):
            raise J2kError("Error with SIZ marker: illegal tile offset")
        if self.ihdr is not None and self.ihdr != (self.x1 - self.x0,
                                                   self.y1 - self.y0):
            raise J2kError("Error with SIZ marker: IHDR size vs. SIZ size")
        self.comps = []
        for i in range(n):
            s, dx, dy = b[36 + 3 * i:39 + 3 * i]
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise J2kError("Invalid subsampling values")
            prec = (s & 0x7F) + 1
            if prec > 31:
                raise J2kError(f"Invalid precision {prec}: OpenJPEG reads up to 31")
            self.comps.append((prec, s >> 7, dx, dy))
        self.tw = -(-(self.x1 - self.tx0) // self.tdx)
        self.th = -(-(self.y1 - self.ty0) // self.tdy)
        if self.tw == 0 or self.th == 0 or self.tw > 65535 // self.th:
            raise J2kError("Invalid number of tiles")
        self.tcp = Tcp(n)
        self.state = _MH

    def _spcod(self, tccp: Tccp, b: bytes) -> int:
        if len(b) < 5:
            raise J2kError("Error reading SPCod SPCoc element")
        numres = b[0] + 1
        if numres > MAXRLVLS:
            raise J2kError("Invalid value for numresolutions")
        tccp.numres = numres
        tccp.cblkw, tccp.cblkh = b[1] + 2, b[2] + 2
        if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
            raise J2kError("Invalid cblkw/cblkh combination")
        tccp.cblksty = b[3]
        if tccp.cblksty & HTMIXED:
            raise J2kError("Unsupported Mixed HT code-block style")
        tccp.qmfbid = b[4]
        if tccp.qmfbid > 1:
            raise J2kError("Invalid transformation found")
        used = 5
        if tccp.csty & 1:
            if len(b) - 5 < numres:
                raise J2kError("Error reading SPCod SPCoc element")
            for i in range(numres):
                v = b[5 + i]
                if i and (not v & 0xF or not v >> 4):
                    raise J2kError("Invalid precinct size")
                tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
            used += numres
        else:
            for i in range(numres):
                tccp.prcw[i] = tccp.prch[i] = 15
        return used

    def _cod(self, b: bytes, tcp: Tcp):
        if len(b) < 5:
            raise J2kError("Error reading COD marker")
        tcp.csty = b[0]
        if tcp.csty & ~0x07:
            raise J2kError("Unknown Scod value in COD marker")
        tcp.prg = b[1] if b[1] <= 4 else -1
        tcp.numlayers = b[2] << 8 | b[3]
        if tcp.numlayers < 1:
            raise J2kError("Invalid number of layers in COD marker")
        tcp.mct = b[4]
        if tcp.mct > 1:
            raise J2kError("Invalid multiple component transformation")
        for t in tcp.tccps:
            t.csty = tcp.csty & 1
        if self._spcod(tcp.tccps[0], b[5:]) != len(b) - 5:
            raise J2kError("Error reading COD marker")
        ref = tcp.tccps[0]
        for t in tcp.tccps[1:]:
            t.numres, t.cblkw, t.cblkh = ref.numres, ref.cblkw, ref.cblkh
            t.cblksty, t.qmfbid = ref.cblksty, ref.qmfbid
            t.prcw[:ref.numres] = ref.prcw[:ref.numres]
            t.prch[:ref.numres] = ref.prch[:ref.numres]

    def _compno(self, b: bytes, what: str):
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) < room:
            raise J2kError(f"Error reading {what} marker")
        c = b[0] if room == 1 else b[0] << 8 | b[1]
        if c >= len(self.comps):
            raise J2kError(f"Error reading {what} marker (bad component)")
        return c, b[room:]

    def _coc(self, b: bytes, tcp: Tcp):
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) < room + 1:
            raise J2kError("Error reading COC marker")
        c, rest = self._compno(b, "COC")
        tcp.tccps[c].csty = rest[0]
        if self._spcod(tcp.tccps[c], rest[1:]) != len(rest) - 1:
            raise J2kError("Error reading COC marker")

    def _sqcd(self, tccp: Tccp, b: bytes):
        if len(b) < 1:
            raise J2kError("Error reading SQcd or SQcc element")
        tccp.qntsty, tccp.numgbits = b[0] & 0x1F, b[0] >> 5
        rest = len(b) - 1
        if tccp.qntsty == 1:
            nb = 1
        else:
            nb = rest if tccp.qntsty == 0 else rest // 2
        steps = list(tccp.steps)
        for i in range(nb):
            if tccp.qntsty == 0:
                v = b[1 + i] if 1 + i < len(b) else 0
                e, m = v >> 3, 0
            else:
                v = (b[1 + 2 * i] << 8 | b[2 + 2 * i]) if 2 + 2 * i < len(b) else 0
                e, m = v >> 11, v & 0x7FF
            if i < MAXBANDS:
                steps[i] = (e, m)
        need = nb if tccp.qntsty == 0 else 2 * nb
        if rest < need:
            raise J2kError("Error reading SQcd or SQcc element")
        if tccp.qntsty == 1:
            e0, m0 = steps[0]
            for i in range(1, MAXBANDS):
                steps[i] = (max(e0 - (i - 1) // 3, 0), m0)
        tccp.steps = steps
        return rest - need

    def _qcd(self, b: bytes, tcp: Tcp):
        if self._sqcd(tcp.tccps[0], b):
            raise J2kError("Error reading QCD marker")
        ref = tcp.tccps[0]
        for t in tcp.tccps[1:]:
            t.qntsty, t.numgbits, t.steps = ref.qntsty, ref.numgbits, list(ref.steps)

    def _qcc(self, b: bytes, tcp: Tcp):
        c, rest = self._compno(b, "QCC")
        if self._sqcd(tcp.tccps[c], rest):
            raise J2kError("Error reading QCC marker")

    def _rgn(self, b: bytes, tcp: Tcp):
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) != 2 + room:
            raise J2kError("Error reading RGN marker")
        c = b[0] if room == 1 else b[0] << 8 | b[1]
        if c >= len(self.comps):
            raise J2kError("bad component number in RGN")
        tcp.tccps[c].roishift = b[room + 1]

    def _poc(self, b: bytes, tcp: Tcp):
        room = 1 if len(self.comps) <= 256 else 2
        chunk = 5 + 2 * room
        n = len(b) // chunk
        if n <= 0 or len(b) % chunk:
            raise J2kError("Error reading POC marker")
        if len(tcp.pocs) + n >= 32:
            raise J2kError("Too many POCs")
        for i in range(n):
            p = b[i * chunk:(i + 1) * chunk]
            r0 = p[0]
            c0 = p[1] if room == 1 else p[1] << 8 | p[2]
            q = 1 + room
            l1 = min(p[q] << 8 | p[q + 1], tcp.numlayers)
            r1 = p[q + 2]
            c1 = p[q + 3] if room == 1 else p[q + 3] << 8 | p[q + 4]
            prg = p[q + 3 + room]
            tcp.pocs.append((r0, c0, l1, r1, min(c1, len(self.comps)), prg))

    def _ppm(self, b: bytes, _tcp):
        if len(b) < 2:
            raise J2kError("Error reading PPM marker")
        if b[0] in self.ppm_markers:
            raise J2kError(f"Zppm {b[0]} already read")
        self.ppm_markers[b[0]] = b[1:]

    def _ppt(self, b: bytes, tcp: Tcp):
        if len(b) < 2:
            raise J2kError("Error reading PPT marker")
        if self.ppm_markers:
            raise J2kError("PPT marker after a PPM marker")
        if b[0] in tcp.ppt:
            raise J2kError(f"Zppt {b[0]} already read")
        tcp.ppt[b[0]] = b[1:]

    def _cbd(self, b: bytes, _tcp):
        """Part 2's component bit depths: each component's precision and
        signedness replaced (j2k.c opj_j2k_read_cbd)."""
        n = len(self.comps)
        if len(b) != n + 2 or (b[0] << 8 | b[1]) != n:
            raise J2kError("Error reading CBD marker")
        for i in range(n):
            prec = (b[2 + i] & 0x7F) + 1
            if prec > 31:
                raise J2kError(f"Invalid precision {prec} in CBD")
            self.comps[i] = (prec, b[2 + i] >> 7) + self.comps[i][2:]

    def _crg(self, b: bytes, _tcp):
        if len(b) != 4 * len(self.comps):
            raise J2kError("Error reading CRG marker")

    # ------------------------------- tiles ------------------------------

    def tiles(self):
        """Yield (tile number, Tcp, data) for each tile OpenJPEG decodes,
        in its order (j2k.c opj_j2k_read_tile_header, then the end of
        opj_j2k_decode_tile once the caller has decoded the tile)."""
        while True:
            if self.state == _EOC:
                marker = EOC
            elif self.state != _TPHSOT:
                # the stream ended without EOC after a tile: PIL's next
                # opj_read_tile_header fails
                raise J2kError("Stream does not end with EOC")
            else:
                marker = SOT
            can_decode = False
            while not can_decode and marker != EOC:
                while marker != SOD:
                    if self.pos >= len(self.data):
                        self.state = _NEOC
                        break
                    size = self._u16()
                    if size < 2:
                        raise J2kError("Inconsistent marker size")
                    if self.state & _TPH and self.sot_length:
                        if self.sot_length < size + 2:
                            raise J2kError("Sot length is less than marker "
                                           "size + marker ID")
                        self.sot_length -= size + 2
                    if not self.state & _KNOWN.get(marker, _UNKNOWN_STATES):
                        raise J2kError("Marker is not compliant with its "
                                       "position")
                    body = self.data[self.pos:self.pos + size - 2]
                    if len(body) != size - 2:
                        raise J2kError("Stream too short")
                    self.pos += size - 2
                    if marker not in _KNOWN:
                        raise J2kError(f"Unknown marker {marker:#x} in a "
                                       "tile-part header")
                    if marker == SOT:
                        can_decode = self._sot(body)
                    else:
                        self._handle(marker, body, self.tcps[self.tileno])
                    marker = self._u16()
                if self.state == _NEOC and self.pos >= len(self.data):
                    break
                self._sod()
                if not can_decode:
                    if self.pos + 2 > len(self.data):
                        last = self._spot6_tile()
                        if last is None:
                            raise J2kError("Stream too short")
                        self.tileno, marker, self.state = last, EOC, _EOC
                        break
                    marker = self._u16()
            if marker == EOC and self.state != _EOC:
                self.tileno, self.state = 0, _EOC
            if not can_decode:
                while (self.tileno < len(self.tcps)
                       and self.tcps[self.tileno].data is None):
                    self.tileno += 1
                if self.tileno == len(self.tcps):
                    return
            tcp = self.tcps[self.tileno]
            if tcp.data is None:
                raise J2kError("tile without data")
            if tcp.ppt:
                tcp.ppt_data = bytearray(b"".join(
                    tcp.ppt[k] for k in sorted(tcp.ppt)))
            yield self.tileno, tcp, bytes(tcp.data)
            tcp.data = None
            if self.state == _NEOC and self.pos >= len(self.data):
                continue
            if self.state != _EOC:
                if self.pos + 2 > len(self.data):
                    raise J2kError("Stream too short")
                nxt = self._u16()
                if nxt == EOC:
                    self.tileno, self.state = 0, _EOC
                elif nxt != SOT:
                    if self.pos >= len(self.data):
                        self.state = _NEOC
                        continue
                    raise J2kError("Stream too short, expected SOT")

    def _spot6_tile(self):
        """The tile OpenJPEG decodes when the stream stops after the last
        tile's part: the first one read as part 0 of an unknown count."""
        if self.tileno + 1 != len(self.tcps):
            return None
        for i, t in enumerate(self.tcps):
            if t.parts == 0 and t.nparts == 0:
                return i
        return None

    def _sot(self, b: bytes) -> bool:
        if len(b) != 8:
            raise J2kError("Error reading SOT marker")
        tileno, psot, part, nparts = struct.unpack(">HIBB", b)
        if tileno >= len(self.tcps):
            raise J2kError(f"Invalid tile number {tileno}")
        self.tileno = tileno
        tcp = self.tcps[tileno]
        if tcp.parts + 1 != part:
            raise J2kError(f"Invalid tile part index for tile number {tileno}")
        tcp.parts += 1
        if psot and psot < 14:
            if psot != 12:
                raise J2kError(f"Psot value is not correct: {psot}")
        self.last_part = psot == 0
        if tcp.nparts and part >= tcp.nparts:
            raise J2kError("In SOT marker, TPSot is not valid")
        if nparts:
            if part >= nparts:
                raise J2kError("In SOT marker, TPSot is not valid")
            tcp.nparts = nparts
        can_decode = bool(tcp.nparts) and tcp.nparts == part + 1
        self.sot_length = 0 if self.last_part else psot - 12
        self.state = _TPH
        return can_decode

    def _sod(self):
        tcp = self.tcps[self.tileno]
        left = len(self.data) - self.pos
        if self.last_part:
            self.sot_length = (left - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        n = self.sot_length
        if n > left:
            raise J2kError("Tile part length size inconsistent with stream "
                           "length")
        if n and tcp.data is None:
            tcp.data = bytearray()
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        if n:
            tcp.data += chunk
        self.state = _TPHSOT


def _merge_ppm(markers: dict) -> bytearray:
    """Every Ippm byte of the PPM segments in Zppm order, without the
    Nppm lengths (j2k.c opj_j2k_merge_ppm)."""
    out = bytearray()
    remaining = 0
    for z in sorted(markers):
        d = markers[z]
        pos = 0
        if remaining >= len(d):
            remaining -= len(d)
            out += d
            continue
        out += d[:remaining]
        pos, remaining = remaining, 0
        while pos < len(d):
            if len(d) - pos < 4:
                raise J2kError("Not enough bytes to read Nppm")
            (n,) = struct.unpack_from(">I", d, pos)
            pos += 4
            if len(d) - pos >= n:
                out += d[pos:pos + n]
                pos += n
            else:
                out += d[pos:]
                remaining = n - (len(d) - pos)
                pos = len(d)
    if remaining:
        raise J2kError("Corrupted PPM markers")
    return out


def _tlm(b: bytes, _tcp):
    if len(b) < 2:
        raise J2kError("Error reading TLM marker")
    st, sp = (b[1] >> 4) & 3, (b[1] >> 6) & 1
    if st == 3 or (len(b) - 2) % ((sp + 1) * 2 + st):
        raise J2kError("Error reading TLM marker")


def _plm(b: bytes, _tcp):
    if len(b) < 1:
        raise J2kError("Error reading PLM marker")


def _plt(b: bytes, _tcp):
    if len(b) < 1:
        raise J2kError("Error reading PLT marker")
    if b[-1] & 0x80 and len(b) > 1:
        raise J2kError("Error reading PLT marker")


def _ignore(_b, _tcp):
    pass


def _mct(b: bytes, _tcp):
    """Part 2's MCT segment: checked as j2k.c reads it, then unused (COD's
    MCT field takes 0 or 1 only, so no array transform can apply)."""
    if len(b) < 2:
        raise J2kError("Error reading MCT marker")
    if b[0] << 8 | b[1]:
        return  # "multiple MCT records": ignored
    if len(b) <= 6:
        raise J2kError("Error reading MCT marker")


def _part2(_b, _tcp):
    raise J2kError("JPEG 2000 Part 2 MCC / MCO markers are not read by "
                   "the port")
