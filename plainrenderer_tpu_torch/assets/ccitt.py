"""CCITT bilevel decoding for TIFF compression 2 (Modified Huffman, byte-
aligned rows without EOLs), 3 (T.4 / Group 3: EOL-synchronised rows, 1-D,
or 2-D when T4Options bit 0 is set, each row then tagged 1-D or 2-D) and
4 (T.6 / Group 4: 2-D rows against the previous one, no EOLs), as
libtiff's tif_fax3.c decodes them for PIL.

The decoder is libtiff's state machine, step for step, over the same
tables (tif_fax3sm.c as mkg3states builds them: a 7-bit lookup for the
2-D modes, 12 bits for white runs, 13 for black, where a window that
starts no code is a zero-width null entry). Its behaviour on bad data is
libtiff 4.7's too: a bad code ends the row, which CLEANUP_RUNS pads or
cuts to the row's width; past the data's end the bit reader pads with
zeros while any real bit is left and is at its end only once none is; a
premature end is an error; a row with more changes than libtiff's run
buffers hold is an error; a Group 4 EOFB (or end of data) after a
strip's first row ends the strip, its later rows left as they were (0
here; libtiff leaves PIL's buffer unwritten there); a Group 3 strip whose
data ends while an EOL is sought is decoded again from its first bit
without EOLs, the current row first, and so are the image's later
strips. Bits come most significant first (the TIFF
reader reverses FillOrder 2 data beforehand); a black run's pixels are
1, which PhotometricInterpretation then reads (0 WhiteIsZero, 1
BlackIsZero).
"""

from __future__ import annotations

import numpy as np

(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
_EOL = "00000000000"  # 11 zeros: SYNC_EOL consumes the EOL's 1 bit
# the 2-D mode codes: (code, state, parameter)
_MAIN = (("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
         ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
         ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
         ("0000001", S_EXT, 0), ("0000000", S_EOL, 0))


def _fill(table, size, code, state, param):
    """mkg3states FillTable: the code read least significant bit first,
    every window of `size` bits that starts with it."""
    value = sum(1 << i for i, b in enumerate(code) if b == "1")
    width = len(code)
    for v in range(value, 1 << size, 1 << width):
        table[v] = (state, width, param)


def _tables():
    main = [(S_NULL, 0, 0)] * 128
    white = [(S_NULL, 0, 0)] * 4096
    black = [(S_NULL, 0, 0)] * 8192
    for code, state, param in _MAIN:
        _fill(main, 7, code, state, param)
    for table, size, term, makeup, s_term, s_makeup in (
            (white, 12, _WHITE_TERM, _WHITE_MAKEUP, S_TERMW, S_MAKEUPW),
            (black, 13, _BLACK_TERM, _BLACK_MAKEUP, S_TERMB, S_MAKEUPB)):
        for k, code in enumerate(makeup.split()):
            _fill(table, size, code, s_makeup, 64 * (k + 1))
        for k, code in enumerate(_EXT_MAKEUP.split()):
            _fill(table, size, code, S_MAKEUP, 1792 + 64 * k)
        for k, code in enumerate(term.split()):
            _fill(table, size, code, s_term, k)
        _fill(table, size, _EOL, S_EOL, 0)
    return main, white, black


_MAINT, _WHITET, _BLACKT = _tables()
_M32 = 0xFFFFFFFF


def _i32(v):
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


class _EOF(Exception):
    """A premature end of the data (libtiff's eoflab)."""


class _NoEOL(Exception):
    """SYNC_EOL ran out of data past an EOL's zeros (libtiff: "try to
    decode fax Group 3 data without EOL")."""


class _Overflow(Exception):
    """More changes in a row than libtiff's run buffer holds."""


class _State:
    """tif_fax3.h's decoder state: the bit accumulator (least significant
    bit first over bit-reversed bytes) and the run buffers."""

    def __init__(self, data: bytes, width: int, two_d: bool):
        self.data = data
        self.n = len(data)
        self.cp = 0
        self.acc = 0
        self.avail = 0
        self.eolcnt = 0
        self.lastx = width
        nruns = -(-(width + 1) // 32) * 32
        self.nruns = nruns * 2 if two_d else nruns
        self.buf = [[0] * self.nruns, [0] * self.nruns]
        self.cur, self.ref = 0, 1
        self.buf[1][0], self.buf[1][1] = width, 0

    def need(self, n):
        """NeedBits8 / NeedBits16."""
        if self.avail < n:
            if self.cp >= self.n:
                if self.avail == 0:
                    raise _EOF
                self.avail = n
            else:
                self.acc |= _REV[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= self.n:
                        self.avail = n
                    else:
                        self.acc |= _REV[self.data[self.cp]] << self.avail
                        self.cp += 1
                        self.avail += 8

    def get(self, n):
        return self.acc & ((1 << n) - 1)

    def clr(self, n):
        self.avail -= n
        self.acc >>= n

    def lookup(self, n, table):
        self.need(n)
        e = table[self.acc & ((1 << n) - 1)]
        self.clr(e[1])
        return e


_REV = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


class _Row:
    """One row's run list being built (pa, a0, RunLength)."""

    def __init__(self, st: _State):
        self.st = st
        self.runs = st.buf[st.cur]
        self.pa = 0
        self.a0 = 0
        self.run_length = 0

    def setvalue(self, x):
        if self.pa >= self.st.nruns:
            raise _Overflow
        self.runs[self.pa] = (self.run_length + x) & _M32
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run_length = 0

    def cleanup(self):
        """CLEANUP_RUNS."""
        lastx = self.st.lastx
        if self.run_length:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.pa])
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)


def _expand1d(st: _State, row: _Row):
    """EXPAND1D: white and black runs until the row's width; a bad code
    or an EOL ends the row."""
    lastx = st.lastx
    try:
        while True:
            for table, n, term in ((_WHITET, 12, S_TERMW),
                                   (_BLACKT, 13, S_TERMB)):
                while True:
                    state, _, param = st.lookup(n, table)
                    if state == S_EOL:
                        st.eolcnt = 1
                        row.cleanup()
                        return
                    if state == term:
                        row.setvalue(param)
                        break
                    if state in (S_MAKEUPW, S_MAKEUPB, S_MAKEUP):
                        row.a0 = _i32(row.a0 + param)
                        row.run_length += param
                        continue
                    row.cleanup()  # unexpected: a bad code
                    return
                if row.a0 >= lastx:
                    row.cleanup()
                    return
            if row.pa >= 2 and row.runs[row.pa - 1] == 0 and \
                    row.runs[row.pa - 2] == 0:
                row.pa -= 2
    except _EOF:
        row.cleanup()
        raise


def _check_b1(st, row, ref, pb, b1):
    if row.pa != 0:
        while b1 <= row.a0 and b1 < st.lastx:
            if pb + 1 >= st.nruns:
                raise _Overflow
            b1 = _i32(b1 + ref[pb] + ref[pb + 1])
            pb += 2
    return pb, b1


def _expand2d(st: _State, row: _Row):
    """EXPAND2D against the reference row."""
    lastx = st.lastx
    ref = st.buf[st.ref]
    pb, b1 = 1, _i32(ref[0])
    try:
        while row.a0 < lastx:
            if row.pa >= st.nruns:
                raise _Overflow
            state, _, param = st.lookup(7, _MAINT)
            if state == S_PASS:
                pb, b1 = _check_b1(st, row, ref, pb, b1)
                if pb >= st.nruns:
                    raise _Overflow
                b1 = _i32(b1 + ref[pb])
                pb += 1
                row.run_length += b1 - row.a0
                row.a0 = b1
                b1 = _i32(b1 + ref[pb])
                pb += 1
            elif state == S_HORIZ:
                order = ((_BLACKT, 13, S_TERMB, S_MAKEUPB),
                         (_WHITET, 12, S_TERMW, S_MAKEUPW))
                if not row.pa & 1:
                    order = order[::-1]
                for table, n, term, makeup in order:
                    while True:
                        s, _, p = st.lookup(n, table)
                        if s == term:
                            row.setvalue(p)
                            break
                        if s in (makeup, S_MAKEUP):
                            row.a0 = _i32(row.a0 + p)
                            row.run_length += p
                            continue
                        row.cleanup()  # unexpected: a bad run code
                        return
                pb, b1 = _check_b1(st, row, ref, pb, b1)
            elif state in (S_V0, S_VR):
                pb, b1 = _check_b1(st, row, ref, pb, b1)
                row.setvalue(b1 - row.a0 + (param if state == S_VR else 0))
                if pb >= st.nruns:
                    raise _Overflow
                b1 = _i32(b1 + ref[pb])
                pb += 1
            elif state == S_VL:
                pb, b1 = _check_b1(st, row, ref, pb, b1)
                if b1 < row.a0 + param:
                    row.cleanup()  # unexpected
                    return
                row.setvalue(b1 - row.a0 - param)
                pb -= 1
                b1 = _i32(b1 - ref[pb])
            elif state == S_EXT:
                row.runs[row.pa] = (lastx - row.a0) & _M32
                row.pa += 1
                row.cleanup()  # uncompressed mode is not supported
                return
            elif state == S_EOL:
                row.runs[row.pa] = (lastx - row.a0) & _M32
                row.pa += 1
                st.need(4)
                st.clr(4)
                st.eolcnt = 1
                row.cleanup()
                return
            else:
                row.cleanup()  # unexpected: a bad mode code
                return
        if row.run_length:
            if row.run_length + row.a0 < lastx:
                st.need(1)  # expect a final V0
                if not st.get(1):
                    row.cleanup()
                    return
                st.clr(1)
            row.setvalue(0)
        row.cleanup()
    except _EOF:
        row.cleanup()
        raise


def _sync_eol(st: _State):
    """SYNC_EOL: find the EOL (11 zeros, then skip zero bytes and zeros,
    then its 1 bit)."""
    if st.eolcnt == 0:
        while True:
            st.need(11)
            if st.get(11) == 0:
                break
            st.clr(1)
    while True:
        try:
            st.need(8)
        except _EOF:
            raise _NoEOL from None
        if st.get(8):
            break
        st.clr(8)
    while st.get(1) == 0:
        st.clr(1)
    st.clr(1)
    st.eolcnt = 0


def _fill_row(st: _State, row: _Row, out: np.ndarray):
    """_TIFFFax3fillruns: white runs 0, black runs 1, each clamped to the
    row's width (the clamp written back into the runs)."""
    runs, lastx = row.runs, st.lastx
    n = row.pa
    if n & 1 and n < len(runs):
        runs[n] = 0
        n += 1
    x = 0
    for k in range(n):
        run = runs[k]
        if x + run > lastx or run > lastx:
            run = runs[k] = (lastx - x) & _M32
        if run:
            if k & 1:
                out[x:x + run] = 1
            else:
                out[x:x + run] = 0
            x += run


def decode(data: bytes, comp: int, options: int, width: int, rows: int,
           where: str, image: dict | None = None) -> bytes:
    """One strip or tile of CCITT data (MSB-first bytes) -> `rows` rows
    of `width` 1-bit pixels, packed MSB first, each row byte-aligned.
    `image` carries libtiff's codec mode from one strip of an image to
    the next (FAXMODE_NOEOL, once a Group 3 strip set it)."""
    two_d = comp == 4 or (comp == 3 and options & 1)
    st = _State(data, width, two_d)
    st.noeol = bool(image and image.get("noeol"))
    out = np.zeros((rows, width), np.uint8)
    line = 0
    try:
        for line in range(rows):
            row = _Row(st)
            if comp == 2:
                _expand1d(st, row)
                st.clr(st.avail % 8)  # FAXMODE_BYTEALIGN
            elif comp == 3:
                if not st.noeol:
                    try:
                        _sync_eol(st)
                    except _NoEOL:
                        # FAXMODE_NOEOL from here on, this row decoded
                        # again from the strip's first bit
                        st.noeol = True
                        st.cp = st.acc = st.avail = 0
                if two_d:
                    st.need(1)
                    is_1d = st.get(1)  # the row's 1-D / 2-D tag bit
                    st.clr(1)
                    (_expand1d if is_1d else _expand2d)(st, row)
                else:
                    _expand1d(st, row)
            else:
                _expand2d(st, row)
                if st.eolcnt:  # EOFB: the strip ends with this row
                    _fill_row(st, row, out[line])
                    if line == 0:
                        raise ValueError(f"TIFF CCITT Group 4 strip ends "
                                         f"at its first row: {where}")
                    break
            _fill_row(st, row, out[line])
            if two_d:
                if comp == 4 or row.pa < st.nruns:
                    row.setvalue(0)  # the imaginary change for reference
                st.cur, st.ref = st.ref, st.cur
    except _EOF:
        if comp != 4 or line == 0:
            raise ValueError(f"TIFF CCITT data ends before row {line + 1} "
                             f"of {rows} (premature EOF): {where}") from None
        _fill_row(st, row, out[line])  # Fax4Decode: a badly ended strip
    except _Overflow:
        raise ValueError(f"TIFF CCITT row {line + 1} overflows libtiff's "
                         f"run buffer: {where}") from None
    finally:
        if image is not None:
            image["noeol"] = st.noeol
    return np.packbits(out, axis=1).tobytes()
