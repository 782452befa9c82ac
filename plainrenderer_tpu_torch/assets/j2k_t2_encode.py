"""JPEG 2000 tier-2 encoding (T.800 Annex B), as OpenJPEG 2.5.4's t2.c,
tgt.c and bio.c write the packets of a tile with one quality layer that
holds every coding pass of every code-block.

A packet (one layer, resolution, component and precinct, in
j2k_t2.packet_order's progression) is its header, then the included
code-blocks' bytes in header order. The header is bits written MSB first
(opj_bio: a byte after a 0xFF byte holds 7 bits; the flush writes the
byte in progress, and a 0x00 after it if it was 0xFF):

  - the non-empty bit, always 1 (OpenJPEG leaves its empty-packet
    optimisation disabled);
  - for each sub-band of the resolution that is not empty, for each
    code-block of the precinct in raster order: inclusion through the
    precinct's inclusion tag tree (the layer a code-block is first
    included in; a code-block without passes is never included), then
    for an included one its zero bit-planes through the second tag tree
    (the band's Mb minus the code-block's numbps, set for every
    code-block of the precinct, included or not), the number of passes
    (1, 2, 3-5, 6-36, 37-164 in 1, 2, 4, 9 and 16 bits), the Lblock
    increment as a comma code and the length of its one codeword segment
    in Lblock + floor(log2(passes)) bits, Lblock starting at 3.

Tag trees are j2k_t2.TagTree's (tgt.c's node order), encoded as
opj_tgt_encode does: each node from the root down to the leaf sends
zeros until its value or the threshold, and a one the first time its
value is reached."""

from __future__ import annotations

from .j2k_t2 import TagTree, packet_order


class BitWriter:
    """bio.c's bit writer."""

    __slots__ = ("out", "buf", "ct")

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def bit(self, b: int):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= b << self.ct

    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class TagTreeEncoder:
    """tgt.c's tag tree, for encoding: setvalue lowers a leaf and its
    ancestors to a value, encode sends a leaf against a threshold."""

    def __init__(self, w: int, h: int):
        self.parent = TagTree(w, h).parent
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n
        self.known = [False] * n

    def set_value(self, leaf: int, value: int):
        node = leaf
        while node >= 0 and self.value[node] > value:
            self.value[node] = value
            node = self.parent[node]

    def encode(self, bw: BitWriter, leaf: int, threshold: int):
        path = []
        node = leaf
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.bit(1)
                        self.known[node] = True
                    break
                bw.bit(0)
                low += 1
            self.low[node] = low


def _floorlog2(v: int) -> int:
    return max(v.bit_length() - 1, 0)


def _numpasses(bw: BitWriter, n: int):
    if n == 1:
        bw.write(0, 1)
    elif n == 2:
        bw.write(2, 2)
    elif n <= 5:
        bw.write(0xC | (n - 3), 4)
    elif n <= 36:
        bw.write(0x1E0 | (n - 6), 9)
    else:
        bw.write(0xFF80 | (n - 37), 16)


def encode_packet(bands, precno: int) -> bytes:
    """The first-layer packet of precinct ``precno`` over ``bands`` (a
    resolution's sub-bands), each code-block holding its bytes
    (``chunks``), ``numbps`` and passes (``newpasses``)."""
    bw = BitWriter()
    bw.bit(1)
    body = []
    for b in bands:
        if b.x1 == b.x0 or b.y1 == b.y0:
            continue
        pr = b.precincts[precno]
        incl = TagTreeEncoder(pr.cw, pr.ch)
        imsb = TagTreeEncoder(pr.cw, pr.ch)
        for cbno, cb in enumerate(pr.cblks):
            imsb.set_value(cbno, b.numbps - cb.numbps)
            if cb.newpasses:
                incl.set_value(cbno, 0)
        for cbno, cb in enumerate(pr.cblks):
            incl.encode(bw, cbno, 1)
            passes = cb.newpasses
            if not passes:
                continue
            (data,) = cb.chunks
            imsb.encode(bw, cbno, 999)
            _numpasses(bw, passes)
            lenbits = 3
            extra = _floorlog2(passes)
            inc = max(0, _floorlog2(len(data)) + 1 - (lenbits + extra))
            bw.write((1 << (inc + 1)) - 2, inc + 1)  # comma code
            bw.write(len(data), lenbits + inc + extra)
            body.append(data)
    return bw.flush() + b"".join(body)


def encode_tile_packets(tcp, comps, tile) -> bytes:
    """Every packet of the tile in its progression order."""
    return b"".join(encode_packet(comps[compno].res[resno].bands, precno)
                    for _layno, resno, compno, precno
                    in packet_order(tcp, comps, tile))
