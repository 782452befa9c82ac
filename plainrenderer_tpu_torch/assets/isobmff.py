"""ISO base media file format boxes for AVIF (ISO/IEC 14496-12 and 23008-12,
HEIF): the top-level boxes, the item boxes under 'meta' (hdlr, pitm, iloc
versions 0-2 with idat, iinf / infe, iref, iprp / ipco / ipma and the
properties AVIF uses) and the 'moov' boxes that locate a track's first
sample.

Parsing follows libavif 1.3.0's reader (src/read.c) where it decides what a
file is: a box that runs past its parent, a truncated field or a duplicate
unique box raises ``BoxError``; assets/avif.py turns that into the refusal
PIL reports.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


class BoxError(ValueError):
    """A malformed or truncated box (libavif's BMFF_PARSE_FAILED or
    TRUNCATED_DATA)."""


class Reader:
    """Big-endian fields over data[pos:end]; reading past end raises."""

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def left(self) -> int:
        return self.end - self.pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise BoxError("truncated box field")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, nbytes: int) -> int:
        if nbytes == 0:
            return 0
        return int.from_bytes(self.take(nbytes), "big")

    def u8(self) -> int:
        return self.u(1)

    def u16(self) -> int:
        return self.u(2)

    def u32(self) -> int:
        return self.u(4)

    def fourcc(self) -> bytes:
        return self.take(4)

    def full(self, versions=None) -> tuple[int, int]:
        """A full box's version and flags; a version outside `versions`
        raises (libavif's avifROStreamReadAndEnforceVersion)."""
        v = self.u32()
        if versions is not None and v >> 24 not in versions:
            raise BoxError(f"box version {v >> 24}")
        return v >> 24, v & 0xFFFFFF

    def cstring(self) -> bytes:
        i = self.data.find(b"\0", self.pos, self.end)
        if i < 0:
            raise BoxError("unterminated string")
        out = self.data[self.pos:i]
        self.pos = i + 1
        return out


def boxes(data: bytes, pos: int, end: int, top: bool = False):
    """(type, body start, body end) of each box in data[pos:end]. A size of
    0 runs to the end (at the top level only)."""
    while pos < end:
        if end - pos < 8:
            raise BoxError("truncated box header")
        size, typ = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if end - pos < 16:
                raise BoxError("truncated box header")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            if not top:
                raise BoxError("box of size 0 inside a box")
            size = end - pos
        if typ == b"uuid":
            head += 16
        if size < head or pos + size > end:
            raise BoxError(f"box {typ!r} runs past its parent")
        yield typ, pos + head, pos + size
        pos += size


@dataclass
class Item:
    id: int
    type: bytes = b""
    method: int = 0
    base: int = 0
    extents: list = field(default_factory=list)
    props: list = field(default_factory=list)   # (property, essential)
    refs: dict = field(default_factory=dict)    # ref type -> [to ids]
    has_iloc: bool = False

    def prop(self, kind: bytes):
        for p, _ in self.props:
            if p.kind == kind:
                return p
        return None


@dataclass
class Prop:
    kind: bytes
    fields: dict


@dataclass
class Track:
    id: int = 0
    sample_entry: bytes = b""
    refs: dict = field(default_factory=dict)
    chunk_offsets: list = field(default_factory=list)
    sample_sizes: list = field(default_factory=list)
    sample_size: int = 0      # stsz's one size for every sample, or 0
    stsc: list = field(default_factory=list)
    props: list = field(default_factory=list)
    width: int = 0
    height: int = 0
    timescale: int = 0        # mdhd's; 0 where there is none

    def first_sample(self, file_size: int) -> tuple[int, int]:
        """The first sample's (offset, size), once every sample is placed
        as libavif's avifCodecDecodeInputFillFromSampleTable places them:
        a chunk of no samples (by stsc: the last entry starting at or
        before it), a sample stsz does not size, or one past the file's
        end fails."""
        if not self.chunk_offsets or not self.stsc or not (
                self.sample_size or self.sample_sizes):
            raise BoxError("track has no samples")
        k = 0
        for c, off in enumerate(self.chunk_offsets, 1):
            n = next((n for first, n, _ in reversed(self.stsc)
                      if first <= c), 0)
            if not n:
                raise BoxError(f"track chunk {c} has no samples")
            for _ in range(n):
                if not self.sample_size and k >= len(self.sample_sizes):
                    raise BoxError("track sample table truncated")
                size = self.sample_size or self.sample_sizes[k]
                if off > file_size or size > file_size - off:
                    raise BoxError("track sample runs past the file")
                off += size
                k += 1
        return self.chunk_offsets[0], self.sample_size or self.sample_sizes[0]


@dataclass
class File:
    major: bytes
    brands: list
    items: dict
    primary: int | None
    idat: bytes
    tracks: list
    has_meta: bool


def _property(typ: bytes, data: bytes, s: int, e: int) -> Prop:
    r = Reader(data, s, e)
    f: dict = {}
    if typ == b"ispe":
        r.full((0,))
        f["width"], f["height"] = r.u32(), r.u32()
    elif typ == b"pixi":
        r.full((0,))
        n = r.u8()
        f["depths"] = list(r.take(n))
    elif typ == b"av1C":
        b = r.take(4)
        if b[0] != 0x81:
            raise BoxError("av1C marker or version")
        f.update(marker=b[0] >> 7, version=b[0] & 0x7F, profile=b[1] >> 5,
                 level=b[1] & 31, tier=b[2] >> 7, high_bitdepth=b[2] >> 6 & 1,
                 twelve_bit=b[2] >> 5 & 1, monochrome=b[2] >> 4 & 1,
                 ssx=b[2] >> 3 & 1, ssy=b[2] >> 2 & 1, csp=b[2] & 3)
        f["config_obus"] = data[r.pos:e]
    elif typ == b"colr":
        kind = r.fourcc()
        f["colour_type"] = kind
        if kind == b"nclx":
            f["primaries"], f["transfer"], f["matrix"] = r.u16(), r.u16(), r.u16()
            b = r.u8()
            if b & 0x7F:
                raise BoxError("colr nclx reserved bits")
            f["full_range"] = b >> 7
        elif kind in (b"rICC", b"prof"):
            f["icc"] = data[r.pos:e]
    elif typ in (b"auxC", b"auxi"):
        r.full((0,))
        f["aux_type"] = r.cstring()
    elif typ in (b"irot", b"imir"):
        b = r.u8()
        if b & (0xFC if typ == b"irot" else 0xFE):
            raise BoxError(f"{typ.decode()} reserved bits")
        f["angle" if typ == b"irot" else "axis"] = b
    elif typ == b"clap":
        f["values"] = [struct.unpack(">i", r.take(4))[0] for _ in range(8)]
    elif typ == b"a1op":
        f["op_index"] = r.u8()
    elif typ == b"lsel":
        f["layer_id"] = r.u16()
    elif typ == b"a1lx":
        flags = r.u8()
        n = 4 if flags & 1 else 2
        f["sizes"] = [r.u(n) for _ in range(3)]
    return Prop(typ, f)


def _iloc(data, s, e, items):
    r = Reader(data, s, e)
    version, _ = r.full()
    if version > 2:
        raise BoxError("unsupported iloc version")
    b = r.u8()
    offset_size, length_size = b >> 4, b & 15
    b = r.u8()
    base_size, index_size = b >> 4, (b & 15 if version in (1, 2) else 0)
    for n in (offset_size, length_size, base_size, index_size):
        if n not in (0, 4, 8):
            raise BoxError("bad iloc field size")
    count = r.u16() if version < 2 else r.u32()
    for _ in range(count):
        iid = r.u16() if version < 2 else r.u32()
        item = items.setdefault(iid, Item(iid))
        if item.has_iloc:
            raise BoxError("duplicate iloc entry")
        item.has_iloc = True
        if version in (1, 2):
            item.method = r.u16() & 15
            if item.method > 1:
                raise BoxError("unsupported construction method")
        r.u16()   # data_reference_index: libavif reads the file regardless
        item.base = r.u(base_size)
        for _ in range(r.u16()):
            if index_size:
                r.u(index_size)
            off, length = r.u(offset_size), r.u(length_size)
            item.extents.append((item.base + off, length))


def _iinf(data, s, e, items):
    r = Reader(data, s, e)
    version, _ = r.full((0, 1))
    count = r.u16() if version == 0 else r.u32()
    seen = 0
    for typ, bs, be in boxes(data, r.pos, e):
        if typ != b"infe":
            continue
        seen += 1
        q = Reader(data, bs, be)
        v, _ = q.full((2, 3))
        iid = q.u16() if v == 2 else q.u32()
        q.u16()  # protection index
        item = items.setdefault(iid, Item(iid))
        item.type = q.fourcc()
        q.cstring()   # item_name: libavif wants it terminated
    if seen != count:
        raise BoxError("iinf entry count")


def _iref(data, s, e, items):
    """libavif reads iref's child boxes as one stream: each header's size
    must fit what is left, but the next child starts where the references
    end, not where the size says. It ignores an iref of another version
    than 0 or 1."""
    r = Reader(data, s, e)
    version, _ = r.full()
    if version > 1:
        return
    w = 2 if version == 0 else 4
    while r.left():
        size, typ = r.u32(), r.fourcc()
        if size == 1:
            size = r.u(8) - 8
        if size != 0 and (size < 8 or size - 8 > r.left()):
            raise BoxError(f"iref child box {typ!r} too large")
        src = r.u(w)
        for _ in range(r.u16()):
            dst = r.u(w)
            if not src or not dst:
                raise BoxError("iref names item 0")
            items.setdefault(src, Item(src)).refs.setdefault(typ, []).append(dst)


def _iprp(data, s, e, items):
    props: list = []
    assoc = []
    for typ, bs, be in boxes(data, s, e):
        if typ == b"ipco":
            for ptyp, ps, pe in boxes(data, bs, be):
                props.append(_property(ptyp, data, ps, pe))
        elif typ == b"ipma":
            assoc.append((bs, be))
    for bs, be in assoc:
        r = Reader(data, bs, be)
        version, flags = r.full((0, 1))
        for _ in range(r.u32()):
            iid = r.u16() if version < 1 else r.u32()
            item = items.setdefault(iid, Item(iid))
            if item.props:
                raise BoxError("duplicate ipma entry")
            for _ in range(r.u8()):
                v = r.u16() if flags & 1 else r.u8()
                big = 15 if flags & 1 else 7
                essential, index = v >> big, v & ((1 << big) - 1)
                if index == 0:
                    if essential:
                        raise BoxError("ipma marks property 0 essential")
                    continue
                if index > len(props):
                    raise BoxError("ipma names a missing property")
                prop = props[index - 1]
                if prop.kind == b"a1lx" and essential or (
                        prop.kind in (b"a1op", b"lsel") and not essential):
                    raise BoxError(f"ipma marks {prop.kind!r} "
                                   f"{'' if essential else 'not '}essential")
                item.props.append((prop, bool(essential)))


def _hdlr(data, s, e) -> bytes:
    """A hdlr box (the meta's or a track's), checked as libavif checks it:
    version 0, pre_defined 0, a NUL-terminated name. Its handler type."""
    q = Reader(data, s, e)
    q.full((0,))
    if q.u32() != 0:
        raise BoxError("hdlr pre_defined is not 0")
    kind = q.fourcc()
    q.take(12)
    q.cstring()
    return kind


def _meta(data, s, e, f: File):
    r = Reader(data, s, e)
    r.full((0,))
    seen = set()
    for typ, bs, be in boxes(data, r.pos, e):
        if typ in seen and typ in (b"hdlr", b"pitm", b"iloc", b"iinf",
                                   b"iref", b"iprp", b"idat"):
            raise BoxError(f"duplicate {typ!r} box")
        seen.add(typ)
        if typ == b"hdlr":
            if _hdlr(data, bs, be) != b"pict":
                raise BoxError("meta handler is not 'pict'")
        elif typ == b"pitm":
            q = Reader(data, bs, be)
            v, _ = q.full((0, 1))
            f.primary = q.u16() if v == 0 else q.u32()
        elif typ == b"iloc":
            _iloc(data, bs, be, f.items)
        elif typ == b"iinf":
            _iinf(data, bs, be, f.items)
        elif typ == b"iref":
            _iref(data, bs, be, f.items)
        elif typ == b"iprp":
            _iprp(data, bs, be, f.items)
        elif typ == b"idat":
            f.idat = data[bs:be]
    if b"hdlr" not in seen:
        raise BoxError("meta without hdlr")


def _stbl(data, s, e, t: Track):
    for typ, bs, be in boxes(data, s, e):
        r = Reader(data, bs, be)
        if typ in (b"stsd", b"stsc", b"stsz", b"stco", b"co64", b"stss",
                   b"stts"):
            r.full((0,))    # libavif enforces version 0
        if typ == b"stsd":
            # libavif reads every entry the count names; the first is used
            count = r.u32()
            entries = boxes(data, r.pos, be)
            for k in range(count):
                etyp, es, ee = next(entries, (None, 0, 0))
                if etyp is None:
                    raise BoxError("stsd names more entries than it holds")
                if k == 0:
                    t.sample_entry = etyp
                    # VisualSampleEntry: 78 bytes before child boxes
                    for ctyp, cs, ce in boxes(data, es + 78, ee):
                        t.props.append((_property(ctyp, data, cs, ce),
                                        False))
        elif typ == b"stsc":
            t.stsc = [(r.u32(), r.u32(), r.u32()) for _ in range(r.u32())]
        elif typ == b"stsz":
            size, count = r.u32(), r.u32()
            t.sample_size = size
            t.sample_sizes = [] if size else [r.u32() for _ in range(count)]
        elif typ == b"stss":
            r.take(4 * r.u32())     # libavif reads every sync sample
        elif typ == b"stco":
            t.chunk_offsets = [r.u32() for _ in range(r.u32())]
        elif typ == b"co64":
            t.chunk_offsets = [r.u(8) for _ in range(r.u32())]


def _trak(data, s, e) -> Track:
    t = Track()
    has_tkhd = any(typ == b"tkhd" for typ, _, _ in boxes(data, s, e))
    stack = [(s, e)]
    while stack:
        ps, pe = stack.pop()
        for typ, bs, be in boxes(data, ps, pe):
            if typ in (b"mdia", b"minf"):
                stack.append((bs, be))
            elif typ == b"tkhd":
                r = Reader(data, bs, be)
                v, _ = r.full()
                r.take(16 if v == 1 else 8)
                t.id = r.u32()
                # reserved, duration, reserved, layer, alternate group,
                # volume, reserved, matrix; then 16.16 width and height
                r.take((12 if v == 1 else 8) + 52)
                t.width, t.height = r.u32() >> 16, r.u32() >> 16
            elif typ == b"edts":
                elst = [(es, ee) for etyp, es, ee in boxes(data, bs, be)
                        if etyp == b"elst"]
                if not elst:
                    raise BoxError("edts without elst")
                q = Reader(data, *elst[0])
                q.full()
                if q.u32() != 1:
                    raise BoxError("elst entry count is not 1")
            elif typ == b"hdlr":
                _hdlr(data, bs, be)
            elif typ == b"mdhd":
                r = Reader(data, bs, be)
                v, _ = r.full()
                r.take(16 if v == 1 else 8)     # creation, modification
                t.timescale = r.u32()
            elif typ == b"stbl":
                _stbl(data, bs, be, t)
            elif typ == b"tref":
                for rtyp, rs, re_ in boxes(data, bs, be):
                    r = Reader(data, rs, re_)
                    t.refs[rtyp] = [r.u32() for _ in range(r.left() // 4)]
    if not has_tkhd:
        raise BoxError("trak without tkhd")
    return t


def parse(data: bytes) -> File:
    """The file's ftyp, items and tracks (top-level boxes read until ftyp
    and meta, and moov for an 'avis' brand, are in). Raises BoxError."""
    f = File(b"", [], {}, None, b"", [], False)
    seen = set()
    for typ, bs, be in boxes(data, 0, len(data), top=True):
        if typ == b"ftyp":
            if b"ftyp" in seen:
                raise BoxError("duplicate ftyp")
            r = Reader(data, bs, be)
            f.major = r.fourcc()
            r.u32()
            if r.left() % 4:
                raise BoxError("ftyp brands")
            f.brands = [r.fourcc() for _ in range(r.left() // 4)]
        elif typ == b"meta":
            if b"meta" in seen:
                raise BoxError("duplicate meta")
            f.has_meta = True
            _meta(data, bs, be, f)
        elif typ == b"moov":
            for ttyp, ts, te in boxes(data, bs, be):
                if ttyp == b"trak":
                    f.tracks.append(_trak(data, ts, te))
        if not seen and typ != b"ftyp":
            raise BoxError("the first box is not ftyp")
        seen.add(typ)
        if {b"ftyp", b"meta"} <= seen and (b"moov" in seen or b"avis" not in
                                          [f.major] + f.brands):
            break   # libavif stops reading once it has what it needs
    if b"ftyp" not in seen:
        raise BoxError("no ftyp")
    brands = [f.major] + f.brands
    if ((b"avif" in brands and b"meta" not in seen)
            or (b"avis" in brands and b"moov" not in seen)):
        # libavif's needsMeta / needsMoov: the file is truncated
        raise BoxError("no meta box for an 'avif' brand, or no moov box for "
                       "an 'avis' one")
    return f


def item_payload(data: bytes, f: File, item: Item) -> bytes:
    """An item's bytes: its extents in the file (or in idat), joined."""
    if not item.has_iloc:
        raise BoxError(f"item {item.id} has no iloc entry")
    src = f.idat if item.method == 1 else data
    out = bytearray()
    for off, length in item.extents:
        if length == 0:
            raise BoxError(f"item {item.id} has an empty extent")
        if off < 0 or off + length > len(src):
            raise BoxError(f"item {item.id} extent runs past the file")
        out += src[off:off + length]
    return bytes(out)
