"""8-bit AVIF files rewritten to 10 or 12 bits, for the AVIF tests (a
helper, not collected).

AV1's tile syntax does not depend on the bit depth (but for the palette's
colour literals), so an 8-bit stream whose sequence header is rewritten is
a valid 10 or 12-bit stream, which PIL (libavif 1.3.0 with dav1d 1.5.1)
decodes and the port is held to. ``to_depth`` rewrites every AV1 payload's
sequence header (high_bitdepth set; for 12 bits seq_profile 2, twelve_bit
and, where the profile reads them, the subsampling bits and the
monochrome flag), every av1C property and every pixi property; where the
sequence header grows by a byte, the boxes around it, the iloc extents and
the sample tables (stco / co64, stsz) are moved with it."""

import struct

from plainrenderer_tpu_torch.assets import av1_obu, isobmff


def _reads(data: bytes, s: int, e: int):
    """The sequence header in data[s:e] and its fields' (bit offset from
    s, width, value), in reading order."""
    reads = []

    class Recorder(av1_obu.BitReader):
        def f(self, n):
            at = self.bit - 8 * s
            v = super().f(n)
            reads.append((at, n, v))
            return v

    plain = av1_obu.BitReader
    av1_obu.BitReader = Recorder
    try:
        seq = av1_obu.sequence_header(data, s, e)
    finally:
        av1_obu.BitReader = plain
    return seq, reads


def sequence_header(data: bytes, s: int, e: int, depth: int) -> bytes:
    """The OBU payload data[s:e] (an 8-bit sequence header) at the depth."""
    seq, reads = _reads(data, s, e)
    assert seq.bit_depth == 8, seq.bit_depth
    mono = seq.mono
    srgb = not mono and (seq.cp, seq.tc, seq.mc) == (1, 13, 0)
    tail = (1 + (not mono) + (not mono and not srgb and seq.ssx and seq.ssy)
            + (not srgb) + 3 * seq.color_description_present + 1
            + (seq.profile != 1) + 1)
    k = len(reads) - tail       # high_bitdepth
    assert reads[k][1:] == (1, 0), reads[k]
    bits = "".join(format(b, "08b") for b in data[s:e])
    profile = 2 if depth == 12 else seq.profile
    i = k + 1 + (seq.profile != 1)      # color_description_present
    i += 1 + 3 * seq.color_description_present
    # inserted after high_bitdepth, and after color_range
    after_high = "1" if profile == 2 and depth == 12 else (
        "0" if profile == 2 else "")
    if seq.profile == 1 and profile == 2:
        after_high += "0"               # mono_chrome, which profile 1 omits
    after_range = ""
    if profile == 2 and depth == 12 and not mono and not srgb:
        after_range = str(seq.ssx) + (str(seq.ssy) if seq.ssx else "")
    hi = reads[k][0]
    out = format(profile, "03b") + bits[3:hi] + "1" + after_high
    if after_range:
        cr = reads[i][0] + 1
        out += bits[hi + 1:cr] + after_range
        hi = cr - 1
    end = reads[-1][0] + 1
    out += bits[hi + 1:end] + "1"
    out += "0" * (-len(out) % 8)
    return bytes(int(out[j:j + 8], 2) for j in range(0, len(out), 8))


def _obu(typ: int, payload: bytes) -> bytes:
    size, out = len(payload), b""
    while True:
        byte = size & 0x7F
        size >>= 7
        out += bytes([byte | (0x80 if size else 0)])
        if not size:
            break
    return bytes([(typ << 3) | 2]) + out + payload


def _payload_ranges(data: bytes, f) -> list:
    """(start, end) in the file of every av01 item's extent and of each
    track's first sample."""
    out = []
    idat_at = None
    for typ, bs, be in isobmff.boxes(data, 0, len(data), top=True):
        if typ == b"meta":
            for t2, s2, e2 in isobmff.boxes(data, bs + 4, be):
                if t2 == b"idat":
                    idat_at = s2
    for item in f.items.values():
        if item.type != b"av01":
            continue
        base = idat_at if item.method == 1 else 0
        for off, length in item.extents:
            out.append((base + off, base + off + length))
    for t in f.tracks:
        off, size = t.first_sample(len(data))
        out.append((off, off + size))
    return out


def _sequence_obus(data: bytes, f) -> list:
    """(start, end, new bytes) of every sequence header OBU in a payload."""
    found = {}
    for a, b in _payload_ranges(data, f):
        chunk = data[a:b]
        pos = 0
        for typ, _, _, s, e in av1_obu.obus(chunk):
            if typ == av1_obu.OBU_SEQUENCE_HEADER:
                assert chunk[pos] == 0x0A, "sequence header OBU with an " \
                    "extension or without its size"
                found[a + pos] = (a + pos, a + e, chunk, s, e)
            pos = e
    return [found[k] for k in sorted(found)]


def _grow(buf: bytearray, at: int, delta: int) -> None:
    """Move what lies past file offset `at` by delta bytes: the sizes of
    the boxes holding it, iloc extents, stco / co64 offsets and the stsz
    size of the sample holding it (patched in place; the bytes are
    inserted afterwards)."""
    data = bytes(buf)

    def size_up(box_start):
        size = struct.unpack_from(">I", data, box_start)[0]
        assert size != 1, "64-bit box sizes are not rewritten"
        struct.pack_into(">I", buf, box_start, size + delta)

    def walk(s, e, containers, full=()):
        for typ, bs, be in isobmff.boxes(data, s, e, top=s == 0):
            head = bs - 8
            if head < at < be:
                size_up(head)
            if typ in containers:
                walk(bs + (4 if typ in full else 0), be, containers, full)
            if typ == b"iloc":
                _iloc(buf, data, bs, be, at, delta, idat)
            elif typ in (b"stco", b"co64"):
                n = struct.unpack_from(">I", data, bs + 4)[0]
                w = 4 if typ == b"stco" else 8
                for j in range(n):
                    p = bs + 8 + w * j
                    v = int.from_bytes(data[p:p + w], "big")
                    if v > at:
                        buf[p:p + w] = (v + delta).to_bytes(w, "big")

    idat = None
    for typ, bs, be in isobmff.boxes(data, 0, len(data), top=True):
        if typ == b"meta":
            for t2, s2, e2 in isobmff.boxes(data, bs + 4, be):
                if t2 == b"idat":
                    idat = s2
    walk(0, len(data), {b"meta", b"iprp", b"moov", b"trak", b"mdia",
                        b"minf", b"stbl"}, {b"meta"})
    for typ, bs, be in _all_boxes(data):
        if typ == b"stbl":
            _sample_up(buf, data, bs, be, at, delta)


def _sample_up(buf, data, s, e, at, delta):
    """The stsz entry of the sample of this sample table that holds `at`,
    grown by delta."""
    tab = {typ: (bs, be) for typ, bs, be in isobmff.boxes(data, s, e)}
    bs = tab[b"stsc"][0]
    stsc = [struct.unpack_from(">III", data, bs + 8 + 12 * j)
            for j in range(struct.unpack_from(">I", data, bs + 4)[0])]
    zs = tab[b"stsz"][0]
    const, count = struct.unpack_from(">II", data, zs + 4)
    sizes = ([const] * count if const else
             [struct.unpack_from(">I", data, zs + 12 + 4 * j)[0]
              for j in range(count)])
    w = 4 if b"stco" in tab else 8
    cs = tab[b"stco" if w == 4 else b"co64"][0]
    offsets = [int.from_bytes(data[cs + 8 + w * j:cs + 8 + w * (j + 1)], "big")
               for j in range(struct.unpack_from(">I", data, cs + 4)[0])]
    k = 0
    for c, off in enumerate(offsets, 1):
        per = next(n for first, n, _ in reversed(stsc) if first <= c)
        for _ in range(per):
            if k < count and off <= at < off + sizes[k]:
                assert not const, "constant sample size"
                struct.pack_into(">I", buf, zs + 12 + 4 * k, sizes[k] + delta)
            off += sizes[k] if k < count else 0
            k += 1


def _all_boxes(data):
    stack = [(0, len(data))]
    while stack:
        s, e = stack.pop()
        for typ, bs, be in isobmff.boxes(data, s, e, top=s == 0):
            yield typ, bs, be
            if typ in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"iprp",
                       b"ipco"):
                stack.append((bs, be))
            elif typ == b"meta":
                stack.append((bs + 4, be))
            elif typ == b"stsd":
                stack.append((bs + 8, be))
            elif typ == b"av01" and be - bs > 78:
                stack.append((bs + 78, be))


def _iloc(buf, data, s, e, at, delta, idat):
    version = data[s]
    p = s + 4
    osz, lsz = data[p] >> 4, data[p] & 15
    bsz, isz = data[p + 1] >> 4, (data[p + 1] & 15 if version else 0)
    p += 2
    count = struct.unpack_from(">H" if version < 2 else ">I", data, p)[0]
    p += 2 if version < 2 else 4
    for _ in range(count):
        p += 2 if version < 2 else 4
        method = 0
        if version:
            method = struct.unpack_from(">H", data, p)[0] & 15
            p += 2
        p += 2
        base = int.from_bytes(data[p:p + bsz], "big")
        p += bsz
        n = struct.unpack_from(">H", data, p)[0]
        p += 2
        origin = idat if method == 1 else 0
        for _ in range(n):
            p += isz
            off = int.from_bytes(data[p:p + osz], "big")
            length = int.from_bytes(data[p + osz:p + osz + lsz], "big")
            start = origin + base + off
            if start > at:
                assert osz, "iloc extents without offsets"
                buf[p:p + osz] = (off + delta).to_bytes(osz, "big")
            elif start <= at < start + length:
                buf[p + osz:p + osz + lsz] = (length + delta).to_bytes(
                    lsz, "big")
            p += osz + lsz


def to_depth(data: bytes, depth: int) -> bytes:
    """The AVIF file at 10 or 12 bits."""
    f = isobmff.parse(data)
    buf = bytearray(data)
    for typ, bs, be in _all_boxes(data):
        if typ == b"av1C":
            assert be - bs == 4, "av1C with config OBUs"
            mono, ssx, ssy = (buf[bs + 2] >> 4) & 1, (buf[bs + 2] >> 3) & 1, \
                (buf[bs + 2] >> 2) & 1
            profile = 2 if depth == 12 else buf[bs + 1] >> 5
            buf[bs + 1] = (profile << 5) | (buf[bs + 1] & 31)
            buf[bs + 2] = ((buf[bs + 2] & 0x80) | 0x40
                           | ((depth == 12) << 5) | (mono << 4) | (ssx << 3)
                           | (ssy << 2) | (buf[bs + 2] & 3))
        elif typ == b"pixi":
            for j in range(bs + 5, be):
                buf[j] = depth
    data = bytes(buf)
    for start, end, chunk, s, e in reversed(_sequence_obus(data, f)):
        data = splice(data, start, end, _obu(
            av1_obu.OBU_SEQUENCE_HEADER, sequence_header(chunk, s, e, depth)))
    return data


def splice(data: bytes, start: int, end: int, new: bytes) -> bytes:
    """The file with data[start:end] (inside one item extent or sample,
    or a whole one) replaced by new, the boxes, iloc extents and sample
    tables around it moved with it."""
    buf = bytearray(data)
    delta = len(new) - (end - start)
    if delta:
        _grow(buf, start, delta)
    return bytes(buf[:start]) + new + bytes(buf[end:])
