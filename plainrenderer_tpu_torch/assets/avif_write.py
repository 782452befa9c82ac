"""The AVIF container libavif 1.3.0 writes for one still image as PIL
saves it (avifEncoderWrite with no Exif, XMP or ICC): 'ftyp' (major brand
'avif'; 'avif', 'mif1', 'miaf', 'MA1B'), 'meta' (an empty-named 'pict'
handler, 'pitm', a version 0 'iloc' with 4-byte offsets and lengths and
no base offset, 'iinf' with version 2 'infe' entries named "Color" and
"Alpha", an 'iref' 'auxl' from the alpha item, 'iprp' with the shared
'ispe', per-item 'pixi' and 'av1C' (no configOBUs), the colour item's
nclx 'colr' (BT.709 primaries, sRGB transfer, BT.601 matrix, full range)
and the alpha item's 'auxC'; 'ipma' marking each 'av1C' essential), then
'mdat' with the alpha payload before the colour one.
"""

from __future__ import annotations

import struct

import numpy as np

ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"
MAX_SIDE = 65536    # libaom encodes no wider or taller frame


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, struct.pack(">I", version << 24 | flags) + body)


def av1c(seq) -> bytes:
    """av1C from a sequence header (assets/av1_obu.py fields)."""
    return box(b"av1C", bytes([
        0x81, seq.profile << 5 | seq.level,
        (seq.bit_depth > 8) << 6 | (seq.bit_depth == 12) << 5
        | seq.mono << 4 | seq.ssx << 3 | seq.ssy << 2 | seq.csp, 0]))


def write(width: int, height: int, color: bytes, color_seq,
          alpha: bytes | None = None, alpha_seq=None) -> bytes:
    """The file around the colour item's AV1 temporal unit and, where
    given, the alpha item's."""
    items = [(1, color)] + ([(2, alpha)] if alpha is not None else [])
    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B")
    hdlr = full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(13))
    pitm = full(b"pitm", 0, 0, struct.pack(">H", 1))
    names = {1: b"Color", 2: b"Alpha"}
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        full(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01" + names[i]
             + b"\0") for i, _ in items))
    iref = b""
    if alpha is not None:
        iref = full(b"iref", 0, 0, box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
    props = [box(b"ispe", struct.pack(">III", 0, width, height)),
             full(b"pixi", 0, 0, bytes([3, 8, 8, 8])), av1c(color_seq),
             box(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80))]
    assoc = {1: [1, 2, 3 | 0x80, 4]}
    if alpha is not None:
        props += [full(b"pixi", 0, 0, bytes([1, 8])), av1c(alpha_seq),
                  full(b"auxC", 0, 0, ALPHA_URN + b"\0")]
        assoc[2] = [1, 5, 6 | 0x80, 7]
    ipma = full(b"ipma", 0, 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", i, len(a)) + bytes(a) for i, a in assoc.items()))
    iprp = box(b"iprp", box(b"ipco", b"".join(props)) + ipma)

    def meta(offsets):
        iloc = full(b"iloc", 0, 0, bytes([0x44, 0x00])
                    + struct.pack(">H", len(items)) + b"".join(
                        struct.pack(">HHHII", i, 0, 1, offsets[i], len(d))
                        for i, d in items))
        return full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp)

    order = ([(2, alpha)] if alpha is not None else []) + [(1, color)]
    head = len(ftyp) + len(meta({i: 0 for i, _ in items})) + 8
    offsets, pos = {}, head
    for i, d in order:
        offsets[i] = pos
        pos += len(d)
    mdat = box(b"mdat", b"".join(d for _, d in order))
    return ftyp + meta(offsets) + mdat


def encode_frames(image: np.ndarray) -> tuple:
    """The colour frame and the alpha frame (None where every alpha is 255)
    av1_encode.encode_frame writes for (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA u8 pixels: libavif's YUV and alpha planes (grey as RGB,
    as PIL converts L), each coded with the port's intra search. Each
    frame holds its temporal unit (``data``) and the encoder's own
    reconstruction (``planes``)."""
    from . import av1_encode, av1_intra_search, avif_rgb2yuv
    a = np.asarray(image)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, 2)
    h, w = a.shape[:2]
    if not (w and h):
        raise ValueError("AVIF image of zero size (PIL: invalid canvas "
                         "dimensions)")
    if w > MAX_SIDE or h > MAX_SIDE:
        raise ValueError(f"AVIF side above {MAX_SIDE} ({w} x {h}): libaom "
                         "fails to encode it")

    def code(planes):
        return av1_encode.encode_frame(
            planes, lambda src, t: av1_intra_search.Search(src))

    alpha = avif_rgb2yuv.alpha_plane(a)
    return (code(avif_rgb2yuv.rgb_to_yuv420(a)),
            None if alpha is None else code([alpha]))


def encode(image: np.ndarray) -> bytes:
    """An AVIF file of (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA u8
    pixels as PIL's default save writes it: encode_frames' items in
    libavif's container. PIL passes its max_threads (the CPUs the process
    may run on) to libavif, whose automatic tiling here depends on the
    picture's size alone, so the bytes do not depend on it."""
    h, w = np.asarray(image).shape[:2]
    color, alpha = encode_frames(image)
    if alpha is None:
        return write(w, h, color.data, color.seq)
    return write(w, h, color.data, color.seq, alpha.data, alpha.seq)
