"""AVIF reading as PIL's AVIF plugin gets it from libavif 1.3.0 with dav1d
1.5.1 (AvifImagePlugin.py, libavif's src/read.c and src/reformat*.c):

  - the file's brands: 'avif' or 'avis' among ftyp's major and compatible
    brands, else it is not AVIF (PIL's SyntaxError, the next plugin);
  - the source: a sequence ('avis' major brand with an av01 track) decodes
    the first sample of its colour track, and of the track whose 'auxl'
    reference names it (with an alpha 'auxi' type, or none) for alpha;
    otherwise the primary item ('av01', or 'grid' over av01 tiles
    assembled in row-major order and cropped to the grid's output size)
    and the item whose 'auxl' reference names it with an alpha auxC type;
    a 'prem' reference from the colour item marks the alpha
    premultiplied; libavif's parse rules first (boxes, items it skips, an
    ispe on every item it keeps, sample tables);
  - each AV1 payload through assets/av1_decode.py, film grain applied;
  - the matrix and range from the nclx 'colr' property (else the AV1
    sequence header's), then libavif's YUV to RGBA8
    (assets/avif_yuv.py). 'irot', 'imir', 'clap', ICC and EXIF are not
    applied, as PIL's convert("RGBA") does not apply them.

A frame whose size is not its item's ispe (or its track's tkhd size) is
scaled to that size as libavif's avifImageScale does it (libyuv's box
filter, assets/avif_scale.py), each tile of a grid and the alpha frame
alike; PIL's image has the container's size.

8, 10 and 12-bit streams are read, superres frames among them (upscaled
to the frame's full width before loop restoration, as dav1d does); above
8 bits the planes are uint16 and libavif's conversion takes them to
RGBA8 (assets/avif_yuv.py).

What the port does not decode raises ValueError naming it: several
frames in one sample (spatial layers, assets/av1_decode.py), the matrix
coefficients libavif refuses too (assets/avif_yuv.py), and images above
libavif's 16384 x 16384 samples, as libavif refuses them. Before anything
is decoded, the size PIL's open reports goes through PIL's
decompression-bomb guard (modes.check_size).
"""

from __future__ import annotations

import struct

import numpy as np

from . import av1_decode, avif_scale, avif_yuv, isobmff, modes
from .modes import NotThisFormat

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# the item properties libavif 1.3.0 parses; an item with an essential
# property of another type is skipped
SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot",
             b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


def accepts(data: bytes) -> bool:
    """PIL's _accept: an ftyp box with a major brand libavif may read."""
    return data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"mif1",
                                                   b"msf1")


def read_avif(data: bytes, where: str = "<bytes>",
              check=modes.check_size) -> np.ndarray:
    """The first frame as (H, W, 4) u8. `check` (PIL's decompression-bomb
    guard, or None) sees the size PIL's open reports, the primary item's
    ispe or the colour track's size, before anything is decoded."""
    try:
        f = isobmff.parse(data)
    except isobmff.BoxError as e:
        raise NotThisFormat(f"not an AVIF file libavif parses: {e}") from e
    try:
        return _read(data, f, check or (lambda w, h: None))
    except (ZeroDivisionError, RecursionError) as e:
        raise ValueError(f"malformed AVIF stream: {e!r}") from e


def _read(data, f, check):
    brands = [f.major] + f.brands
    if b"avif" not in brands and b"avis" not in brands:
        raise NotThisFormat("ftyp names neither 'avif' nor 'avis'")
    _check_items(f)
    # libavif passes over tracks of id 0 or without chunks
    tracks = [t for t in f.tracks
              if t.sample_entry == b"av01" and t.id and t.chunk_offsets]
    if f.major == b"avis" and tracks:
        color, alpha, prem, nclx = _from_tracks(data, tracks, check)
    else:
        if not f.has_meta:
            raise NotThisFormat("AVIF file without a meta box")
        color, alpha, prem, nclx = _from_items(data, f, check)
    return _to_rgba(color, alpha, prem, nclx)


def _nclx(props):
    """The nclx colr property's (matrix, full range, primaries), or None."""
    for p, _ in props:
        if p.kind == b"colr" and p.fields.get("colour_type") == b"nclx":
            return (p.fields["matrix"], p.fields["full_range"],
                    p.fields["primaries"])
    return None


def _sized(frame, w, h):
    """The frame scaled to the container's w x h (libavif's
    avifImageScaleWithLimit, with its default limits: 32768 samples a
    side, 16384 x 16384 in all), or as it is where the sizes agree."""
    if (frame.width, frame.height) == (w, h):
        return frame
    if not w or not h:
        raise ValueError("AVIF image of zero size")
    if w > 32768 or h > 32768 or w * h > av1_decode.MAX_PIXELS:
        raise ValueError("AVIF image above libavif's size limit")
    seq = frame.seq
    frame.planes = avif_scale.scale_frame(frame.planes, seq.ssx, seq.ssy,
                                          w, h, seq.bit_depth)
    frame.width, frame.height = w, h
    return frame


def _track_frame(data, track, what):
    if not track.width or not track.height:
        raise ValueError(f"AVIF {what} track of zero size")
    off, size = track.first_sample(len(data))
    return _sized(av1_decode.decode(data[off:off + size]), track.width,
                  track.height)


def _from_tracks(data, tracks, check):
    color = next((t for t in tracks if not t.refs.get(b"auxl")), None)
    if color is None:
        raise ValueError("AVIF sequence without a colour track")
    if not color.timescale:
        # PIL divides the frame's timestamp by libavif's timescale, the
        # colour track's
        raise ValueError("AVIF sequence of timescale 0")
    if not any(p.kind == b"av1C" for p, _ in color.props):
        raise ValueError("AVIF colour track without av1C")
    check(color.width, color.height)
    frame = _track_frame(data, color, "colour")
    alpha = None
    for t in tracks:
        # libavif takes the first track auxl ties to the colour one, unless
        # its auxi names another type than alpha
        aux = next((p for p, _ in t.props if p.kind == b"auxi"), None)
        if color.id in t.refs.get(b"auxl", []) and (
                aux is None or aux.fields.get("aux_type") in ALPHA_URNS):
            alpha = _track_frame(data, t, "alpha")
            break
    return frame, alpha, False, _nclx(color.props)


def _item_image(data, f, item, alpha=False):
    """An av01 item's frame scaled to its ispe, or a grid's tiles
    assembled."""
    if item.type == b"av01":
        av1c = item.prop(b"av1C")
        if av1c is None:
            raise ValueError(f"AVIF item {item.id} has no av1C property")
        ispe = item.prop(b"ispe")
        if ispe is None:
            raise ValueError(f"AVIF item {item.id} has no ispe property")
        # libavif holds pixi to av1C's depth; the stream's own depth is the
        # one decoded
        depth = (12 if av1c.fields["twelve_bit"] else
                 10 if av1c.fields["high_bitdepth"] else 8)
        pixi = item.prop(b"pixi")
        if pixi is not None and any(d != depth
                                    for d in pixi.fields["depths"]):
            raise ValueError("AVIF pixi depth differs from its av1C")
        return _sized(av1_decode.decode(isobmff.item_payload(data, f, item)),
                      ispe.fields["width"], ispe.fields["height"])
    if item.type != b"grid":
        raise ValueError(f"AVIF item of type {item.type!r} is not an image")
    if item.prop(b"ispe") is None:
        raise ValueError(f"AVIF item {item.id} has no ispe property")
    raw = isobmff.item_payload(data, f, item)
    if len(raw) < 8:
        raise ValueError("AVIF grid payload too short")
    version, flags, rows, cols = raw[0], raw[1], raw[2] + 1, raw[3] + 1
    if version != 0:
        raise ValueError("AVIF grid version")
    big = flags & 1
    need = 4 + (8 if big else 4)
    if len(raw) != need:
        raise ValueError("AVIF grid payload size")
    ow, oh = struct.unpack(">II" if big else ">HH", raw[4:need])
    tiles = item.refs.get(b"dimg", [])
    if len(tiles) != rows * cols:
        raise ValueError("AVIF grid tile count")
    frames = []
    for tid in tiles:
        t = f.items.get(tid)
        if t is None or t.type != b"av01":
            raise ValueError("AVIF grid tile is not an av01 item")
        frames.append(_item_image(data, f, t, alpha))
    first = frames[0]
    tw, th = first.width, first.height
    seq0 = first.seq
    for fr in frames:
        s = fr.seq
        if ((fr.width, fr.height) != (tw, th) or s.num_planes != seq0.num_planes
                or (s.ssx, s.ssy) != (seq0.ssx, seq0.ssy)
                or s.color_range != seq0.color_range
                or s.bit_depth != seq0.bit_depth):
            raise ValueError("AVIF grid tiles differ")
    if tw * cols < ow or th * rows < oh or tw * (cols - 1) >= ow or th * (rows - 1) >= oh:
        raise ValueError("AVIF grid size does not fit its tiles")
    # MIAF's grid rules as libavif checks them: tiles at least 64 x 64,
    # even widths (and heights, in 4:2:0) in subsampled chroma
    if tw < 64 or th < 64:
        raise ValueError("AVIF grid tiles smaller than 64 x 64")
    if seq0.num_planes > 1 and ((seq0.ssx and (ow % 2 or tw % 2))
                                or (seq0.ssy and (oh % 2 or th % 2))):
        raise ValueError("AVIF grid of odd size in subsampled chroma")
    ispe = item.prop(b"ispe").fields
    if (ispe["width"], ispe["height"]) != (ow, oh):
        raise ValueError("AVIF grid size differs from its ispe")
    planes = []
    for p in range(seq0.num_planes):
        sx = seq0.ssx if p else 0
        sy = seq0.ssy if p else 0
        ptw, pth = (tw + sx) >> sx, (th + sy) >> sy
        big_p = np.zeros((pth * rows, ptw * cols), frames[0].planes[0].dtype)
        for k, fr in enumerate(frames):
            r, c = divmod(k, cols)
            big_p[r * pth:(r + 1) * pth, c * ptw:(c + 1) * ptw] = fr.planes[p]
        planes.append(big_p[:(oh + sy) >> sy, :(ow + sx) >> sx])
    first.planes = planes
    first.width, first.height = ow, oh
    return first


def _from_items(data, f, check):
    if f.primary is None or f.primary not in f.items:
        raise ValueError("AVIF file without a primary item")
    color = f.items[f.primary]
    if color.type not in (b"av01", b"grid"):
        raise ValueError(f"AVIF primary item of type {color.type!r}")
    if _skipped(color):
        raise ValueError(f"AVIF primary item {color.id} is one libavif skips")
    ispe = color.prop(b"ispe")
    if ispe is not None:
        check(ispe.fields["width"], ispe.fields["height"])
    frame = _item_image(data, f, color)
    alpha = None
    prem = False
    it = _alpha_item(f)
    if it is not None:
        alpha = _item_image(data, f, it, alpha=True)
        prem = it.id in color.refs.get(b"prem", [])
    return frame, alpha, prem, _nclx(color.props)


def _skipped(it) -> bool:
    """libavif's avifDecoderItemShouldBeSkipped: no data, an essential
    property it does not parse, not an image (av01 or grid), or a
    thumbnail."""
    return (it.type not in (b"av01", b"grid") or b"thmb" in it.refs
            or not (it.has_iloc and sum(n for _, n in it.extents))
            or any(e and p.kind not in SUPPORTED for p, e in it.props))


def _check_items(f):
    """avifDecoderParse's check of every item it does not skip, whichever
    source it then decodes: an ispe property (an alpha item's too, by its
    strict flags), of a size neither zero nor above its limits."""
    for it in f.items.values():
        if _skipped(it):
            continue
        ispe = it.prop(b"ispe")
        if ispe is None:
            raise ValueError(f"AVIF item {it.id} has no ispe property")
        w, h = ispe.fields["width"], ispe.fields["height"]
        if not w or not h or w > 32768 or h > 32768 or \
                w * h > av1_decode.MAX_PIXELS:
            raise ValueError(f"AVIF item {it.id} of size {w}x{h} (libavif's "
                             "limits: not 0, 32768 a side, 16384 x 16384)")


def _alpha_item(f):
    """The primary item's alpha: the first item whose auxl names it with an
    alpha auxC that libavif does not skip."""
    for it in f.items.values():
        if f.primary not in it.refs.get(b"auxl", []) or _skipped(it):
            continue
        aux = it.prop(b"auxC")
        if aux is not None and aux.fields.get("aux_type") in ALPHA_URNS:
            return it
    return None


def _to_rgba(frame, alpha, prem, nclx):
    """libavif takes the matrix and the range from the nclx colr property
    where there is one, else from the AV1 sequence header."""
    seq = frame.seq
    matrix, full, primaries = (nclx if nclx is not None
                               else (seq.mc, seq.color_range, seq.cp))
    a = None
    if alpha is not None:
        if (alpha.width, alpha.height, alpha.seq.bit_depth) != (
                frame.width, frame.height, seq.bit_depth):
            raise ValueError("AVIF alpha size or bit depth differs from the "
                             "image")
        a = alpha.planes[0]
        if not alpha.seq.color_range:
            a = avif_yuv.limited_to_full_alpha(a, alpha.seq.bit_depth)
    return avif_yuv.yuv_to_rgba(frame.planes, seq.ssx, seq.ssy, bool(full),
                                matrix, a, prem, primaries, seq.bit_depth)
