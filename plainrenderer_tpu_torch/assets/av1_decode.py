"""Decoding one AV1 intra frame from an AVIF item or a sequence's first
sample (the AV1 specification, sections 7.3-7.20 for a key frame): the
OBUs of the selected operating point, the frame header, each tile group's
tiles through assets/av1_block.py, then the post filters in the
specification's order (deblocking, CDEF, superres upscaling through
assets/av1_superres.py, loop restoration) and film grain as dav1d applies
it, and the frame's planes cropped to its size.

8, 10 and 12-bit streams are decoded (the dequantisation tables, the
post filters' thresholds and rounding and film grain's ranges follow the
bit depth). Refused by name: a sample holding more than one frame
(spatial layers): a layered image needs AV1 inter prediction, which this
intra decoder does not carry, and PIL's wheel writes none to hold the
port against. Frames above libavif's 16384 x 16384 samples (upscaled)
are refused, as libavif refuses them (its decoder's default
imageSizeLimit; dav1d's frame size limit is set to it). The planes are
uint8 at 8 bits and uint16 above, the per-4x4 arrays int8 (vectors
int32): the frame state of a 16384 x 16384 4:2:0 frame holds 394 MiB of
planes (with their margins) at 8 bits, 788 MiB at 10 or 12, and 398 MiB
of per-4x4 arrays. tests/torch_avif_peak_memory.py measures a whole
read's peak.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

from . import (av1_block, av1_cdef, av1_filmgrain, av1_loopfilter, av1_msac,
               av1_obu, av1_restoration, av1_superres)
from .av1_obu import AV1Error

# libavif 1.3.0's AVIF_DEFAULT_IMAGE_SIZE_LIMIT, in samples
MAX_PIXELS = 16384 * 16384


def decode(data: bytes, check_trailing: bool = False,
           record: list | None = None) -> SimpleNamespace:
    """The frame in one temporal unit: planes (Y[, U, V]) as uint8 (8-bit)
    or uint16 (10, 12-bit) arrays of the frame's size, the sequence and frame headers, and the set of
    coding tools the frame used; check_trailing also fails a tile that
    does not end on its padding (a parse that lost step). Operating point
    0, as libavif selects it. A list passed as record gets one list per
    tile of the syntax elements read (av1_block.RecordingDecoder)."""
    seq = hdr = None
    fs = None
    tiles_done = 0
    num_tiles = 0
    for typ, tid, sid, s, e in av1_obu.obus(data):
        if typ == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(data, s, e)
            continue
        if typ not in (av1_obu.OBU_FRAME_HEADER, av1_obu.OBU_TILE_GROUP,
                       av1_obu.OBU_FRAME, av1_obu.OBU_REDUNDANT_FRAME_HEADER):
            continue   # delimiters, metadata, padding and reserved types
        if seq is None:
            raise AV1Error("AV1 frame before the sequence header")
        idc = seq.op_idc[0]
        if idc and not ((idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
            continue
        if typ in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
            if fs is not None:
                if tiles_done < num_tiles:
                    raise AV1Error("AV1 frame header before the last tile")
                raise AV1Error("AV1 sample with more than one frame "
                               "(spatial layers) is not decoded by the port")
            hdr, pos = av1_obu.frame_header(data, s, e, seq, tid, sid)
            if hdr.upscaled_width * hdr.height > MAX_PIXELS:
                raise AV1Error("AV1 frame above 16384 x 16384 samples "
                               "(libavif's image size limit)")
            fs = av1_block.FrameState(seq, hdr)
            fs.cdfs = av1_block.default_cdfs(hdr.base_q_idx)
            num_tiles = hdr.tile_cols * hdr.tile_rows
            if typ == av1_obu.OBU_FRAME:
                tiles_done = _tile_group(fs, data, pos, e, tiles_done,
                                         check_trailing, record)
        elif typ == av1_obu.OBU_TILE_GROUP:
            if fs is None:
                raise AV1Error("AV1 tile group without a frame header")
            tiles_done = _tile_group(fs, data, s, e, tiles_done,
                                     check_trailing, record)
        elif typ == av1_obu.OBU_REDUNDANT_FRAME_HEADER:
            continue
    if fs is None:
        raise AV1Error("AV1 sample without a frame")
    if tiles_done < num_tiles:
        raise AV1Error("AV1 sample ends before its last tile")
    return _finish(fs)


def _tile_group(fs, data, pos, end, done, check_trailing, record=None):
    h = fs.hdr
    r = av1_obu.BitReader(data, pos, end)
    n = h.tile_cols * h.tile_rows
    start, last = 0, n - 1
    if n > 1 and r.f(1):
        bits = h.tile_cols_log2 + h.tile_rows_log2
        start, last = r.f(bits), r.f(bits)
    r.byte_align()
    p = r.byte_pos()
    if start != done or last < start or last >= n:
        raise AV1Error("AV1 tile group out of order")
    for t in range(start, last + 1):
        row, col = divmod(t, h.tile_cols)
        if t == last:
            size = end - p
        else:
            if p + h.tile_size_bytes > end:
                raise AV1Error("AV1 tile size past the tile group")
            size = int.from_bytes(data[p:p + h.tile_size_bytes], "little") + 1
            p += h.tile_size_bytes
        if size <= 0 or p + size > end:
            raise AV1Error("AV1 tile runs past its tile group")
        if record is None:
            sd = av1_msac.SymbolDecoder(data, p, size, h.disable_cdf_update)
        else:
            record.append([])
            sd = av1_block.RecordingDecoder(data, p, size,
                                            h.disable_cdf_update, record[-1])
        cdfs = copy.deepcopy(fs.cdfs)
        td = av1_block.TileDecoder(fs, cdfs, sd, h.mi_row_starts[row],
                                   h.mi_row_starts[row + 1],
                                   h.mi_col_starts[col],
                                   h.mi_col_starts[col + 1])
        if record is not None:
            sd.names = av1_block.cdf_names(cdfs, td.mv_cdfs)
        td.decode()
        if sd.shifted >= 8 * size:
            # dav1d fails a tile whose symbol decoder used up its data (a
            # coded tile ends in a padding bit it never reads)
            raise AV1Error(f"AV1 tile {t} read past its data")
        if check_trailing and not sd.trailing_ok():
            raise AV1Error(f"AV1 tile {t} did not end on its padding")
        p += size
    return last + 1


def _finish(fs):
    seq, h = fs.seq, fs.hdr
    av1_loopfilter.apply(fs)
    pre_cdef = [p.copy() for p in fs.planes] if h.uses_lr else None
    if h.cdef_on:
        av1_cdef.apply(fs)
    if h.width != h.upscaled_width:
        fs.planes = av1_superres.apply(seq, h, fs.planes)
        if pre_cdef is not None:
            pre_cdef = av1_superres.apply(seq, h, pre_cdef)
    if h.uses_lr:
        av1_restoration.apply(fs, pre_cdef)
    planes = []
    for p in range(seq.num_planes):
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        pw = (h.upscaled_width + sx) >> sx
        ph = (h.height + sy) >> sy
        planes.append(fs.planes[p][:ph, :pw].copy())
    if h.grain is not None:
        planes = av1_filmgrain.apply(planes, seq, h.grain)
    tools = fs.tools
    for name, on in (("cdef", h.cdef_on), ("lr", h.uses_lr),
                     ("grain", h.grain is not None),
                     ("sb128", seq.use_128), ("mono", seq.mono),
                     ("tiles", h.tile_cols * h.tile_rows > 1),
                     ("deblock", h.lf_level[0] or h.lf_level[1])):
        if on:
            tools.add(name)
    return SimpleNamespace(planes=planes, seq=seq, hdr=h, tools=tools,
                           width=h.upscaled_width, height=h.height)
