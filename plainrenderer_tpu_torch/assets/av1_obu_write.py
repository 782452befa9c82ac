"""Writing AV1 OBUs as libaom 3.12 writes a still image (the AV1
specification, sections 5.3-5.9, in the writing direction of assets/
av1_obu.py): the OBU header with its leb128 size, the reduced
still-picture sequence header, and the frame OBU of a key frame (the
uncompressed header, byte alignment, the tile group with each tile's size
in tile_size_bytes little-endian bytes, the last tile's size implied).

The headers are written from the same fields assets/av1_obu.py reads, so
a parsed header written back gives its bytes. What libaom does not write
for such a frame (segmentation, delta q and delta lf, explicit tile sizes,
CDEF and loop restoration parameters, film grain) raises ValueError.
"""

from __future__ import annotations

from .av1_obu import (OBU_FRAME, OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER,
                      _tile_log2)


class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int):
        if v < 0 or v >> n:
            raise ValueError(f"AV1 header value {v} does not fit {n} bits")
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def su(self, n: int, v: int):
        self.f(n, v & ((1 << n) - 1))

    def byte_align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def trailing_bits(self):
        self.bits.append(1)
        self.byte_align()

    def data(self) -> bytes:
        b = self.bits
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


def leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def obu(typ: int, payload: bytes) -> bytes:
    """An OBU with has_size_field set and no extension header."""
    return bytes([typ << 3 | 2]) + leb128(len(payload)) + payload


def sequence_header(seq) -> bytes:
    """A reduced still-picture sequence header (its OBU payload)."""
    if not (seq.still_picture and seq.reduced):
        raise ValueError("only the reduced still-picture header is written")
    w = BitWriter()
    w.f(3, seq.profile)
    w.f(1, 1)
    w.f(1, 1)
    w.f(5, seq.level)
    w.f(4, seq.frame_width_bits - 1)
    w.f(4, seq.frame_height_bits - 1)
    w.f(seq.frame_width_bits, seq.max_width - 1)
    w.f(seq.frame_height_bits, seq.max_height - 1)
    w.f(1, seq.use_128)
    w.f(1, seq.enable_filter_intra)
    w.f(1, seq.enable_intra_edge_filter)
    w.f(1, seq.enable_superres)
    w.f(1, seq.enable_cdef)
    w.f(1, seq.enable_restoration)
    if seq.bit_depth != 8 or seq.profile != 0:
        raise ValueError("only 8-bit profile 0 streams are written")
    w.f(1, 0)                       # high_bitdepth
    w.f(1, seq.mono)
    w.f(1, seq.color_description_present)
    if seq.color_description_present:
        w.f(8, seq.cp)
        w.f(8, seq.tc)
        w.f(8, seq.mc)
    if seq.mono or not (seq.cp == 1 and seq.tc == 13 and seq.mc == 0):
        w.f(1, seq.color_range)
    if not seq.mono:
        w.f(2, seq.csp)
        w.f(1, seq.separate_uv_delta_q)
    w.f(1, seq.film_grain_params_present)
    w.trailing_bits()
    return w.data()


def _tile_info(w: BitWriter, seq, h):
    if not h.uniform_tile_spacing:
        raise ValueError("explicit tile sizes are not written")
    sb_shift = 5 if seq.use_128 else 4
    sb_cols = (h.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (h.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    w.f(1, 1)
    for _ in range(min_log2_cols, h.tile_cols_log2):
        w.f(1, 1)
    if h.tile_cols_log2 < max_log2_cols:
        w.f(1, 0)
    for _ in range(max(min_log2_tiles - h.tile_cols_log2, 0),
                   h.tile_rows_log2):
        w.f(1, 1)
    if h.tile_rows_log2 < max_log2_rows:
        w.f(1, 0)
    if h.tile_cols_log2 or h.tile_rows_log2:
        w.f(h.tile_rows_log2 + h.tile_cols_log2, h.context_update_tile_id)
        w.f(2, h.tile_size_bytes - 1)


def _delta_q(w: BitWriter, v: int):
    w.f(1, 1 if v else 0)
    if v:
        w.su(7, v)


def frame_header(w: BitWriter, seq, h):
    """The uncompressed header of a shown key frame under a reduced
    still-picture sequence header."""
    w.f(1, h.disable_cdf_update)
    w.f(1, h.allow_screen_content_tools)
    if h.allow_screen_content_tools:
        w.f(1, h.force_integer_mv_bit)
    if seq.enable_superres:
        w.f(1, h.use_superres)
        if h.use_superres:
            w.f(3, h.superres_denom - 9)
    w.f(1, 0)                        # render_and_frame_size_different
    if h.allow_screen_content_tools and not h.use_superres:
        w.f(1, h.allow_intrabc)
    _tile_info(w, seq, h)
    w.f(8, h.base_q_idx)
    _delta_q(w, h.dq_y_dc)
    if seq.num_planes > 1:
        if seq.separate_uv_delta_q:
            raise ValueError("separate chroma delta q is not written")
        _delta_q(w, h.dq_u_dc)
        _delta_q(w, h.dq_u_ac)
    w.f(1, h.using_qmatrix)
    if h.using_qmatrix:
        w.f(4, h.qm_y)
        w.f(4, h.qm_u)
    if h.seg_enabled:
        raise ValueError("segmentation is not written")
    w.f(1, 0)
    if h.base_q_idx > 0:
        w.f(1, h.delta_q_present)
        if h.delta_q_present:
            raise ValueError("delta q is not written")
    if not (h.coded_lossless or h.allow_intrabc):
        w.f(6, h.lf_level[0])
        w.f(6, h.lf_level[1])
        if seq.num_planes > 1 and (h.lf_level[0] or h.lf_level[1]):
            w.f(6, h.lf_level[2])
            w.f(6, h.lf_level[3])
        w.f(3, h.lf_sharpness)
        w.f(1, h.lf_delta_enabled)
        if h.lf_delta_enabled:
            w.f(1, h.lf_delta_update)
            if h.lf_delta_update:
                for i, d in enumerate((1, 0, 0, 0, -1, 0, -1, -1)):
                    v = h.lf_ref_deltas[i]
                    w.f(1, int(v != d))
                    if v != d:
                        w.su(7, v)
                for v in h.lf_mode_deltas:
                    w.f(1, int(v != 0))
                    if v:
                        w.su(7, v)
    if seq.enable_cdef or seq.enable_restoration:
        raise ValueError("CDEF and loop restoration are not written")
    if not h.coded_lossless:
        w.f(1, h.tx_mode_select)
    w.f(1, h.reduced_tx_set)
    if seq.film_grain_params_present:
        w.f(1, 0)


def frame_obu(seq, h, tiles: list) -> bytes:
    """OBU_FRAME's payload: the header, then one tile group of every
    tile."""
    w = BitWriter()
    frame_header(w, seq, h)
    w.byte_align()
    if len(tiles) > 1:
        w.f(1, 0)                    # tile_start_and_end_present_flag
        w.byte_align()
    out = bytearray(w.data())
    for i, t in enumerate(tiles):
        if i < len(tiles) - 1:
            out += (len(t) - 1).to_bytes(h.tile_size_bytes, "little")
        out += t
    return bytes(out)


def tile_size_bytes(tiles: list) -> int:
    """The fewest bytes that hold every tile's size less one but the last
    (libaom's remux of its 4-byte sizes)."""
    most = max((len(t) - 1 for t in tiles[:-1]), default=0)
    return max(1, (most.bit_length() + 7) // 8)


def temporal_unit(seq, h, tiles: list) -> bytes:
    """What libavif stores as an item: a temporal delimiter, the sequence
    header and the frame OBU."""
    return (obu(OBU_TEMPORAL_DELIMITER, b"")
            + obu(OBU_SEQUENCE_HEADER, sequence_header(seq))
            + obu(OBU_FRAME, frame_obu(seq, h, tiles)))
