"""AV1 OBUs: headers, the sequence header (reduced and full, with the
colour config and operating points) and the uncompressed header of an
intra frame with its tile info (the AV1 specification, sections 5.3-5.11
and 6.2-6.10, the syntax and the derived values decoding uses).

What an AVIF reader meets and this module refuses by name: inter frames
(an AVIF image or a sequence's first sample is a key frame) and
show_existing_frame as the first frame.
"""

from __future__ import annotations

from types import SimpleNamespace

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST, OBU_PADDING = 7, 8, 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
_REMAP_LR = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


class AV1Error(ValueError):
    """A malformed AV1 stream, or a coding tool the port does not decode
    (the message names it)."""


class BitReader:
    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.bit = pos * 8
        self.end = (len(data) if end is None else end) * 8

    def f(self, n: int) -> int:
        if self.bit + n > self.end:
            raise AV1Error("AV1 header runs past its OBU")
        v = 0
        for _ in range(n):
            v = (v << 1) | (self.data[self.bit >> 3] >> (7 - (self.bit & 7)) & 1)
            self.bit += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def le(self, n: int) -> int:
        return sum(self.f(8) << (8 * i) for i in range(n))

    def byte_align(self):
        self.bit = (self.bit + 7) & ~7

    def byte_pos(self) -> int:
        return self.bit >> 3


def leb128(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    for i in range(8):
        if pos >= len(data):
            raise AV1Error("truncated leb128")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos
    return v, pos


def obus(data: bytes):
    """(type, temporal_id, spatial_id, payload start, payload end) of each
    OBU in a temporal unit."""
    pos = 0
    while pos < len(data):
        h = data[pos]   # the forbidden bit is not checked, as in dav1d
        typ, ext, has_size = h >> 3 & 15, h >> 2 & 1, h >> 1 & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= len(data):
                raise AV1Error("truncated OBU header")
            tid, sid = data[pos] >> 5, data[pos] >> 3 & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise AV1Error("OBU runs past the sample")
        yield typ, tid, sid, pos, pos + size
        pos += size


def sequence_header(data: bytes, pos: int, end: int) -> SimpleNamespace:
    r = BitReader(data, pos, end)
    s = SimpleNamespace()
    s.profile = r.f(3)
    if s.profile > 2:
        raise AV1Error("AV1 seq_profile above 2")
    s.still_picture = r.f(1)
    s.reduced = r.f(1)
    if s.reduced and not s.still_picture:
        raise AV1Error("AV1 reduced still picture header on a sequence")
    s.timing_info_present = s.decoder_model_info_present = 0
    s.equal_picture_interval = 0
    s.op_idc = [0]
    s.decoder_model_present_for_op = [0]
    s.buffer_removal_time_length = 0
    s.frame_presentation_time_length = 0
    s.level = 0
    if s.reduced:
        s.level = r.f(5)
    else:
        s.timing_info_present = r.f(1)
        if s.timing_info_present:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                s.buffer_delay_length = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        initial_display_delay_present = r.f(1)
        count = r.f(5) + 1
        s.op_idc, s.decoder_model_present_for_op = [], []
        for _ in range(count):
            s.op_idc.append(r.f(12))
            level = r.f(5)
            if level > 7:
                r.f(1)
            present = 0
            if s.decoder_model_info_present:
                present = r.f(1)
                if present:
                    r.f(s.buffer_delay_length)
                    r.f(s.buffer_delay_length)
                    r.f(1)
            s.decoder_model_present_for_op.append(present)
            if initial_display_delay_present and r.f(1):
                r.f(4)
    wbits, hbits = r.f(4) + 1, r.f(4) + 1
    s.frame_width_bits, s.frame_height_bits = wbits, hbits
    s.max_width, s.max_height = r.f(wbits) + 1, r.f(hbits) + 1
    s.frame_id_numbers_present = 0 if s.reduced else r.f(1)
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.f(4) + 2
        s.frame_id_length = r.f(3) + 1 + s.delta_frame_id_length
    s.use_128 = r.f(1)
    s.enable_filter_intra = r.f(1)
    s.enable_intra_edge_filter = r.f(1)
    s.force_screen_content_tools = 2
    s.force_integer_mv = 2
    s.order_hint_bits = 0
    if not s.reduced:
        r.f(1)  # interintra compound
        r.f(1)  # masked compound
        r.f(1)  # warped motion
        r.f(1)  # dual filter
        enable_order_hint = r.f(1)
        if enable_order_hint:
            r.f(1)
            r.f(1)
        if r.f(1):
            s.force_screen_content_tools = 2
        else:
            s.force_screen_content_tools = r.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = 2 if r.f(1) else r.f(1)
        if enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = r.f(1)
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    # colour_config
    high = r.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = 0 if s.profile == 1 else r.f(1)
    s.num_planes = 1 if s.mono else 3
    s.color_description_present = r.f(1)
    if s.color_description_present:
        s.cp, s.tc, s.mc = r.f(8), r.f(8), r.f(8)
    else:
        s.cp = s.tc = s.mc = 2
    s.csp = 0
    s.separate_uv_delta_q = 0
    if s.mono:
        s.color_range = r.f(1)
        s.ssx = s.ssy = 1
    elif s.cp == 1 and s.tc == 13 and s.mc == 0:
        s.color_range = 1
        s.ssx = s.ssy = 0
    else:
        s.color_range = r.f(1)
        if s.profile == 0:
            s.ssx = s.ssy = 1
        elif s.profile == 1:
            s.ssx = s.ssy = 0
        elif s.bit_depth == 12:
            s.ssx = r.f(1)
            s.ssy = r.f(1) if s.ssx else 0
        else:
            s.ssx, s.ssy = 1, 0
        if s.ssx and s.ssy:
            s.csp = r.f(2)
    if s.mc == 0 and not s.mono and (s.ssx or s.ssy):
        raise AV1Error("AV1 identity matrix with subsampled chroma")
    if not s.mono:
        s.separate_uv_delta_q = r.f(1)
    s.film_grain_params_present = r.f(1)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(data: bytes, pos: int, end: int, seq, tid: int = 0,
                 sid: int = 0) -> tuple[SimpleNamespace, int]:
    """The uncompressed header of an intra frame; returns it and the byte
    position after it (byte aligned, as a FRAME OBU's tile group starts)."""
    r = BitReader(data, pos, end)
    h = SimpleNamespace()
    if seq.reduced:
        h.frame_type, h.show_frame, h.showable_frame = KEY_FRAME, 1, 0
        error_resilient = 1
    else:
        if r.f(1):
            raise AV1Error("AV1 show_existing_frame as the first frame")
        h.frame_type = r.f(2)
        if h.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            raise AV1Error("AV1 inter frame (an AVIF image is a key frame)")
        h.show_frame = r.f(1)
        if (h.show_frame and seq.decoder_model_info_present
                and not seq.equal_picture_interval):
            r.f(seq.frame_presentation_time_length)
        h.showable_frame = (h.frame_type != KEY_FRAME if h.show_frame
                            else r.f(1))
        if h.frame_type == KEY_FRAME and h.show_frame:
            error_resilient = 1
        else:
            error_resilient = r.f(1)
    h.disable_cdf_update = r.f(1)
    if seq.force_screen_content_tools == 2:
        h.allow_screen_content_tools = r.f(1)
    else:
        h.allow_screen_content_tools = seq.force_screen_content_tools
    h.force_integer_mv_bit = 0
    if h.allow_screen_content_tools and seq.force_integer_mv == 2:
        h.force_integer_mv_bit = r.f(1)
    if seq.frame_id_numbers_present:
        r.f(seq.frame_id_length)
    frame_size_override = 0 if seq.reduced else r.f(1)
    r.f(seq.order_hint_bits)
    if seq.decoder_model_info_present:
        if r.f(1):
            for op, idc in enumerate(seq.op_idc):
                if seq.decoder_model_present_for_op[op]:
                    in_t = idc >> tid & 1
                    in_s = idc >> (sid + 8) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(seq.buffer_removal_time_length)
    if not (h.frame_type == KEY_FRAME and h.show_frame):
        refresh = r.f(8)
        if refresh != 0xFF and error_resilient and seq.order_hint_bits:
            for _ in range(8):
                r.f(seq.order_hint_bits)
    # frame_size, superres_params, render_size
    if frame_size_override:
        h.width = r.f(seq.frame_width_bits) + 1
        h.height = r.f(seq.frame_height_bits) + 1
    else:
        h.width, h.height = seq.max_width, seq.max_height
    h.use_superres = r.f(1) if seq.enable_superres else 0
    h.superres_denom = r.f(3) + 9 if h.use_superres else 8
    h.upscaled_width = h.width
    h.width = (h.upscaled_width * 8 + h.superres_denom // 2) // h.superres_denom
    if h.use_superres:
        # dav1d's (and libaom's) floor: at least 16 samples, or the width
        h.width = max(h.width, min(16, h.upscaled_width))
    h.mi_cols = 2 * ((h.width + 7) >> 3)
    h.mi_rows = 2 * ((h.height + 7) >> 3)
    h.render_size_different = r.f(1)
    if h.render_size_different:
        r.f(16)
        r.f(16)
    h.allow_intrabc = 0
    # dav1d tests use_superres where the specification compares the
    # widths: they differ only below the floor's 16 samples, where
    # superres keeps the width
    if h.allow_screen_content_tools and not h.use_superres:
        h.allow_intrabc = r.f(1)
    h.disable_frame_end_update_cdf = (1 if seq.reduced or h.disable_cdf_update
                                      else r.f(1))
    _tile_info(r, seq, h)
    # quantization_params
    h.base_q_idx = r.f(8)

    def delta_q():
        return r.su(7) if r.f(1) else 0
    h.dq_y_dc = delta_q()
    h.dq_u_dc = h.dq_u_ac = h.dq_v_dc = h.dq_v_ac = 0
    if seq.num_planes > 1:
        diff_uv = r.f(1) if seq.separate_uv_delta_q else 0
        h.dq_u_dc, h.dq_u_ac = delta_q(), delta_q()
        if diff_uv:
            h.dq_v_dc, h.dq_v_ac = delta_q(), delta_q()
        else:
            h.dq_v_dc, h.dq_v_ac = h.dq_u_dc, h.dq_u_ac
    h.using_qmatrix = r.f(1)
    h.qm_y = h.qm_u = h.qm_v = 15
    if h.using_qmatrix:
        h.qm_y, h.qm_u = r.f(4), r.f(4)
        h.qm_v = r.f(4) if seq.separate_uv_delta_q else h.qm_u
    # segmentation_params
    h.seg_enabled = r.f(1)
    h.seg_feature = [[0] * 8 for _ in range(8)]
    h.seg_data = [[0] * 8 for _ in range(8)]
    if h.seg_enabled:
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    h.seg_feature[i][j] = 1
                    bits, lim = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-lim, min(lim, r.su(1 + bits)))
                    else:
                        v = max(0, min(lim, r.f(bits)))
                    h.seg_data[i][j] = v
    h.seg_id_pre_skip = 0
    h.last_active_seg_id = 0
    for i in range(8):
        for j in range(8):
            if h.seg_feature[i][j]:
                h.last_active_seg_id = i
                if j >= 5:
                    h.seg_id_pre_skip = 1
    # delta_q_params, delta_lf_params
    h.delta_q_present = h.delta_q_res = 0
    h.delta_lf_present = h.delta_lf_res = h.delta_lf_multi = 0
    if h.base_q_idx > 0:
        h.delta_q_present = r.f(1)
    if h.delta_q_present:
        h.delta_q_res = r.f(2)
        if not h.allow_intrabc:
            h.delta_lf_present = r.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = r.f(1)
    h.coded_lossless = 1
    h.lossless = []
    h.seg_qm_level = []
    for sid_ in range(8):
        q = qindex(h, sid_, h.base_q_idx, True)
        ll = (q == 0 and h.dq_y_dc == 0 and h.dq_u_ac == 0 and h.dq_u_dc == 0
              and h.dq_v_ac == 0 and h.dq_v_dc == 0)
        h.lossless.append(ll)
        if not ll:
            h.coded_lossless = 0
        if h.using_qmatrix and not ll:
            h.seg_qm_level.append((h.qm_y, h.qm_u, h.qm_v))
        else:
            h.seg_qm_level.append((15, 15, 15))
    h.all_lossless = h.coded_lossless and not h.use_superres   # as dav1d
    # loop_filter_params
    h.lf_level = [0, 0, 0, 0]
    h.lf_sharpness = 0
    h.lf_delta_enabled = 1
    h.lf_ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
    h.lf_mode_deltas = [0, 0]
    h.lf_delta_update = 0
    if not (h.coded_lossless or h.allow_intrabc):
        h.lf_level[0], h.lf_level[1] = r.f(6), r.f(6)
        if seq.num_planes > 1 and (h.lf_level[0] or h.lf_level[1]):
            h.lf_level[2], h.lf_level[3] = r.f(6), r.f(6)
        h.lf_sharpness = r.f(3)
        h.lf_delta_enabled = r.f(1)
        if h.lf_delta_enabled:
            h.lf_delta_update = r.f(1)
        if h.lf_delta_update:
            for i in range(8):
                if r.f(1):
                    h.lf_ref_deltas[i] = r.su(7)
            for i in range(2):
                if r.f(1):
                    h.lf_mode_deltas[i] = r.su(7)
    # cdef_params
    h.cdef_bits = 0
    h.cdef_damping = 3
    h.cdef_y_pri = [0]
    h.cdef_y_sec = [0]
    h.cdef_uv_pri = [0]
    h.cdef_uv_sec = [0]
    h.cdef_on = 0
    if not (h.coded_lossless or h.allow_intrabc or not seq.enable_cdef):
        h.cdef_on = 1
        h.cdef_damping = r.f(2) + 3
        h.cdef_bits = r.f(2)
        n = 1 << h.cdef_bits
        h.cdef_y_pri, h.cdef_y_sec = [0] * n, [0] * n
        h.cdef_uv_pri, h.cdef_uv_sec = [0] * n, [0] * n
        for i in range(n):
            h.cdef_y_pri[i] = r.f(4)
            sec = r.f(2)
            h.cdef_y_sec[i] = sec + (sec == 3)
            if seq.num_planes > 1:
                h.cdef_uv_pri[i] = r.f(4)
                sec = r.f(2)
                h.cdef_uv_sec[i] = sec + (sec == 3)
    # lr_params
    h.lr_type = [RESTORE_NONE] * 3
    h.lr_size = [256, 256, 256]
    h.uses_lr = 0
    if not (h.all_lossless or h.allow_intrabc or not seq.enable_restoration):
        chroma_lr = 0
        for i in range(seq.num_planes):
            h.lr_type[i] = _REMAP_LR[r.f(2)]
            if h.lr_type[i] != RESTORE_NONE:
                h.uses_lr = 1
                if i > 0:
                    chroma_lr = 1
        if h.uses_lr:
            if seq.use_128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            h.lr_size[0] = 256 >> (2 - shift)
            uv_shift = r.f(1) if (seq.ssx and seq.ssy and chroma_lr) else 0
            h.lr_size[1] = h.lr_size[2] = h.lr_size[0] >> uv_shift
    # read_tx_mode
    if h.coded_lossless:
        h.tx_mode_select = 0
    else:
        h.tx_mode_select = r.f(1)
    h.reduced_tx_set = r.f(1)
    _film_grain(r, seq, h)
    r.byte_align()
    return h, r.byte_pos()


def qindex(h, segment_id: int, current: int, ignore_delta: bool) -> int:
    """get_qindex: the segment's q index (ALT_Q feature) or the current."""
    if h.seg_enabled and h.seg_feature[segment_id][0]:
        q = h.base_q_idx + h.seg_data[segment_id][0]
        if not ignore_delta and h.delta_q_present:
            q = current + h.seg_data[segment_id][0]
        return max(0, min(255, q))
    if not ignore_delta and h.delta_q_present:
        return current
    return h.base_q_idx


def _tile_info(r: BitReader, seq, h):
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
    col_starts, row_starts = [], []
    h.uniform_tile_spacing = r.f(1)
    if h.uniform_tile_spacing:
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and r.f(1):
            cols_log2 += 1
        w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [s << sb_shift for s in range(0, sb_cols, w)]
        min_log2_rows = max(min_log2_tiles - cols_log2, 0)
        rows_log2 = min_log2_rows
        while rows_log2 < max_log2_rows and r.f(1):
            rows_log2 += 1
        hh = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [s << sb_shift for s in range(0, sb_rows, hh)]
    else:
        widest = 0
        start = 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        if min_log2_tiles > 0:
            area = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            area = sb_rows * sb_cols
        max_height = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_height)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    h.tile_cols, h.tile_rows = len(col_starts), len(row_starts)
    h.mi_col_starts = col_starts + [h.mi_cols]
    h.mi_row_starts = row_starts + [h.mi_rows]
    h.tile_cols_log2, h.tile_rows_log2 = cols_log2, rows_log2
    h.tile_size_bytes = 4
    h.context_update_tile_id = 0
    if cols_log2 or rows_log2:
        h.context_update_tile_id = r.f(rows_log2 + cols_log2)
        h.tile_size_bytes = r.f(2) + 1


def _points(r: BitReader, most: int) -> list:
    """A film grain scaling function's points, values increasing."""
    n = r.f(4)
    if n > most:
        raise AV1Error("AV1 film grain with too many points")
    pts = []
    for _ in range(n):
        v = r.f(8)
        if pts and pts[-1][0] >= v:
            raise AV1Error("AV1 film grain points out of order")
        pts.append((v, r.f(8)))
    return pts


def _film_grain(r: BitReader, seq, h):
    h.grain = None
    if not seq.film_grain_params_present or not (h.show_frame
                                                 or h.showable_frame):
        return
    if not r.f(1):
        return
    g = SimpleNamespace()
    g.seed = r.f(16)
    if h.frame_type == INTER_FRAME:
        raise AV1Error("AV1 inter frame (an AVIF image is a key frame)")
    g.y_points = _points(r, 14)
    g.chroma_from_luma = 0 if seq.mono else r.f(1)
    g.cb_points, g.cr_points = [], []
    if not (seq.mono or g.chroma_from_luma
            or (seq.ssx and seq.ssy and not g.y_points)):
        g.cb_points = _points(r, 10)
        g.cr_points = _points(r, 10)
        if seq.ssx and seq.ssy and bool(g.cb_points) != bool(g.cr_points):
            raise AV1Error("AV1 film grain with points for one chroma plane")
    g.scaling_shift = r.f(2) + 8
    g.ar_lag = r.f(2)
    npos = 2 * g.ar_lag * (g.ar_lag + 1)
    g.ar_y = []
    if g.y_points:
        g.ar_y = [r.f(8) - 128 for _ in range(npos)]
        npos_c = npos + 1
    else:
        npos_c = npos
    g.ar_cb = ([r.f(8) - 128 for _ in range(npos_c)]
               if g.chroma_from_luma or g.cb_points else [])
    g.ar_cr = ([r.f(8) - 128 for _ in range(npos_c)]
               if g.chroma_from_luma or g.cr_points else [])
    g.ar_shift = r.f(2) + 6
    g.grain_scale_shift = r.f(2)
    g.cb_mult = g.cb_luma_mult = g.cb_offset = 0
    g.cr_mult = g.cr_luma_mult = g.cr_offset = 0
    if g.cb_points:
        g.cb_mult, g.cb_luma_mult, g.cb_offset = r.f(8), r.f(8), r.f(9)
    if g.cr_points:
        g.cr_mult, g.cr_luma_mult, g.cr_offset = r.f(8), r.f(8), r.f(9)
    g.overlap = r.f(1)
    g.clip_restricted = r.f(1)
    h.grain = g
