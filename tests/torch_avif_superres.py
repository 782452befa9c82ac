"""Superres AVIF files for the AVIF tests (a helper, not collected): AV1
key frames coded at the reduced width with use_superres set, which PIL's
read (libavif 1.3.0 with dav1d 1.5.1) upscales and PIL's save cannot
write (libavif refuses libaom's superres options), so the port's own
encoder pieces write them:

  - the reduced still-picture sequence header, written here for
    profiles 0, 1 and 2 at 8 bits with superres on and CDEF, loop
    restoration and film grain as the fixture asks;
  - the frame header through assets/av1_obu_write.frame_header (its
    superres fields), with the CDEF, loop restoration and film grain
    parameters written here around it;
  - the tiles through assets/av1_block_encode.write_tiles with
    av1_encode.Planner: the partitions, modes and transform types from
    ``Seeded`` (a seeded source; libaom's quantizer, or the Walsh-Hadamard
    transform of a lossless frame) or from av1_intra_search.Search (the
    courtyard texture), every CDEF index and loop restoration unit from
    the seeded ``SeededFilters``;
  - the container through assets/avif_write.write with ispe at the
    upscaled size (an alpha item coded the same way), or a two-frame
    'avis' sequence PIL saves with its samples replaced; 10 and 12-bit
    copies through tests/torch_avif_depth.to_depth.

``PYTHONPATH=. python tests/torch_avif_superres.py`` rewrites
tests/data/formats_avif_superres and prints chip_smoke's
AVIF_SUPERRES_SHA256 (PIL's RGBA decodes, under dav1d's default CPU
flags and under none, which must agree)."""

import copy
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import torch_avif_depth
import torch_libavif
from plainrenderer_tpu_torch.assets import (av1_block_encode, av1_encode,
                                            av1_intra_search, av1_obu,
                                            av1_obu_write, avif_rgb2yuv,
                                            avif_write, isobmff)
from plainrenderer_tpu_torch.assets.av1_block import (BLOCK_DIMS, PART_NONE,
                                                      PART_SPLIT, TX_SETS,
                                                      UV_CFL)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "formats_avif_superres"
COURTYARD = REPO / "assets" / "demo" / "wood_albedo.png"
NONE, WIENER, SGRPROJ, SWITCHABLE = "none", "wiener", "sgrproj", "switchable"
LR_CODE = {NONE: 0, SWITCHABLE: 1, WIENER: 2, SGRPROJ: 3}
LR_KINDS = ("use_wiener", "use_sgrproj", "restoration_type")
PROFILE = {"420": 0, "400": 0, "444": 1, "422": 2}

# name: the upscaled size, the denominator, the chroma format, the
# superblock (sb128), tile columns and rows (log2), CDEF, each plane's
# restoration type with lr_shift and uv_shift, film grain, an alpha item,
# base_q_idx (0: lossless), screen content tools, where the decisions
# come from, the container and the extra bit depths (to_depth)
SPECS = {
    "d9_420_sb128_tiles": dict(
        width=200, height=96, denom=9, sb128=1, cols=1,
        lr=(WIENER, SGRPROJ, SWITCHABLE), lr_shift=1, depths=(12,)),
    "d10_444_lr64": dict(
        width=150, height=64, denom=10, fmt="444",
        lr=(SGRPROJ, SWITCHABLE, WIENER), lr_shift=0, depths=(10,)),
    "d10_420_sb128_lr256": dict(
        width=180, height=40, denom=10, sb128=1, cols=1,
        lr=(SGRPROJ, SWITCHABLE, WIENER), lr_shift=2),
    "d11_400_odd": dict(
        width=131, height=72, denom=11, fmt="400", lr=(WIENER,), lr_shift=2,
        depths=(12,)),
    "d12_420_alpha": dict(
        width=160, height=80, denom=12, alpha=True,
        lr=(SWITCHABLE, WIENER, SGRPROJ), lr_shift=2, alpha_lr=(SGRPROJ,),
        depths=(10,)),
    "d12_420_lossless": dict(
        width=64, height=32, denom=12, q=0, cdef=False,
        lr=(SWITCHABLE, WIENER, SGRPROJ), lr_shift=0),
    "d13_422_lr128": dict(
        width=144, height=64, denom=13, fmt="422",
        lr=(WIENER, SWITCHABLE, SGRPROJ), lr_shift=1, depths=(12,)),
    "d14_420_grain": dict(
        width=120, height=64, denom=14, grain=True,
        lr=(SGRPROJ, WIENER, SWITCHABLE), lr_shift=1, uv_shift=1,
        depths=(10,)),
    "d15_420_tiles": dict(
        width=200, height=130, denom=15, cols=1, rows=1,
        lr=(WIENER, SWITCHABLE, SGRPROJ), lr_shift=0),
    "d16_floor_20": dict(
        width=20, height=24, denom=16,
        lr=(SWITCHABLE, SGRPROJ, WIENER), lr_shift=0),
    "d16_floor_12_screen_lossless": dict(
        width=12, height=16, denom=16, fmt="444", q=0, cdef=False, screen=1,
        lr=(WIENER, SGRPROJ, SWITCHABLE), lr_shift=0),
    "d9_sequence": dict(
        width=96, height=48, denom=9, lr=(WIENER, SGRPROJ, SWITCHABLE),
        lr_shift=1, container="sequence"),
    "courtyard_d16": dict(
        width=200, height=128, denom=16, plan="search", source="courtyard",
        lr=(SWITCHABLE, SWITCHABLE, SWITCHABLE), lr_shift=1, depths=(10,)),
}
DEFAULTS = dict(fmt="420", sb128=0, cols=0, rows=0, cdef=True, lr=None,
                lr_shift=0, uv_shift=0, grain=False, alpha=False,
                alpha_lr=None, q=av1_encode.QINDEX, screen=0, plan="seeded",
                source="seeded", container="item", depths=())


def spec(name: str) -> SimpleNamespace:
    return SimpleNamespace(**{**DEFAULTS, **SPECS[name]})


def coded_width(width: int, denom: int) -> int:
    """The width a superres frame is coded at (dav1d's floor of 16)."""
    return max((width * 8 + denom // 2) // denom, min(16, width))


# ----------------------------------------------------------- pictures

def picture(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) u8: gradients, rings and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.hypot(x - w * 0.4, y - h * 0.6)
    chans = [x * 255 / max(w - 1, 1), 128 + 100 * np.sin(r / 4),
             (x + 2 * y) * 3 % 256]
    a = np.stack(chans, -1) + rng.normal(0, 8, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def courtyard(w: int, h: int, coded: int) -> np.ndarray:
    """The wood albedo's top-left w x h, narrowed to `coded` columns by
    linear interpolation."""
    from plainrenderer_tpu_torch.assets import image_io
    a = image_io.load_image(COURTYARD)[:h, :w, :3].astype(np.float64)
    xs = (np.arange(coded) + 0.5) * w / coded - 0.5
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    t = (xs - np.floor(xs))[None, :, None]
    return np.rint(a[:, x0] * (1 - t) + a[:, x1] * t).astype(np.uint8)


def planes(rgb: np.ndarray, fmt: str) -> list:
    """The Y[, U, V] planes of RGB8 pixels (BT.601 full range) in the
    chroma format."""
    if fmt == "420":
        return avif_rgb2yuv.rgb_to_yuv420(rgb)
    p = rgb.astype(np.int32)
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)
    if fmt == "400":
        return [y]
    if fmt == "422":
        q = np.pad(p, ((0, 0), (0, p.shape[1] & 1), (0, 0)), mode="edge")
        p = (q[:, 0::2] + q[:, 1::2] + 1) >> 1
        r, g, b = p[..., 0], p[..., 1], p[..., 2]
    u = (128 * b - 85 * g - 43 * r + 0x8000) >> 8
    v = (128 * r - 107 * g - 21 * b + 0x8000) >> 8
    return [y, u.astype(np.uint8), v.astype(np.uint8)]


# -------------------------------------------------------- decisions

class SeededFilters:
    """A mixin for a Plan: each CDEF index and every loop restoration
    unit's type and coefficients from a seeded generator. The restoration
    syntax of a superblock comes before its partition, starts with a
    symbol of LR_KINDS and goes on in bits; the CDEF index is the bits
    read after the first coded block's skip in a 64 x 64 area."""

    def seed_filters(self, rng):
        self.rng = rng
        self.lr = False
        self.free = 0

    def partition(self, td, r, c, bsize):
        self.lr = False
        super().partition(td, r, c, bsize)

    def symbol(self, name, cdf):
        if name[0] in LR_KINDS:
            self.lr = True
            n = len(cdf) - 1
            if n == 2:
                return int(self.rng.random() < 0.75)
            return int(self.rng.integers(0, n))
        self.lr = False
        v = super().symbol(name, cdf)
        if name[0] == "skip":
            td, h = self.td, self.td.h
            if (h.cdef_on and not h.coded_lossless and not v
                    and td.fs.cdef_idx[td.mi_row >> 4, td.mi_col >> 4] == -1):
                self.free = h.cdef_bits
        return v

    def bool(self, icdf0):
        if self.free:
            self.free -= 1
            return int(self.rng.integers(0, 2))
        if self.lr:
            return int(self.rng.integers(0, 2))
        return super().bool(icdf0)


def fwht4x4(res: np.ndarray) -> np.ndarray:
    """libaom's av1_fwht4x4 of a 4 x 4 residual, without its
    UNIT_QUANT_FACTOR: the levels of a lossless block."""
    def one(a1, b1, c1, d1):
        a1 = a1 + b1
        d1 = d1 - c1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 = a1 - c1
        d1 = d1 + b1
        return a1, c1, d1, b1
    x = np.asarray(res, np.int64)
    cols = np.stack(one(*x), 0)                  # rows: a1, c1, d1, b1
    return np.stack(one(*cols.T), 1)


class Seeded(SeededFilters, av1_encode.Plan):
    """Partitions, modes and transform types from a seeded generator; the
    coefficients libaom's forward transform and quantizer give for the
    decoder's own prediction (the Walsh-Hadamard transform where the
    frame is lossless)."""

    SPLIT = {128: 1.0, 64: 0.85, 32: 0.6, 16: 0.45, 8: 0.3}

    def __init__(self, src, rng, q):
        super().__init__(src)
        self.q = q
        self.seed_filters(rng)

    def choose_partition(self, td, r, c, bsize):
        w = BLOCK_DIMS[bsize][0]
        if td.seq.ssx != td.seq.ssy:
            # 4:2:2 has no chroma block for one taller than wide: no 4 x 4
            # blocks, and no vertical split at the right edge
            if w == 8:
                return PART_NONE
            if c + (w >> 3) >= td.h.mi_cols:
                return PART_SPLIT
        split = self.rng.random() < self.SPLIT[w]
        return PART_SPLIT if split else PART_NONE

    def choose_block(self, td):
        rng = self.rng
        return SimpleNamespace(
            y_mode=int(rng.integers(0, 13)),
            angles=[int(rng.integers(-3, 4)) for _ in range(2)],
            uv_mode=int(rng.integers(0, 13)), cfl_sign=int(rng.integers(0, 8)),
            cfl_alphas=[int(rng.integers(0, 16)) for _ in range(2)],
            filter_mode=(int(rng.integers(0, 5)) if rng.random() < 0.4
                         else None),
            tx_type=0, palette=None, tx_depth=int(rng.integers(0, 2)))

    def _answer(self, kind):
        if kind == "uv_mode_cfl" and self.rng.random() < 0.3:
            return UV_CFL
        return super()._answer(kind)

    def tx_block(self, td, x, y, plane, t):
        if plane == 0:
            types = [0] if td.lossless else sorted(TX_SETS[td._tx_set(t)])
            self.blk.tx_type = int(self.rng.choice(types))
        super().tx_block(td, x, y, plane, t)

    def levels(self, res, tt, t, plane, x, y):
        if self.td.lossless:
            return fwht4x4(res)
        return super().levels(res, tt, t, plane, x, y)


class Searched(SeededFilters, av1_intra_search.Search):
    """The port's intra search, the filters seeded."""

    def __init__(self, src, rng):
        super().__init__(src)
        self.seed_filters(rng)


# ---------------------------------------------------------- headers

def sequence_header(s, mono: bool) -> bytes:
    """A reduced still-picture sequence header at 8 bits, superres on."""
    fmt = "400" if mono else s.fmt
    w = av1_obu_write.BitWriter()
    wb = max(1, (s.width - 1).bit_length())
    hb = max(1, (s.height - 1).bit_length())
    profile = PROFILE[fmt]
    for n, v in ((3, profile), (1, 1), (1, 1),
                 (5, av1_encode.seq_level(s.width, s.height)), (4, wb - 1),
                 (4, hb - 1), (wb, s.width - 1), (hb, s.height - 1),
                 (1, s.sb128), (1, 1), (1, 1), (1, 1), (1, int(s.cdef)),
                 (1, int(s.lr is not None)), (1, 0)):     # high_bitdepth
        w.f(n, v)
    if profile != 1:
        w.f(1, int(fmt == "400"))
    w.f(1, 0)                           # color_description_present
    w.f(1, 1)                           # color_range
    if fmt == "420":
        w.f(2, 0)                       # chroma_sample_position
    if fmt != "400":
        w.f(1, 0)                       # separate_uv_delta_q
    w.f(1, int(s.grain and not mono))
    w.trailing_bits()
    return w.data()


def filter_params(s, seq, rng, lr) -> SimpleNamespace:
    """CDEF strengths, the restoration types and sizes, and film grain."""
    f = SimpleNamespace(lr=lr)
    f.damping, f.cdef_bits = int(rng.integers(0, 4)), int(rng.integers(1, 3))
    f.strengths = [[int(rng.integers(0, 16)), int(rng.integers(0, 4)),
                    int(rng.integers(0, 16)), int(rng.integers(0, 4))]
                   for _ in range(1 << f.cdef_bits)]
    f.grain = None
    if seq.film_grain_params_present:
        def points(n):
            xs = np.sort(rng.choice(256, n, replace=False))
            return [(int(v), int(rng.integers(0, 256))) for v in xs]
        g = SimpleNamespace(seed=int(rng.integers(0, 1 << 16)),
                            y=points(int(rng.integers(2, 7))),
                            cb=points(3), cr=points(2),
                            shift=int(rng.integers(0, 4)), lag=2,
                            ar_shift=int(rng.integers(0, 4)),
                            overlap=1, clip=0)
        n = 2 * g.lag * (g.lag + 1)
        g.ar = [[int(v) for v in rng.integers(100, 157, n + (k > 0))]
                for k in range(3)]
        g.mult = [[int(rng.integers(0, 256)), int(rng.integers(0, 256)),
                   int(rng.integers(0, 512))] for _ in range(2)]
        f.grain = g
    return f


def header_bits(s, seq, fh, f) -> list:
    """The frame header's bits: av1_obu_write's, with the CDEF and loop
    restoration parameters before read_tx_mode and the film grain
    parameters after it."""
    plain = copy.copy(seq)
    plain.enable_cdef = plain.enable_restoration = 0
    plain.film_grain_params_present = 0
    w = av1_obu_write.BitWriter()
    av1_obu_write.frame_header(w, plain, fh)
    tail = 1 + (not fh.coded_lossless)
    x = av1_obu_write.BitWriter()
    if seq.enable_cdef and not fh.coded_lossless:
        x.f(2, f.damping)
        x.f(2, f.cdef_bits)
        for ypri, ysec, uvpri, uvsec in f.strengths:
            x.f(4, ypri)
            x.f(2, ysec)
            if seq.num_planes > 1:
                x.f(4, uvpri)
                x.f(2, uvsec)
    if seq.enable_restoration:
        for t in f.lr:
            x.f(2, LR_CODE[t])
        if any(t != NONE for t in f.lr):
            if seq.use_128:
                x.f(1, s.lr_shift - 1)
            else:
                x.f(1, int(s.lr_shift > 0))
                if s.lr_shift:
                    x.f(1, s.lr_shift - 1)
            if seq.ssx and seq.ssy and any(t != NONE for t in f.lr[1:]):
                x.f(1, s.uv_shift)
    bits = w.bits[:-tail] + x.bits + w.bits[-tail:]
    g = f.grain
    if seq.film_grain_params_present:
        x = av1_obu_write.BitWriter()
        x.f(1, int(g is not None))
        if g is not None:
            x.f(16, g.seed)
            for pts in [g.y] + ([] if seq.mono else [None]):
                if pts is None:
                    x.f(1, 0)           # chroma_scaling_from_luma
                    break
                x.f(4, len(pts))
                for v, sc in pts:
                    x.f(8, v)
                    x.f(8, sc)
            if not seq.mono:
                for pts in (g.cb, g.cr):
                    x.f(4, len(pts))
                    for v, sc in pts:
                        x.f(8, v)
                        x.f(8, sc)
            x.f(2, g.shift)
            x.f(2, g.lag)
            for k in range(1 if seq.mono else 3):
                for v in g.ar[k]:
                    x.f(8, v)
            x.f(2, g.ar_shift)
            x.f(2, 0)                   # grain_scale_shift
            if not seq.mono:
                for m in g.mult:
                    x.f(8, m[0])
                    x.f(8, m[1])
                    x.f(9, m[2])
            x.f(1, g.overlap)
            x.f(1, g.clip)
        bits += x.bits
    return bits


def _parse(seq, bits) -> SimpleNamespace:
    w = av1_obu_write.BitWriter()
    w.bits = list(bits)
    w.byte_align()
    data = w.data()
    return av1_obu.frame_header(data, 0, len(data), seq)[0]


def code_frame(s, yuv: list, seed: int, mono: bool = False) -> tuple:
    """The temporal unit of one superres key frame of the planes (at the
    coded width) and its parsed sequence header."""
    rng = np.random.default_rng(seed)
    seq_bytes = sequence_header(s, mono)
    seq = av1_obu.sequence_header(seq_bytes, 0, len(seq_bytes))
    w0 = coded_width(s.width, s.denom)
    lossless = s.q == 0
    lf = 0 if lossless else av1_encode.lf_level(s.q)
    fh = SimpleNamespace(
        disable_cdf_update=0, allow_screen_content_tools=s.screen,
        force_integer_mv_bit=0, use_superres=1, superres_denom=s.denom,
        allow_intrabc=0, uniform_tile_spacing=1, tile_cols_log2=s.cols,
        tile_rows_log2=s.rows, context_update_tile_id=0, tile_size_bytes=4,
        mi_cols=2 * ((w0 + 7) >> 3), mi_rows=2 * ((s.height + 7) >> 3),
        base_q_idx=s.q, dq_y_dc=0, dq_u_dc=0, dq_u_ac=0, using_qmatrix=0,
        seg_enabled=0, delta_q_present=0, coded_lossless=int(lossless),
        lf_level=[lf] * 4, lf_sharpness=0, lf_delta_enabled=1,
        lf_delta_update=0, lf_ref_deltas=[1, 0, 0, 0, -1, 0, -1, -1],
        lf_mode_deltas=[0, 0], tx_mode_select=1, reduced_tx_set=0)
    lr = (s.alpha_lr or s.lr[:1]) if mono else s.lr
    f = filter_params(s, seq, rng, lr)
    hdr = _parse(seq, header_bits(s, seq, fh, f))
    assert (hdr.width, hdr.upscaled_width, hdr.use_superres) == (
        w0, s.width, 1) and yuv[0].shape == (s.height, w0)
    assert (hdr.tile_cols_log2, hdr.tile_rows_log2) == (s.cols, s.rows)
    src = av1_encode.padded_sources(yuv, seq, hdr)
    n = hdr.tile_cols * hdr.tile_rows
    if s.plan == "search":
        plans = [Searched(src, rng) for _ in range(n)]
    else:
        plans = [Seeded(src, rng, s.q) for _ in range(n)]
    tiles, _ = av1_block_encode.write_tiles(seq, hdr, plans,
                                            tile_decoder=av1_encode.Planner)
    fh.tile_size_bytes = av1_obu_write.tile_size_bytes(tiles)
    sizes = [len(t) for t in tiles]
    fh.context_update_tile_id = sizes.index(max(sizes))
    w = av1_obu_write.BitWriter()
    w.bits = header_bits(s, seq, fh, f)
    w.byte_align()
    if n > 1:
        w.f(1, 0)                       # tile_start_and_end_present_flag
        w.byte_align()
    out = bytearray(w.data())
    for i, t in enumerate(tiles):
        if i < n - 1:
            out += (len(t) - 1).to_bytes(fh.tile_size_bytes, "little")
        out += t
    unit = (av1_obu_write.obu(av1_obu.OBU_TEMPORAL_DELIMITER, b"")
            + av1_obu_write.obu(av1_obu.OBU_SEQUENCE_HEADER, seq_bytes)
            + av1_obu_write.obu(av1_obu.OBU_FRAME, bytes(out)))
    return unit, seq


def _content(s, seed: int) -> np.ndarray:
    w0 = coded_width(s.width, s.denom)
    if s.source == "courtyard":
        return courtyard(s.width, s.height, w0)
    return picture(w0, s.height, seed)


def _sequence(s, units: list, seq) -> bytes:
    """PIL's two-frame save at the upscaled size, its samples replaced by
    the units and its av1C boxes by the units' sequence header's."""
    from PIL import Image
    frames = [Image.fromarray(picture(s.width, s.height, k)) for k in (0, 1)]
    b = io.BytesIO()
    frames[0].save(b, "AVIF", save_all=True, append_images=frames[1:])
    data = bytearray(b.getvalue())
    for typ in (b"mvhd", b"tkhd", b"mdhd"):    # the save's clock: zeroed
        at = data.index(typ) + 8
        n = 16 if data[at - 4] == 1 else 8
        data[at:at + n] = bytes(n)
    data = bytes(data)
    track = isobmff.parse(data).tracks[0]
    start, _ = track.first_sample(len(data))
    spans = []
    for size in track.sample_sizes:
        spans.append((start, start + size))
        start += size
    for (a, e), unit in reversed(list(zip(spans, units))):
        data = torch_avif_depth.splice(data, a, e, unit)
    av1c = avif_write.av1c(seq)
    return data.replace(data[data.index(b"av1C") - 4:][:12], av1c)


def fixture_files() -> dict:
    """Every fixture's bytes by file name."""
    out = {}
    for k, name in enumerate(SPECS):
        s = spec(name)
        seed = 100 + 10 * k
        yuv = planes(_content(s, seed), s.fmt)
        unit, seq = code_frame(s, yuv, seed)
        if s.container == "sequence":
            second, _ = code_frame(s, planes(_content(s, seed + 1), s.fmt),
                                   seed + 1)
            data = _sequence(s, [unit, second], seq)
        elif s.alpha:
            w0 = coded_width(s.width, s.denom)
            alpha = picture(w0, s.height, seed + 2)[..., 1]
            aunit, aseq = code_frame(s, [alpha], seed + 2, mono=True)
            data = avif_write.write(s.width, s.height, unit, seq, aunit, aseq)
        else:
            data = avif_write.write(s.width, s.height, unit, seq)
        out[f"{name}.avif"] = data
        for depth in s.depths:
            out[f"{name}_{depth}.avif"] = torch_avif_depth.to_depth(data,
                                                                    depth)
    return out


# ------------------------------------------------------------- oracle

def pil_rgba(data: bytes):
    """PIL's RGBA decode, or None where PIL refuses the file."""
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGBA")))
    except Exception:  # noqa: BLE001 - PIL's refusal
        return None


def pil_digests(files: dict, mask: int = 0xFFFFFFFF) -> dict:
    """SHA-256 of PIL's RGBA decode of each file under the dav1d CPU
    mask (None where PIL refuses it)."""
    import hashlib
    torch_libavif.dav1d_cpu_mask(mask)
    try:
        out = {}
        for name, data in sorted(files.items()):
            a = pil_rgba(data)
            out[Path(name).stem] = (None if a is None else
                                    hashlib.sha256(a.tobytes()).hexdigest())
        return out
    finally:
        torch_libavif.dav1d_cpu_mask(0xFFFFFFFF)


def main():
    files = fixture_files()
    FIXTURES.mkdir(exist_ok=True)
    for p in FIXTURES.iterdir():
        p.unlink()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
    digests = pil_digests(files)
    assert digests == pil_digests(files, 0), "dav1d's C and SIMD paths differ"
    print("AVIF_SUPERRES_SHA256 = {")
    for k, v in digests.items():
        print(f'    "{k}": ' + (f'"{v[:32]}"\n        "{v[32:]}",' if v
                                else "None,"))
    print("}")


if __name__ == "__main__":
    main()
