"""AVIF writing in the port (assets/avif_write.py over avif_rgb2yuv.py,
av1_encode.py, av1_intra_search.py, av1_block_encode.py, av1_msac_encode.py,
av1_obu_write.py, av1_fwd_transform.py and av1_quantize.py) against the
JAX package's save_image, which is PIL 12.1's default AVIF save through
libavif 1.3.0 and libaom 3.12.1 (quality 75, speed 6, 4:2:0, full range),
at four levels:

  - A, every layer outside libaom's search, bit for bit: libavif's YUV and
    alpha planes (avifImageRGBToYUV through ctypes), the container around
    PIL's own AV1 payloads, the sequence header and the frame header
    (level, superblock size, tiling, deblocking levels, screen content
    tools; the fields libaom's search decides, tx_mode_select,
    allow_intrabc and the tile sizes, taken from PIL's file), the
    arithmetic coder, the quantiser against the library's
    aom_quantize_b_ssse3 / _32x32;
  - B, replay: every syntax element the port's decoder reads out of PIL's
    default file, written again by the port's tile writer, gives PIL's
    OBUs byte for byte; with libaom's trellis off, the port's forward
    transform, quantize_b and dropout, from the decoder's own prediction,
    give libaom's levels in every transform block libaom coded;
  - C, the pinned option sets P8 and P4 (below): the port's frame encoder
    (av1_encode.write_frame) with ``Pinned``'s decisions writes PIL's
    whole file byte for byte. Pinned fixes the block size, DC prediction
    and DCT; libaom's search still decides four things there that no
    option it accepts pins (libaom refuses tx-size-search-method and
    enable-tx-size-search), and each comes from libaom's file: the
    frame's tx_mode_select, the transform size of each 8 x 8 block (8 x 8
    or four 4 x 4, from a recording of the file's elements), the
    transform blocks its rate-distortion test leaves uncoded (from the
    same recording), and filter intra off in the sequence header (the
    option sets turn it off; the port's own headers keep it on). The
    tests count how many depths and uncoded blocks came from the
    recording;
  - D, PIL's defaults: the tile data is the port's own search. PIL's
    decode of the port's file, the port's load_image and the JAX
    load_image are equal, and equal the encoder's own reconstruction
    through the reader's YUV to RGB; on the 96 x 128 noise and gradient
    pictures the file is at most 1.35 times PIL's bytes and its RGB PSNR
    at least PIL's less 0.5 dB.

The pictures are test_torch_formats_webp_write.py's: L / RGB / opaque RGBA
/ RGBA noise, gradients and flat colour at 1 x 1, 7 x 13, 17 x 33 and
96 x 128. ``PYTHONPATH=. python tests/test_torch_formats_avif_write.py``
runs the 12 courtyard textures (levels A, B and D: sizes, PSNR, encode
seconds), a 1024 x 1024 picture at 1 and 8 threads (levels A and C),
prints the digests chip_smoke.py holds the port's saves to, and loads the
courtyard from the 12 port-written AVIF files. One thread, no card."""

import copy
import ctypes
import glob
import hashlib
import io
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import torch_libavif
from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import (av1_block, av1_block_encode,
                                            av1_decode, av1_encode,
                                            av1_fwd_transform, av1_msac,
                                            av1_msac_encode, av1_obu,
                                            av1_obu_write, av1_quantize,
                                            av1_transform, avif,
                                            avif_rgb2yuv, avif_write,
                                            avif_yuv, isobmff)
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats_webp_write import KINDS, MODES, SHAPES, _content

torch.set_num_threads(1)
DEMO = Path(__file__).resolve().parent.parent / "assets" / "demo"
TRELLIS_OFF = {"disable-trellis-quant": "1"}


def pinned(n: int) -> dict:
    """The pinned option set Pn: n x n blocks only, DC prediction only,
    DCT only, no trellis."""
    opts = {"min-partition-size": str(n), "max-partition-size": str(n)}
    for k in ("rect-partitions", "ab-partitions", "1to4-partitions",
              "directional-intra", "smooth-intra", "paeth-intra",
              "cfl-intra", "filter-intra", "palette", "intrabc",
              "angle-delta"):
        opts["enable-" + k] = "0"
    opts.update({"use-intra-dct-only": "1", "disable-trellis-quant": "1"})
    return opts


P8, P4 = pinned(8), pinned(4)
# what the tier-1 level C test takes from libaom's files per (n, mode):
# transform depths read, those that split, transform blocks zeroed
PINNED_FROM_LIBAOM = {
    (8, "RGB"): dict(taken=384, split=11, zeroed=0),
    (8, "RGBA"): dict(taken=34, split=5, zeroed=0),
    (4, "RGB"): dict(taken=0, split=0, zeroed=1),
    (4, "RGBA"): dict(taken=0, split=0, zeroed=0)}


def _pil(a, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="AVIF", **kw)
    return buf.getvalue()


def _rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _rgb(a):
    return a if a.ndim == 3 else np.repeat(a[..., None], 3, 2)


def _items(data: bytes) -> list:
    """The AV1 payloads of a file, the colour item's first."""
    f = isobmff.parse(data)
    return [isobmff.item_payload(data, f, f.items[k]) for k in sorted(f.items)]


def _planes(a) -> list:
    """The planes of each item the port codes: [Y, U, V] and [alpha]."""
    rgb = _rgb(a)
    out = [avif_rgb2yuv.rgb_to_yuv420(rgb)]
    alpha = avif_rgb2yuv.alpha_plane(rgb)
    if alpha is not None:
        out.append([alpha])
    return out


def _headers(payload: bytes):
    """The sequence and frame headers of a temporal unit, their bytes, and
    where the frame's tile group starts."""
    seq = hdr = None
    for typ, _, _, s, e in av1_obu.obus(payload):
        if typ == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload, s, e)
            seq_bytes = payload[s:e]
        elif typ == av1_obu.OBU_FRAME:
            hdr, end = av1_obu.frame_header(payload, s, e, seq)
            frame_bytes = payload[s:end]
    return seq, hdr, seq_bytes, frame_bytes, end


def _cases():
    return [(shape, mode, kind) for shape in SHAPES for mode in MODES
            for kind in KINDS]


# ------------------------------------------------------------- level A

@pytest.mark.parametrize("mode", MODES)
def test_yuv_and_alpha_planes_equal_libavif(mode):
    """avif_rgb2yuv against avifImageRGBToYUV (matrix 6, full range,
    4:2:0) and the alpha plane, on every seeded picture and on extremes."""
    rng = np.random.default_rng(9)
    pictures = [_content(k, s, mode) for s in SHAPES for k in KINDS]
    pictures.append(rng.choice([0, 255], (33, 65, 3 if mode in ("L", "RGB")
                                          else 4)).astype(np.uint8))
    for a in pictures:
        rgb = _rgb(a)
        planes, alpha = torch_libavif.rgb_to_yuv(rgb)
        for got, want in zip(avif_rgb2yuv.rgb_to_yuv420(rgb), planes):
            np.testing.assert_array_equal(got, want)
        ours = avif_rgb2yuv.alpha_plane(rgb)
        if rgb.shape[2] == 4 and (rgb[..., 3] != 255).any():
            np.testing.assert_array_equal(ours, alpha)
        else:
            assert ours is None


@pytest.mark.parametrize("mode", MODES)
def test_container_around_pil_payloads_is_pils_file(mode):
    """avif_write.write around PIL's own AV1 items gives PIL's file byte
    for byte (RGB, opaque RGBA without an alpha item, RGBA with one)."""
    for shape in SHAPES:
        for kind in KINDS:
            a = _content(kind, shape, mode)
            data = _pil(a)
            pays = _items(data)
            seqs = [av1_decode.decode(p).seq for p in pays]
            args = (pays[1], seqs[1]) if len(pays) > 1 else ()
            assert avif_write.write(shape[1], shape[0], pays[0], seqs[0],
                                    *args) == data, (shape, kind)


def _headers_equal(a, data):
    """The port's sequence header for each item of picture a is the one in
    PIL's file byte for byte, and its frame header too once the fields
    libaom's search decides (tx_mode_select, allow_intrabc, the tile
    sizes) are PIL's."""
    h, w = a.shape[:2]
    for planes, pay in zip(_planes(a), _items(data)):
        seq, hdr, seq_bytes, frame_bytes, _ = _headers(pay)
        ours_seq, ours = av1_encode.headers(w, h, len(planes) == 1, planes[0])
        assert av1_obu_write.sequence_header(ours_seq) == seq_bytes
        for k in ("tx_mode_select", "allow_intrabc", "context_update_tile_id",
                  "tile_size_bytes"):
            setattr(ours, k, getattr(hdr, k))
        wr = av1_obu_write.BitWriter()
        av1_obu_write.frame_header(wr, ours_seq, ours)
        wr.byte_align()
        assert wr.data() == frame_bytes


@pytest.mark.parametrize("mode", MODES)
def test_headers_equal_pils(mode):
    """_headers_equal on every seeded picture: level, superblock size,
    tiling, deblocking levels and screen content tools are PIL's."""
    for shape in SHAPES:
        for kind in KINDS:
            a = _content(kind, shape, mode)
            _headers_equal(a, _pil(a))


def test_libavif_tiling_does_not_depend_on_threads():
    """PIL passes max_threads to libavif; libavif's encode at PIL's
    settings (torch_libavif.encode, equal to PIL's save) gives the same
    tiles at 1 and 8 threads, so the port's bytes do not depend on it
    either; the port's rule gives those tiles on sizes across the rule's
    steps."""
    for w, h in ((64, 64), (528, 17), (17, 600), (1100, 1), (4033, 1)):
        a = np.full((h, w, 3), 90, np.uint8)
        tiles = set()
        for threads in (1, 8):
            data = torch_libavif.encode(a, mc=6, quality=75,
                                        max_threads=threads)
            if threads == 8:
                assert data == _pil(a, max_threads=8)
            hdr = _headers(_items(data)[0])[1]
            tiles.add((hdr.tile_cols_log2, hdr.tile_rows_log2))
        assert tiles == {av1_encode.tile_log2s(w, h)}, (w, h)


def test_arithmetic_encoder_round_trips():
    """av1_msac_encode against the decoder: seeded symbols over adapting
    CDFs of 2 to 16 symbols and bits at fixed probabilities, then the
    decoder's exit check (a 1 bit, then zeros)."""
    rng = np.random.default_rng(4)
    for trial in range(40):
        ns = [int(v) for v in rng.integers(2, 17, 5)]
        cdfs = [sorted((int(v) for v in rng.choice(
            np.arange(1, 32768), n - 1, replace=False)), reverse=True)
            + [0, 0] for n in ns]
        ops = []
        for _ in range(int(rng.integers(0, 2000))):
            if rng.random() < 0.7:
                i = int(rng.integers(0, 5))
                ops.append((0, i, int(rng.integers(0, ns[i]))))
            else:
                ops.append((1, int(rng.integers(1, 512)) * 64,
                            int(rng.integers(0, 2))))
        enc = av1_msac_encode.SymbolEncoder()
        ec = copy.deepcopy(cdfs)
        for kind, a, v in ops:
            enc.symbol(ec[a], v) if kind == 0 else enc.bool_prob(a, v)
        data = enc.done()
        dec = av1_msac.SymbolDecoder(data, 0, len(data), False)
        dc = copy.deepcopy(cdfs)
        for kind, a, v in ops:
            got = dec.symbol(dc[a]) if kind == 0 else dec.bool_prob(a)
            assert got == v, trial
        assert dec.trailing_ok(), trial


def test_quantize_b_equals_libaom():
    """av1_quantize.quantize_b against aom_quantize_b_ssse3 and
    aom_quantize_b_32x32_ssse3 (log scales 0 and 1) on seeded
    coefficients within the 16-bit range the 8-bit transforms give."""
    lib = ctypes.CDLL(glob.glob(os.path.join(torch_libavif.LIBS,
                                             "libavif-*.so*"))[0])
    rng = np.random.default_rng(1)
    for q in (1, 20, 64, 64, 130, 255):
        p = av1_quantize.params(q)

        def arr(k):
            return (ctypes.c_int16 * 8)(*([p[k][0]] + [p[k][1]] * 7))
        for ls, fn in ((0, lib.aom_quantize_b_ssse3),
                       (1, lib.aom_quantize_b_32x32_ssse3)):
            n = 64 if ls == 0 else 1024
            for scale in (60, 600, 9000, 32767):
                c = rng.integers(-scale, scale + 1, n)
                qc = (ctypes.c_int32 * n)()
                dq = (ctypes.c_int32 * n)()
                eob = (ctypes.c_uint16 * 1)()
                order = (ctypes.c_int16 * n)(*range(n))
                fn((ctypes.c_int32 * n)(*map(int, c)), ctypes.c_ssize_t(n),
                   arr("zbin"), arr("round"), arr("quant"), arr("shift"),
                   qc, dq, (ctypes.c_int16 * 8)(*([p["step"][0]]
                                                  + [p["step"][1]] * 7)),
                   eob, order, order)
                got = av1_quantize.quantize_b(c.reshape(-1, 8 if ls == 0
                                                        else 32), q, ls)
                np.testing.assert_array_equal(got.ravel(), np.array(qc[:]))


def test_forward_transforms_invert_through_the_decoder():
    """Every forward transform type and size, dequantized at step 1 and
    put through the decoder's inverse, gives back its residual within the
    transforms' rounding (the 64-point sizes keep their low 32 x 32)."""
    rng = np.random.default_rng(2)
    for t, (w, h) in enumerate(av1_block.TX_DIMS):
        types = range(16) if max(w, h) <= 16 else (
            (0, 9) if max(w, h) == 32 else (0,))
        for tt in types:
            if tt >= 9 and max(w, h) > 32:
                continue
            yy, xx = np.mgrid[0:h, 0:w]
            res = (xx * 3 - yy * 2 + rng.integers(-8, 9, (h, w))) % 120 - 60
            co = av1_fwd_transform.forward_2d(res, tt)
            back = av1_transform.inverse_2d(co, w.bit_length() - 1,
                                            h.bit_length() - 1, tt, False, 8)
            corr = np.corrcoef(back.ravel(), res.ravel())[0, 1]
            assert corr > (0.9 if max(w, h) == 64 else 0.995), (w, h, tt, corr)


# ------------------------------------------------------------- level B

@pytest.mark.parametrize("mode", MODES)
def test_replay_writes_pils_obus(mode):
    """The elements the decoder reads out of each item of PIL's default
    save, written back through the tile decoder with a Replay source,
    give the item's temporal unit byte for byte; the tile size bytes are
    libaom's remux."""
    for shape, _, kind in [c for c in _cases() if c[1] == mode]:
        for pay in _items(_pil(_content(kind, shape, mode))):
            rec = []
            fr = av1_decode.decode(pay, record=rec)
            tiles, _ = av1_block_encode.write_tiles(
                fr.seq, fr.hdr, [av1_block_encode.Replay(r) for r in rec])
            assert av1_obu_write.temporal_unit(fr.seq, fr.hdr, tiles) == pay
            if len(tiles) > 1:
                assert av1_obu_write.tile_size_bytes(tiles) == \
                    fr.hdr.tile_size_bytes


class _Levels(av1_block.TileDecoder):
    """A tile decoder that quantizes each transform block from its own
    prediction as the port's encoder does and compares with the levels it
    then reads."""

    def _coeffs(self, x, y, plane, t):
        tw, th = av1_block.TX_DIMS[t]
        pred = self.fs.planes[plane][y:y + th, x:x + tw].astype(np.int64)
        eob = super()._coeffs(x, y, plane, t)
        if not eob:
            self.stats["zero"] += 1
            return eob
        tt = self.plane_tx_type
        res = self.src[plane][y:y + th, x:x + tw] - pred
        lv = av1_encode.Plan.levels(self, res, tt, t, plane, x, y)
        got = np.zeros_like(lv)
        for pos, v in self.quant.items():
            got.flat[pos] = v
        self.stats["coded"] += 1
        assert np.array_equal(got, lv), (plane, x, y, t, tt)
        return eob


def _check_levels(a, options) -> dict:
    stats = dict(coded=0, zero=0)
    data = torch_libavif.encode(_rgb(a), mc=6, quality=75, options=options)
    assert data == _pil(a, advanced=options, max_threads=1)
    for planes, pay in zip(_planes(a), _items(data)):
        seq, hdr, _, _, start = _headers(pay)
        fs = av1_block.FrameState(seq, hdr)
        fs.cdfs = av1_block.default_cdfs(hdr.base_q_idx)
        src = av1_encode.padded_sources(planes, seq, hdr)
        r = av1_obu.BitReader(pay, start, len(pay))
        n = hdr.tile_cols * hdr.tile_rows
        if n > 1:
            r.f(1)
        r.byte_align()
        p = r.byte_pos()
        for t in range(n):
            row, col = divmod(t, hdr.tile_cols)
            if t == n - 1:
                size = len(pay) - p
            else:
                size = int.from_bytes(pay[p:p + hdr.tile_size_bytes],
                                      "little") + 1
                p += hdr.tile_size_bytes
            sd = av1_msac.SymbolDecoder(pay, p, size, hdr.disable_cdf_update)
            td = _Levels(fs, copy.deepcopy(fs.cdfs), sd,
                         hdr.mi_row_starts[row], hdr.mi_row_starts[row + 1],
                         hdr.mi_col_starts[col], hdr.mi_col_starts[col + 1])
            td.src, td.stats, td.q = src, stats, hdr.base_q_idx
            td.decode()
            p += size
    return stats


@pytest.mark.parametrize("mode", MODES)
def test_trellis_off_levels_are_libaoms(mode):
    """With libaom's trellis off, the port's forward transform, quantize_b
    and dropout, from the prediction the decoder forms from libaom's own
    decisions, give the levels of every transform block libaom coded
    (the ones it left uncoded are its rate-distortion choices)."""
    for shape in SHAPES:
        for kind in KINDS:
            stats = _check_levels(_content(kind, shape, mode), TRELLIS_OFF)
            assert stats["coded"] + stats["zero"] > 0


# ------------------------------------------------------------- level C

class Pinned(av1_encode.Plan):
    """libaom's choices under a pinned option set: every block of one size
    (8 x 8 or 4 x 4 luma), DC prediction in every plane, DCT only. What
    libaom's search still decides there (an 8 x 8 block's transform
    size, a transform block its rate-distortion test leaves uncoded) is
    taken from ``libaom``, the elements a RecordingDecoder read from its
    file, in decoding order: ``taken`` counts the depths, ``split`` those
    that split the block's transform, ``zeroed`` the blocks zeroed."""

    def __init__(self, src, bsize: int, libaom: list):
        super().__init__(src)
        self.bsize = bsize
        self.depths = [e[2] for e in libaom if e[0] in ("tx8", "tx16")]
        self.skips = [e[2] for e in libaom if e[0] == "txb_skip"]
        self.taken = self.split = self.zeroed = 0

    def choose_partition(self, td, r, c, bsize):
        return (av1_block.PART_SPLIT if av1_block.BLOCK_DIMS[bsize][0] > self.bsize
                else av1_block.PART_NONE)

    def choose_block(self, td):
        depth = 0
        if self.depths:
            depth = self.depths.pop(0)
            self.taken += 1
            self.split += depth > 0
        return SimpleNamespace(
            y_mode=0, uv_mode=0, angles=[], cfl_sign=0, cfl_alphas=[],
            filter_mode=None, tx_type=0, palette=None, tx_depth=depth)

    def levels(self, res, tt, t, plane, x, y):
        lv = super().levels(res, tt, t, plane, x, y)
        if self.skips and self.skips.pop(0) and lv.any():
            lv[:] = 0
            self.zeroed += 1
        return lv


def _pinned_file(a, options, n):
    """The port's pinned encode of each item with libaom's open choices
    from PIL's save: (PIL's file, the port's file, {"taken", "split",
    "zeroed"} summed over the items' Pinned plans)."""
    data = _pil(a, advanced=options)
    h, w = a.shape[:2]
    items, counts = [], dict(taken=0, split=0, zeroed=0)
    for planes, pay in zip(_planes(a), _items(data)):
        rec = []
        fr = av1_decode.decode(pay, record=rec)
        seq, hdr = av1_encode.headers(w, h, len(planes) == 1, planes[0])
        seq.enable_filter_intra = 0
        hdr.tx_mode_select = fr.hdr.tx_mode_select
        plans = []

        def make(src, t):
            plans.append(Pinned(src, n, rec[t]))
            return plans[-1]
        items.append(av1_encode.write_frame(planes, seq, hdr, make).data)
        for k in counts:
            counts[k] += sum(getattr(p, k) for p in plans)
    seqs = [av1_decode.decode(x).seq for x in items]
    args = (items[1], seqs[1]) if len(items) > 1 else ()
    return data, avif_write.write(w, h, items[0], seqs[0], *args), counts


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pinned_encoder_writes_pils_file(n, mode):
    """P8 and P4: write_frame with Pinned's decisions writes PIL's whole
    file on the seeded pictures (L and opaque RGBA code as RGB does; RGBA
    up to 17 x 33 here, P4's RGB at 96 x 128 the gradient). Not the
    port's own: tx_mode_select and filter intra off come from libaom's
    file, and from its recording the transform depth of every 8 x 8 block
    (P8) and the transform blocks libaom's rate-distortion test left
    uncoded (one 4 x 4 block, P4's RGB gradient), counted exactly
    (PINNED_FROM_LIBAOM). The script runs every seeded picture and
    1024 x 1024."""
    counts = dict(taken=0, split=0, zeroed=0)
    for shape in SHAPES:
        for kind in KINDS:
            if shape == SHAPES[-1] and (mode == "RGBA" or (
                    n == 4 and kind != "gradient")):
                continue
            pil, ours, c = _pinned_file(_content(kind, shape, mode),
                                        P8 if n == 8 else P4, n)
            assert ours == pil, (shape, kind)
            for k in counts:
                counts[k] += c[k]
    assert counts == PINNED_FROM_LIBAOM[n, mode], counts


# ------------------------------------------------------------- level D

def _psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    m = float(np.mean(d * d))
    return 99.0 if m == 0 else 10 * np.log10(255.0 ** 2 / m)


def _recon_rgba(a) -> np.ndarray:
    """The encoder's own reconstruction of each item through the reader's
    YUV to RGBA."""
    color, alpha = avif_write.encode_frames(a)
    return avif_yuv.yuv_to_rgba(color.planes, 1, 1, True, 6,
                                None if alpha is None else alpha.planes[0],
                                False, 1)


@pytest.mark.parametrize("mode", MODES)
def test_save_image_avif_round_trips(tmp_path, mode):
    """save_image as .avif and .avifs (the same bytes) at PIL's defaults
    on the small seeded pictures: PIL's decode, the port's load_image and
    the JAX load_image agree bit for bit, and equal the encoder's own
    reconstruction."""
    for shape in SHAPES[:3]:
        for kind in KINDS:
            a = _content(kind, shape, mode)
            p, q = tmp_path / "a.avif", tmp_path / "a.avifs"
            tio.save_image(p, a)
            tio.save_image(q, a)
            data = p.read_bytes()
            assert q.read_bytes() == data
            pil = _rgba(data)
            np.testing.assert_array_equal(tio.load_image(p), pil)
            np.testing.assert_array_equal(np.asarray(jio.load_image(p)), pil)
            np.testing.assert_array_equal(_recon_rgba(a), pil)


@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_default_save_bounds_against_pil(kind):
    """At 96 x 128 RGB: the port's file decodes through PIL to the port's
    load_image, and is within 1.35 times PIL's bytes and 0.5 dB of PIL's
    RGB PSNR."""
    a = _content(kind, (96, 128), "RGB")
    ours, pil = avif_write.encode(a), _pil(a)
    got = _rgba(ours)
    np.testing.assert_array_equal(avif.read_avif(ours), got)
    assert len(ours) <= 1.35 * len(pil)
    assert _psnr(got[..., :3], a) >= _psnr(_rgba(pil)[..., :3], a) - 0.5


def test_save_image_refuses_what_pil_refuses(tmp_path):
    """A picture of zero size (PIL: invalid canvas dimensions) and a side
    above 65536 (libaom fails to encode it) raise and write nothing."""
    for shape in ((0, 4, 3), (4, 0), (1, 65537, 3)):
        a = np.zeros(shape, np.uint8)
        p = tmp_path / "x.avif"
        with pytest.raises(ValueError):
            tio.save_image(p, a)
        assert not p.exists()
        with pytest.raises((ValueError, RuntimeError)):
            _pil(a)


def test_chip_smoke_avif_writer_digests_are_the_ports():
    """chip_smoke.AVIF_WRITER_SHA256 and AVIF_WRITER_DECODED_SHA256, which
    the card's machine holds save_image's AVIF to, are what the port
    writes and reads here (the courtyard's two digests are checked by
    this file's __main__ run)."""
    import chip_smoke

    for suffix in chip_smoke.AVIF_WRITER_SIZES:
        for mode in ("L", "RGB", "RGBA"):
            key = f"{suffix} {mode}"
            data = avif_write.encode(chip_smoke.writer_image(suffix, mode))
            assert hashlib.sha256(data).hexdigest() == \
                chip_smoke.AVIF_WRITER_SHA256[key]
            assert hashlib.sha256(avif.read_avif(data).tobytes()).hexdigest() \
                == chip_smoke.AVIF_WRITER_DECODED_SHA256[key]
            np.testing.assert_array_equal(avif.read_avif(data), _rgba(data))


# ------------------------------------------- frames up to 16384 x 16384

def test_decoder_refuses_frames_above_libavifs_limit():
    """A 16385 x 16384 AV1 frame (header only) is refused by the port, as
    PIL refuses the file; libavif's limit is 16384 x 16384 samples."""
    w, h = 16385, 16384
    y = np.zeros((16, 16), np.uint8)
    seq, hdr = av1_encode.headers(w, h, True, y)
    hdr.tile_size_bytes = 1
    tiles = [b"\x00"] * (hdr.tile_cols * hdr.tile_rows)
    payload = av1_obu_write.temporal_unit(seq, hdr, tiles)
    with pytest.raises(ValueError, match="16384"):
        av1_decode.decode(payload)
    color = av1_obu_write.temporal_unit(seq, hdr, tiles)
    data = avif_write.write(w, h, color, seq)
    with pytest.raises(ValueError):
        avif.read_avif(data)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        _rgba(data)


@pytest.mark.slow
def test_flat_8200_frame_equals_pil():
    """A flat 8200 x 8200 RGB file PIL writes (above the port's former
    8192 x 8192 limit): the port's load_image equals PIL's decode. Slow:
    the decoder walks 16,900 superblocks in Python (about a minute) and
    PIL's encode takes half a minute."""
    a = np.empty((8200, 8200, 3), np.uint8)
    a[...] = (120, 60, 200)
    data = _pil(a)
    np.testing.assert_array_equal(avif.read_avif(data), _rgba(data))


# ---------------------------------------------------------- the script

def courtyard_textures():
    """The 12 courtyard textures as the App's copies hold them: RGBA, the
    RGB normal maps kept RGB."""
    out = {}
    for p in sorted(DEMO.glob("*.png")):
        with Image.open(p) as im:
            a = np.asarray(im.convert("RGBA"))
        out[p.stem] = a[..., :3] if (a[..., 3] == 255).all() and \
            "normal" in p.stem else a
    return out


def level_d(name, a) -> dict:
    """The port's default save against PIL's: bytes, RGB (and alpha)
    PSNR, the decodes equal, encode seconds."""
    t0 = time.perf_counter()
    ours = avif_write.encode(a)
    secs = time.perf_counter() - t0
    pil = _pil(a)
    got, ref = _rgba(ours), _rgba(pil)
    assert np.array_equal(avif.read_avif(ours), got), name
    rgb = _rgb(a)
    out = dict(name=name, bytes=len(ours), pil_bytes=len(pil),
               ratio=len(ours) / len(pil), psnr=_psnr(got[..., :3], rgb[..., :3]),
               pil_psnr=_psnr(ref[..., :3], rgb[..., :3]), encode_s=secs)
    if rgb.shape[2] == 4:
        out.update(alpha_psnr=_psnr(got[..., 3], rgb[..., 3]),
                   pil_alpha_psnr=_psnr(ref[..., 3], rgb[..., 3]))
    return out


def _print_d(r):
    s = (f"  {r['name']:18s} {r['bytes']:6d} B / PIL {r['pil_bytes']:6d} B "
         f"= {r['ratio']:.3f}x, RGB PSNR {r['psnr']:.2f} / {r['pil_psnr']:.2f}"
         f" dB ({r['psnr'] - r['pil_psnr']:+.2f})")
    if "alpha_psnr" in r:
        s += f", alpha {r['alpha_psnr']:.2f} / {r['pil_alpha_psnr']:.2f} dB"
    print(s + f", encode {r['encode_s']:.2f} s", flush=True)


def main():
    import chip_smoke

    print("level D, 96 x 128 seeded pictures:")
    for kind in ("noise", "gradient"):
        _print_d(level_d(kind, _content(kind, (96, 128), "RGB")))
    print("courtyard textures (levels A and B, then D):")
    for stem, a in courtyard_textures().items():
        data = _pil(a)
        _headers_equal(a, data)
        for pay in _items(data):
            rec = []
            fr = av1_decode.decode(pay, record=rec)
            tiles, _ = av1_block_encode.write_tiles(
                fr.seq, fr.hdr, [av1_block_encode.Replay(r) for r in rec])
            assert av1_obu_write.temporal_unit(fr.seq, fr.hdr, tiles) == pay
        stats = _check_levels(a, TRELLIS_OFF)
        _print_d(level_d(stem, a))
        print(f"    replay equal, trellis-off levels equal in "
              f"{stats['coded']} coded blocks", flush=True)
    for n in (8, 4):
        counts = dict(taken=0, split=0, zeroed=0)
        for shape in SHAPES:
            for mode in MODES:
                for kind in KINDS:
                    pil, ours, c = _pinned_file(_content(kind, shape, mode),
                                                P8 if n == 8 else P4, n)
                    assert ours == pil, (n, shape, mode, kind)
                    for k in counts:
                        counts[k] += c[k]
        print(f"P{n}: all 48 seeded files equal to PIL's (from libaom's "
              f"files: {counts['taken']} transform depths, {counts['split']} "
              f"of them split, {counts['zeroed']} transform blocks zeroed by "
              f"its RD test)", flush=True)
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:1024, 0:1024]
    big = np.clip(np.stack([x // 4, y // 4, (x + y) // 8], -1)
                  + rng.normal(0, 8, (1024, 1024, 3)), 0, 255).astype(np.uint8)
    for n in (8, 4):
        pil, ours, c = _pinned_file(big, P8 if n == 8 else P4, n)
        assert ours == pil
        print(f"1024 x 1024: P{n} file equal to PIL's (from libaom's file: "
              f"{c['taken']} transform depths, {c['split']} of them split, "
              f"{c['zeroed']} transform blocks zeroed by its RD test)",
              flush=True)
    for threads in (1, 8):
        _headers_equal(big, _pil(big, max_threads=threads))
        print(f"1024 x 1024 at {threads} threads: headers and tiling equal",
              flush=True)
    print("the port's AVIF digests for chip_smoke.py (file, RGBA decode):")
    for suffix in chip_smoke.AVIF_WRITER_SIZES:
        for mode in ("L", "RGB", "RGBA"):
            data = avif_write.encode(chip_smoke.writer_image(suffix, mode))
            print(f'    "{suffix} {mode}": ("{hashlib.sha256(data).hexdigest()}", '
                  f'"{hashlib.sha256(avif.read_avif(data).tobytes()).hexdigest()}")')
    for stem in chip_smoke.COURTYARD_AVIF_WRITTEN:
        data = avif_write.encode(courtyard_textures()[stem])
        digest = hashlib.sha256(data).hexdigest()
        decoded = hashlib.sha256(avif.read_avif(data).tobytes()).hexdigest()
        print(f'    "{stem}": ("{digest}", "{decoded}")')
        assert digest == chip_smoke.COURTYARD_AVIF_WRITTEN_SHA256[stem]
        assert decoded == chip_smoke.COURTYARD_AVIF_WRITTEN_DECODED_SHA256[stem]
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        plain, names, save_ms = chip_smoke.courtyard_copy(Path(tmp),
                                                          "avif_written")
        assert len(names) == 12, names
        app = chip_smoke.runtime_app(torch.device("cpu"), 160, 96,
                                     scene_path=str(plain))
        slots = chip_smoke.courtyard_textures_reach_the_pool(app, str(plain))
        img = app.run_frame(chip_smoke.orbit_input(app)).cpu().numpy()
        assert slots == 12 and 0 < float(img.mean()) < 255, (slots,
                                                             img.mean())
        print(f"courtyard from 12 port-written AVIF files: {slots} slots, "
              f"a 160 x 96 frame of mean {float(img.mean()):.2f}; encodes "
              f"{sum(save_ms.values()) / 1e3:.1f} s", flush=True)


if __name__ == "__main__":
    main()
