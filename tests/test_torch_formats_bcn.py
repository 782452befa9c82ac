"""The port's BC6H and BC7 decoders (assets/bc6h.py, assets/bc7.py, reached
through assets/dds.py as DDS content under another suffix than .dds)
against PIL, which the JAX package's load_image uses, and the port's
Radiance .hdr reader against the JAX package's load_image:

  - seeded 16-byte blocks forced into every BC7 mode (and the reserved
    first byte 0), DXGI 97, 98 and 99, and into every BC6H mode and the
    four reserved ones, UF16 (95) and SF16 (96), each image equal to
    ``np.asarray(Image.open(p).convert("RGBA"))``; sizes that are not
    multiples of 4; truncated block data refused;
  - .hdr: the seed-6 files, every (mantissa, exponent) pair of RGBE and
    the header variants (FORMAT lines, EXPOSURE, orientations, widths
    under 8, run-length scanlines falling back to flat, truncation), each
    loaded by the port as by the JAX package, or refused by both;
  - the committed fixtures in tests/data/formats_bptc: BC6H and BC7 files
    beside PIL's decode as PNG, and a .hdr file beside the JAX package's
    load_image result as .npy (chip_smoke.py checks both on the card's
    machine, which has no PIL or imageio).

``python tests/test_torch_formats_bcn.py --write-fixtures`` regenerates
tests/data/formats_bptc. Numpy, PIL and imageio on small images.
"""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import bc6h, bc7
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats import _check, _pil

FIXTURES = Path(__file__).resolve().parent / "data" / "formats_bptc"
# BC6H's mode bits: the 2-bit modes 0 and 1, the 12 5-bit modes, and the
# four reserved 5-bit values
BC6H_CODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15)
BC6H_RESERVED = (19, 23, 27, 31)


def _dds(w, h, dxgi):
    return (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
            + bytes(44) + struct.pack("<II4sI", 32, 4, b"DX10", 0)
            + bytes(16) + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
            + struct.pack("<5I", dxgi, 3, 0, 1, 0))


def bc7_blocks(rng, n, modes):
    """n random blocks, block i forced into modes[i % len(modes)] (8: the
    reserved first byte 0)."""
    b = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    for i in range(n):
        m = modes[i % len(modes)]
        b[i, 0] = 0 if m == 8 else (int(b[i, 0]) >> (m + 1) << (m + 1)) \
            | (1 << m)
    return b.tobytes()


def bc6h_blocks(rng, n, codes):
    """n random blocks, block i's low mode bits set to codes[i % len]."""
    b = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    for i in range(n):
        c = codes[i % len(codes)]
        bits = 2 if c < 2 else 5
        b[i, 0] = (int(b[i, 0]) >> bits << bits) | c
    return b.tobytes()


def _blocks_for(w, h):
    return ((w + 3) // 4) * ((h + 3) // 4)


@pytest.mark.parametrize("mode", range(9))
def test_bc7_every_mode_equals_pil(mode):
    rng = np.random.default_rng(100 + mode)
    w, h = 64, 32
    _check(_dds(w, h, 98) + bc7_blocks(rng, _blocks_for(w, h), [mode]),
           ".tex")


@pytest.mark.parametrize("dxgi", [97, 99])
def test_bc7_typeless_and_srgb_read_unconverted(dxgi):
    rng = np.random.default_rng(dxgi)
    w, h = 32, 32
    data = bc7_blocks(rng, _blocks_for(w, h), list(range(9)))
    _check(_dds(w, h, dxgi) + data, ".bin")
    np.testing.assert_array_equal(
        tio.decode_image(_dds(w, h, dxgi) + data, "a", ".bin"),
        tio.decode_image(_dds(w, h, 98) + data, "a", ".bin"))


@pytest.mark.parametrize("dxgi", [95, 96])
@pytest.mark.parametrize("code", BC6H_CODES + BC6H_RESERVED)
def test_bc6h_every_mode_equals_pil(dxgi, code):
    rng = np.random.default_rng(1000 * dxgi + code)
    w, h = 32, 32
    _check(_dds(w, h, dxgi) + bc6h_blocks(rng, _blocks_for(w, h), [code]),
           ".tex")


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (13, 9), (4, 17)])
def test_sizes_not_multiples_of_4(size):
    w, h = size
    rng = np.random.default_rng(w * h)
    n = _blocks_for(w, h)
    _check(_dds(w, h, 98) + bc7_blocks(rng, n, list(range(9))), ".tex")
    for dxgi in (95, 96):
        _check(_dds(w, h, dxgi) + bc6h_blocks(
            rng, n, BC6H_CODES + BC6H_RESERVED), ".tex")


def test_truncated_blocks_are_refused():
    rng = np.random.default_rng(3)
    for dxgi in (95, 96, 98):
        data = _dds(8, 8, dxgi) + rng.integers(0, 256, 63, np.uint8).tobytes()
        assert isinstance(_pil(data), Exception)
        with pytest.raises(ValueError, match="truncated"):
            tio.decode_image(data, "case", ".tex")
    with pytest.raises(ValueError, match="BC7 data truncated"):
        bc7.decode_bc7(b"\0" * 15, 4, 4)
    with pytest.raises(ValueError, match="BC6H data truncated"):
        bc6h.decode_bc6h(b"\0" * 15, 4, 4, False)


# ------------------------------- .hdr --------------------------------

def _same_as_jax(path):
    """The port's load_image equals the JAX package's, dtype and values,
    or both raise."""
    try:
        want = jio.load_image(path)
    except Exception as e:  # noqa: BLE001 - any refusal drops the slot
        with pytest.raises(ValueError):
            tio.load_image(path)
        return e
    got = tio.load_image(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    return None


HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def test_hdr_every_rgbe_pair_as_jax(tmp_path):
    """All 65536 (mantissa, exponent) pairs, with three mantissas a texel,
    flat at 256 x 256, as the JAX package loads them."""
    m, e = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rgbe = np.stack([m, (m * 7) & 255, 255 - m, e], -1).astype(np.uint8)
    path = tmp_path / "pairs.hdr"
    path.write_bytes(HEAD + b"-Y 256 +X 256\n" + rgbe.tobytes())
    assert _same_as_jax(path) is None


def _rle_line(px):
    """One new-style scanline: each channel as literals of up to 128."""
    w = len(px)
    out = bytes([2, 2, w >> 8, w & 255])
    for c in range(4):
        v = px[:, c].tobytes()
        for i in range(0, w, 128):
            out += bytes([len(v[i:i + 128])]) + v[i:i + 128]
    return out


def hdr_variants():
    """name -> .hdr bytes: header and data variants the JAX package's
    imageio call reads or refuses here."""
    rng = np.random.default_rng(21)
    h, w = 5, 12
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(120, 136, (h, w))
    flat = px.tobytes()
    dims = b"-Y %d +X %d\n" % (h, w)
    return {
        "flat": HEAD + dims + flat,
        "rgbe_magic": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n" + dims + flat,
        "bare_magic": b"#?\nFORMAT=32-bit_rle_rgbe\n\n" + dims + flat,
        "no_format": b"#?RADIANCE\n\n" + dims + flat,
        "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n" + dims + flat,
        "exposure": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2.5\n"
                    b"GAMMA=2.2\n\n" + dims + flat,
        "format_after_blank": b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n"
                              + dims + flat,
        "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n"
                + dims + flat,
        "long_comment": b"#?RADIANCE\n#" + b"x" * 125
                        + b"\nFORMAT=32-bit_rle_rgbe\n\n" + dims + flat,
        "split_comment": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n#"
                         + b"x" * 126 + b"\n\n" + dims + flat,
        "plus_y": HEAD + b"+Y %d +X %d\n" % (h, w) + flat,
        "minus_x": HEAD + b"-Y %d -X %d\n" % (h, w) + flat,
        "x_first": HEAD + b"+X %d -Y %d\n" % (w, h) + flat,
        "spaced_dims": HEAD + b"-Y  %d   +X +%d extra\n" % (h, w) + flat,
        "zero_height": HEAD + b"-Y 0 +X %d\n" % w + flat,
        "negative_width": HEAD + b"-Y %d +X -%d\n" % (h, w) + flat,
        "truncated": HEAD + dims + flat[:-3],
        "trailing_bytes": HEAD + dims + flat + b"\0" * 9,
        "width_7_flat": HEAD + b"-Y 3 +X 7\n" + bytes([2, 2, 0, 7]) + flat,
        "rle": HEAD + dims + b"".join(_rle_line(r) for r in px),
        "rle_then_flat": HEAD + dims + _rle_line(px[0]) + px[1:].tobytes(),
        "rle_wrong_width": HEAD + dims + bytes([2, 2, 0, w + 1]) + flat,
        "rle_run_past_row": HEAD + dims + bytes([2, 2, 0, w, 128 + w + 1,
                                                 7]) + flat,
        "rle_zero_literal": HEAD + dims + bytes([2, 2, 0, w, 0]) + flat,
        "rle_truncated": HEAD + dims + _rle_line(px[0])[:-5]}


# the outcome the JAX package's imageio call has on each variant here
HDR_REFUSED = {"bare_magic", "no_format", "xyze", "format_after_blank",
               "crlf", "split_comment", "plus_y", "minus_x", "x_first",
               "zero_height", "negative_width", "truncated",
               "rle_wrong_width", "rle_run_past_row", "rle_zero_literal",
               "rle_truncated"}


@pytest.mark.parametrize("name", sorted(hdr_variants()))
def test_hdr_header_variants_as_jax(tmp_path, name):
    path = tmp_path / f"{name}.hdr"
    path.write_bytes(hdr_variants()[name])
    refused = _same_as_jax(path) is not None
    assert refused == (name in HDR_REFUSED), name


# ---------------------------- fixtures -------------------------------

def fixture_files() -> dict:
    """name -> bytes of the committed BC6H / BC7 fixtures (33 x 17: every
    mode and the reserved ones in one image) and the .hdr fixture."""
    rng = np.random.default_rng(2121)
    w, h = 33, 17
    n = _blocks_for(w, h)
    modes = list(range(9))
    codes = list(BC6H_CODES + BC6H_RESERVED)
    px = rng.integers(0, 256, (12, 20, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(124, 134, (12, 20))
    return {
        "bc7.tex": _dds(w, h, 98) + bc7_blocks(rng, n, modes),
        "bc7_srgb.dat": _dds(w, h, 99) + bc7_blocks(rng, n, modes),
        "bc6h_uf16.tex": _dds(w, h, 95) + bc6h_blocks(rng, n, codes),
        "bc6h_sf16.bin": _dds(w, h, 96) + bc6h_blocks(rng, n, codes),
        "radiance.hdr": HEAD + b"-Y 12 +X 20\n"
        + b"".join(_rle_line(r) for r in px)}


def write_fixtures():
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for old in FIXTURES.iterdir():
        old.unlink()
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        if name.endswith(".hdr"):
            np.save(FIXTURES / (name + ".npy"),
                    jio.load_image(FIXTURES / name))
            continue
        want = _pil(data)
        assert not isinstance(want, Exception), (name, want)
        Image.fromarray(want).save(FIXTURES / (name + ".png"))


def test_committed_bptc_fixtures_equal_pil_and_their_references():
    """Each committed BC6H / BC7 file decodes in the port as in PIL and
    equals the PNG beside it; the .hdr file loads in the port as in the
    JAX package and equals the .npy beside it (what chip_smoke.py checks
    without PIL or imageio); the set is fixture_files', under 40 KB."""
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if not p.name.endswith((".png", ".npy")))
    assert names == sorted(fixture_files())
    total = 0
    for name in names:
        data = (FIXTURES / name).read_bytes()
        assert data == fixture_files()[name], name
        got = tio.load_image(FIXTURES / name)
        if name.endswith(".hdr"):
            ref = FIXTURES / (name + ".npy")
            np.testing.assert_array_equal(got, np.load(ref))
            np.testing.assert_array_equal(got, jio.load_image(FIXTURES / name))
        else:
            ref = FIXTURES / (name + ".png")
            np.testing.assert_array_equal(got, tio.load_image(ref))
            np.testing.assert_array_equal(got, _pil(data), err_msg=name)
        total += len(data) + ref.stat().st_size
    assert total < 40_000


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    else:
        sys.exit("run with pytest, or with --write-fixtures")
