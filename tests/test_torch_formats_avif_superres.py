"""Superres AVIF in the port (assets/av1_superres.py, with the coded width
in av1_obu.py, av1_loopfilter.py and av1_restoration.py) against PIL
12.1's AVIF plugin (libavif 1.3.0 with dav1d 1.5.1), which the JAX
package's load_image uses:

  - every committed fixture of tests/data/formats_avif_superres (written
    by tests/torch_avif_superres.py, as PIL's save writes no superres
    file): load_image equals the JAX package's bit for bit;
  - the committed files are the generator's output, and PIL decodes them
    to chip_smoke.AVIF_SUPERRES_SHA256 under dav1d's default CPU flags
    and under none (its C functions alike);
  - what the fixtures reach: every denominator 9-16, 4:2:0, 4:4:4, 4:2:2
    and 4:0:0 at 8, 10 and 12 bits, an odd width, coded widths off the
    8-sample grid, the 16-sample floor, tile columns, 64 and 128
    superblocks, CDEF, film grain, an alpha item, a sequence, lossless
    frames, and Wiener, self-guided and switchable restoration at each
    unit size the header allows, every unit kind coded;
  - the upscale filter equal to dav1d's table in PIL's libavif; a sample
    with two frames refused by name; save_image writing no superres;
  - a seeded sweep of single bit flips: PIL's image or both raise.

``PYTHONPATH=. python tests/test_torch_formats_avif_superres.py --sweep
N SEED`` runs N seeded flips in each fixture against PIL and prints what
differs. One thread, no card."""

import glob
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_avif_superres as gen
import torch_libavif as la
from plainrenderer_tpu_torch.assets import (av1_decode, av1_obu,
                                            av1_obu_write, av1_superres,
                                            avif_write, isobmff)
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats_avif import _payload, _same

torch.set_num_threads(1)
FIXTURES = gen.FIXTURES
NAMES = sorted(p.name for p in FIXTURES.glob("*.avif"))


def _headers(data: bytes):
    """The colour frame's sequence and frame headers."""
    f = isobmff.parse(data)
    if f.tracks and data[8:12] == b"avis":
        off, size = f.tracks[0].first_sample(len(data))
        pl = data[off:off + size]
    else:
        pl = _payload(data)
    seq = hdr = None
    for t, tid, sid, s, e in av1_obu.obus(pl):
        if t == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(pl, s, e)
        elif t == av1_obu.OBU_FRAME:
            hdr = av1_obu.frame_header(pl, s, e, seq)[0]
    return seq, hdr, pl


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_jax(tmp_path, name):
    """The port's load_image of each superres fixture is the JAX
    package's (PIL's decode) bit for bit."""
    data = (FIXTURES / name).read_bytes()
    got = _same(tmp_path, data)
    assert got is not None, "PIL reads every fixture"
    seq, hdr, _ = _headers(data)
    assert hdr.use_superres and got.shape[1] == hdr.upscaled_width


def test_committed_fixtures_are_the_generators_and_pils_digests():
    """tests/data/formats_avif_superres holds the generator's files (and
    nothing else), PIL decodes them to chip_smoke.AVIF_SUPERRES_SHA256 with
    dav1d's SIMD functions and with its C ones (conformant streams), and
    the folder stays under 200 KB."""
    import chip_smoke

    files = gen.fixture_files()
    assert NAMES == sorted(files)
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    assert gen.pil_digests(files) == chip_smoke.AVIF_SUPERRES_SHA256
    assert gen.pil_digests(files, 0) == chip_smoke.AVIF_SUPERRES_SHA256
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000


def test_fixtures_reach_every_superres_case():
    """The headers and the coded syntax of the committed files: each
    denominator, chroma format and bit depth, the floor (a 20-sample
    width coded at 16, and a 12-sample one kept at 12 with screen content
    tools, whose allow_intrabc dav1d does not read under superres, and
    restoration on its lossless frame), tiles, both superblock sizes,
    CDEF, grain, and each restoration type at each unit size."""
    denoms, formats, depths, lr = set(), set(), set(), set()
    units = set()
    seen = dict(odd=0, off_grid=0, floor=0, kept=0, tiles=0, sb64=0,
                sb128=0, cdef=0, grain=0, lossless=0)
    for name in NAMES:
        data = (FIXTURES / name).read_bytes()
        seq, h, pl = _headers(data)
        denoms.add(h.superres_denom)
        formats.add("400" if seq.mono else f"{seq.ssx}{seq.ssy}")
        depths.add(seq.bit_depth)
        seen["odd"] += h.upscaled_width % 2
        seen["off_grid"] += h.width % 8 != 0
        seen["floor"] += (h.upscaled_width * 8 + h.superres_denom // 2
                          ) // h.superres_denom < h.width < h.upscaled_width
        seen["kept"] += (h.width == h.upscaled_width
                         and h.allow_screen_content_tools)
        seen["tiles"] += h.tile_cols > 1
        seen["sb128" if seq.use_128 else "sb64"] += 1
        seen["cdef"] += h.cdef_on
        seen["grain"] += h.grain is not None
        seen["lossless"] += h.coded_lossless and h.uses_lr
        for p in range(seq.num_planes):
            if h.lr_type[p]:
                lr.add((h.lr_type[p], h.lr_size[p], seq.use_128))
        if seq.bit_depth == 8:
            rec = []
            av1_decode.decode(pl, record=rec)
            units |= {(e[0], e[2]) for t in rec for e in t
                      if e[0] in gen.LR_KINDS}
    assert denoms == set(range(9, 17))
    assert formats == {"11", "00", "10", "400"} and depths == {8, 10, 12}
    assert all(seen.values()), seen
    for kind in (1, 2, 3):                  # Wiener, self-guided, switchable
        for size, sb128 in ((64, 0), (128, 0), (256, 0), (128, 1), (256, 1)):
            assert (kind, size, sb128) in lr, (kind, size, sb128)
    assert units == {("use_wiener", 0), ("use_wiener", 1), ("use_sgrproj", 0),
                     ("use_sgrproj", 1), ("restoration_type", 0),
                     ("restoration_type", 1), ("restoration_type", 2)}


def test_upscale_filter_is_dav1ds():
    """dav1d's dav1d_resize_filter[64][8] (int8, negated) and libaom's
    av1_resize_filter_normative (int16) in PIL's libavif .so, each found
    by its first two rows, hold av1_superres.FILTERS."""
    so = glob.glob(os.path.join(la.LIBS, "libavif-*.so*"))[0]
    raw = Path(so).read_bytes()
    f = av1_superres.FILTERS
    at = raw.find((-f[:2]).astype(np.int8).tobytes())
    assert at >= 0
    np.testing.assert_array_equal(
        -np.frombuffer(raw, np.int8, 512, at).reshape(64, 8).astype(int), f)
    at = raw.find(f[:2].astype("<i2").tobytes())
    assert at >= 0
    np.testing.assert_array_equal(
        np.frombuffer(raw, "<i2", 512, at).reshape(64, 8), f)
    assert (f.sum(1) == 128).all()


def test_two_frames_in_one_sample_are_refused_by_name(tmp_path):
    """A sample holding a second frame (spatial layers need AV1 inter
    prediction, which the intra decoder does not carry) raises ValueError
    naming it."""
    for name in ("d16_floor_20.avif", "d11_400_odd.avif"):
        data = (FIXTURES / name).read_bytes()
        seq, h, pl = _headers(data)
        t, s, e = [(t, s, e) for t, _, _, s, e in av1_obu.obus(pl)][-1]
        assert t == av1_obu.OBU_FRAME
        frame = av1_obu_write.obu(t, pl[s:e])
        two = avif_write.write(h.upscaled_width, h.height, pl + frame, seq)
        p = tmp_path / "two.avif"
        p.write_bytes(two)
        with pytest.raises(ValueError, match="spatial layers"):
            tio.load_image(p)


def test_save_image_writes_no_superres(tmp_path):
    """save_image writes what PIL's save writes: superres off in the
    sequence header, so no frame uses it."""
    p = tmp_path / "plain.avif"
    tio.save_image(p, gen.picture(24, 16, 3))
    seq, h, _ = _headers(p.read_bytes())
    assert not seq.enable_superres and not h.use_superres
    assert h.width == h.upscaled_width == 24


@pytest.mark.parametrize("seed", range(3))
def test_bit_flips_match_jax(tmp_path, seed):
    """Single bit flips, seeded, in the 8-bit fixtures: PIL's image or
    both raise."""
    rng = np.random.default_rng(seed)
    small = [n for n in NAMES if not n.endswith(("_10.avif", "_12.avif"))]
    for k in range(4):
        data = bytearray((FIXTURES / small[(seed * 4 + k) % len(small)]
                          ).read_bytes())
        bit = int(rng.integers(0, len(data) * 8))
        data[bit >> 3] ^= 0x80 >> (bit & 7)
        _same(tmp_path, bytes(data), f"flip{k}.avif")


# ------------------------------- command line ------------------------------

def sweep_flips(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"differ": [], "cases": 0}
    for name in NAMES:
        data = (FIXTURES / name).read_bytes()
        for _ in range(n):
            buf = bytearray(data)
            bit = int(rng.integers(0, len(data) * 8))
            buf[bit >> 3] ^= 0x80 >> (bit & 7)
            try:
                with Image.open(io.BytesIO(bytes(buf))) as im:
                    want = np.asarray(im.convert("RGBA"))
            except Exception as e:  # noqa: BLE001
                want = e
            try:
                got = tio.decode_image(bytes(buf), name, ".avif")
            except ValueError as e:
                got = e
            out["cases"] += 1
            if isinstance(want, Exception) != isinstance(got, Exception) or (
                    not isinstance(want, Exception)
                    and not np.array_equal(want, got)):
                out["differ"].append((name, bit))
    return out


if __name__ == "__main__":
    if "--sweep" in sys.argv:
        i = sys.argv.index("--sweep")
        print(sweep_flips(int(sys.argv[i + 1]), int(sys.argv[i + 2])))
