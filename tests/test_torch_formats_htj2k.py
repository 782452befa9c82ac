"""HTJ2K (JPEG 2000 Part 15) code-blocks in the port (assets/j2k_ht.py,
through assets/j2k_t2.py's HT segment rules and assets/j2k_recon.py)
against PIL 12.1's decode (OpenJPEG 2.5.4's ht_dec.c), which the JAX
package's load_image uses. Nothing here writes HTJ2K but the test-side
writer tests/torch_htj2k_writer.py; the reference is always PIL's decode
of its bytes:

  - OpenJPEG's VLC tables, UVLC prefix table and MEL exponents found in
    PIL's libopenjp2 equal the port's copy;
  - the 5/3 and 9/7 paths, 1, 2 and 3 passes, code-blocks of 64 x 64,
    32 x 32, 1024 x 4 and 4 x 1024, stripe-causal blocks, 1, 3 and 4
    components, 8, 12 and 16 bits, tiles, precincts, every progression,
    two and three layers (passes spread by block, and refinement passes
    in a later layer, which OpenJPEG cannot read: both raise), JP2 and a
    bare codestream, ICNS elements: load_image equals the JAX package's
    bit for bit, or both raise;
  - malformed blocks: ROI, 4 passes, too many zero bit-planes, a
    refinement segment of zero length or without room (OpenJPEG warns
    and decodes the cleanup pass alone), MEL streams that OpenJPEG's
    first-word check refuses at some addresses only, Rsiz and CAP
    variants;
  - files cut at every marker, packet and codeword segment boundary, and
    a seeded sweep of 240 single-bit flips;
  - the committed fixtures in tests/data/formats_htj2k, each beside PIL's
    decode as PNG, and the courtyard's 12 textures as HTJ2K 9/7
    codestreams (courtyard/), whose PIL decodes have the digests
    chip_smoke.py holds the port to on the card's machine.

``PYTHONPATH=. python tests/test_torch_formats_htj2k.py --write-fixtures``
regenerates the fixtures and prints COURTYARD_HTJ2K_SHA256; ``--sweep N
SEED`` runs N seeded bit flips in each of the sweep's files against PIL
and prints what differs; with no flag it prints each fixture's decode
time. One thread, no card."""

import glob
import hashlib
import os
import struct
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import PIL
import pytest
import torch
from PIL import Image

import torch_htj2k_writer as W
from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import j2k_ht
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats import _picture, _pil
from test_torch_formats_j2k import _icns

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "formats_htj2k"
COURTYARD = FIXTURES / "courtyard"


def _same(tmp_path, data: bytes, name="case.j2k"):
    """The port's load_image is the JAX package's: the same array, or both
    raise (the port with ValueError). Returns the image or None."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        want = jio.load_image(p)
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        with pytest.raises(ValueError):
            tio.load_image(p)
        return None
    got = tio.load_image(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _img(w, h, c, prec=8, seed=0):
    a = _picture(w, h, c, seed).astype(np.int64)
    if prec > 8:
        rng = np.random.default_rng(seed)
        a = (a << (prec - 8)) | rng.integers(0, 1 << (prec - 8), a.shape)
    return a[..., 0] if c == 1 else a


# ------------------------------- the tables -------------------------------

def test_tables_are_openjpegs():
    """vlc_tbl0 / vlc_tbl1 (4096 bytes), the UVLC prefix table and the MEL
    exponents, found by content in PIL's libopenjp2, equal the port's."""
    lib = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                 "pillow.libs", "libopenjp2-*.so*"))[0]
    blob = Path(lib).read_bytes()
    tables = np.array(j2k_ht.VLC0 + j2k_ht.VLC1, "<u2").tobytes()
    at = blob.find(tables[:64])
    assert at > 0 and blob[at:at + 4096] == tables
    assert hashlib.sha256(tables).hexdigest() == j2k_ht.VLC_SHA256
    assert bytes(j2k_ht.UVLC) in blob
    assert struct.pack("<13i", *j2k_ht.MEL_EXP) in blob


# ----------------------------- configurations -----------------------------

CASES = {
    # name -> (w, h, components, precision, writer options)
    "53_1pass_64": (40, 24, 3, 8, dict(levels=2)),
    "53_2pass": (40, 24, 3, 8, dict(levels=2, passes=2, p_cup=1)),
    "53_3pass": (40, 24, 3, 8, dict(levels=2, passes=3, p_cup=1)),
    "53_3pass_p2": (33, 21, 1, 8, dict(levels=1, passes=3, p_cup=2)),
    "97_1pass": (48, 40, 3, 8, dict(levels=3, irreversible=True, step=2.0)),
    "97_2pass": (48, 40, 3, 8, dict(levels=3, irreversible=True, step=1.0,
                                    passes=2, p_cup=1)),
    "97_3pass_rgba": (37, 29, 4, 8, dict(levels=2, irreversible=True,
                                         step=0.5, passes=3, p_cup=2)),
    "cblk_32": (70, 40, 3, 8, dict(levels=1, cblk=(5, 5), passes=3,
                                   p_cup=1)),
    "cblk_1024x4": (90, 20, 1, 8, dict(levels=1, cblk=(10, 2))),
    "cblk_4x1024": (20, 90, 1, 8, dict(levels=1, cblk=(2, 10), passes=2,
                                      p_cup=1)),
    "cblk_8x8_vsc": (30, 27, 1, 8, dict(levels=2, cblk=(3, 3), passes=3,
                                       p_cup=1, vsc=True)),
    "grey": (25, 19, 1, 8, dict(levels=2)),
    "rgba": (25, 19, 4, 8, dict(levels=2, passes=2, p_cup=1)),
    "rgb_no_mct": (25, 19, 3, 8, dict(levels=2, mct=False)),
    "grey16": (33, 17, 1, 16, dict(levels=2, guard=3)),
    "grey16_97": (33, 17, 1, 16, dict(levels=2, irreversible=True,
                                      step=64.0, guard=3)),
    "grey12_3pass": (33, 17, 1, 12, dict(levels=2, passes=3, p_cup=1,
                                         guard=3)),
    "tiles": (50, 36, 3, 8, dict(levels=2, tile=(24, 20))),
    "tiles_97": (50, 36, 4, 8, dict(levels=1, irreversible=True, step=2.0,
                                    tile=(32, 16), passes=3, p_cup=1)),
    "precincts": (64, 48, 3, 8, dict(levels=2, precincts=(3, 3),
                                     cblk=(3, 3))),
    "layers_spread_2": (40, 24, 3, 8, dict(levels=2, layers=2, spread=True,
                                           passes=3, p_cup=1)),
    "layers_spread_3": (40, 24, 1, 8, dict(levels=2, layers=3, spread=True,
                                           cblk=(3, 3))),
    "layers_refine_later": (40, 24, 3, 8, dict(levels=2, layers=2,
                                               passes=3, p_cup=1)),
    "layers_2_cleanup_only": (40, 24, 3, 8, dict(levels=2, layers=2)),
    "no_levels": (19, 13, 3, 8, dict(levels=0)),
    "one_pixel": (1, 1, 3, 8, dict(levels=0)),
    "one_row": (37, 1, 1, 8, dict(levels=1)),
    "one_column": (1, 37, 1, 8, dict(levels=1, passes=3, p_cup=1)),
    "no_cap": (25, 19, 3, 8, dict(levels=2, cap=False, rsiz=0)),
    "rsiz_part15_no_cap": (25, 19, 3, 8, dict(levels=2, cap=False)),
    "jp2": (25, 19, 3, 8, dict(levels=2, jp2=True)),
    "jp2_rgba_97": (25, 19, 4, 8, dict(levels=2, jp2=True,
                                       irreversible=True, step=1.0)),
}
CASES.update({f"prog_{p}": (36, 28, 3, 8, dict(levels=2, prog=p,
                                               precincts=(4, 4),
                                               cblk=(3, 3), layers=2,
                                               spread=True))
              for p in range(5)})


@lru_cache(maxsize=None)
def _case_file(name) -> bytes:
    w, h, c, prec, kw = CASES[name]
    return W.encode_image(_img(w, h, c, prec, sum(map(ord, name))),
                          prec=prec, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_configurations_match_jax(tmp_path, name):
    """Each configuration: the JAX package's load_image bit for bit (or
    both raise: refinement passes in a later layer than their cleanup
    pass); the 5/3 single-pass files decode to the written pixels."""
    w, h, c, prec, kw = CASES[name]
    suffix = ".jp2" if kw.get("jp2") else ".j2k"
    got = _same(tmp_path, _case_file(name), "case" + suffix)
    assert (got is None) == (name == "layers_refine_later")
    if got is not None and prec == 8 and not kw.get("irreversible") \
            and kw.get("passes", 1) == 1:
        want = _img(w, h, c, prec, sum(map(ord, name)))
        np.testing.assert_array_equal(
            got[..., 0] if c == 1 else got[..., :c], want)


def test_icns_elements(tmp_path):
    """HTJ2K codestreams and JP2 files as ICNS elements."""
    for kw in ({}, {"jp2": True}, {"irreversible": True, "step": 2.0}):
        stream = W.encode_image(_img(32, 32, 3, seed=4), levels=2, **kw)
        for code in (b"ic11", b"ic07"):
            assert _same(tmp_path, _icns([(code, stream)]),
                         "a.icns") is not None


# ------------------------------ malformed blocks ----------------------------

def _zero_bplanes(k, segs, numbps):
    return (segs, 0) if k == 3 else (segs, numbps)


def _refinement_without_room(k, segs, numbps):
    return (segs + [(b"\x55\x66\x77", 2)], numbps) if k == 3 else (
        segs, numbps)


def _refinement_of_length_zero(k, segs, numbps):
    return (segs + [(b"", 2)], numbps) if k == 3 else (segs, numbps)


def _four_passes(k, segs, numbps):
    return ([segs[0], (segs[1][0], 3)], numbps) if k == 3 else (segs, numbps)


def _fewer_bplanes(k, segs, numbps):
    return (segs, numbps - 1) if k % 2 else (segs, numbps)


def _more_bplanes(k, segs, numbps):
    return (segs, numbps + 1) if k % 2 else (segs, numbps)


MALFORMED = {
    # name -> (writer options, raises)
    "roi": (dict(rgn=2), True),
    "roi_shift_0": (dict(rgn=0), False),
    "four_passes": (dict(passes=3, p_cup=1, tamper=_four_passes), True),
    "zero_bplanes_past_mb": (dict(tamper=_zero_bplanes), True),
    "refinement_without_room": (dict(tamper=_refinement_without_room),
                                False),
    "refinement_of_length_zero": (dict(tamper=_refinement_of_length_zero),
                                  False),
    "fewer_bplanes": (dict(tamper=_fewer_bplanes), True),
    "more_bplanes": (dict(tamper=_more_bplanes), False),
    "guard_7": (dict(irreversible=True, guard=7, step=1 / 1024), False),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_blocks(tmp_path, name):
    """Blocks OpenJPEG fails (PIL raises) or warns about and decodes
    (the cleanup pass alone): the port does the same."""
    kw, raises = MALFORMED[name]
    data = W.encode_image(_img(40, 24, 3, seed=9), levels=2, **kw)
    assert (_same(tmp_path, data) is None) == raises


def test_mel_check_depends_on_the_address(tmp_path):
    """0xFF then 0x95 at bytes 2-3 of the first block's MEL stream: OpenJPEG's
    mel_init checks only the bytes up to the next 4-byte boundary of the
    block's address in its buffer, so the same bytes fail or decode as
    earlier bytes (a first row padded by 0-7 pixels) move them."""
    outcomes = []
    for pad in range(8):
        img = np.full((64, 64), 128, np.int64)
        rng = np.random.default_rng(pad)
        img[rng.integers(0, 64, 6), rng.integers(0, 64, 6)] = 200
        img[0, :pad] = 90

        def tamper(k, segs, numbps):
            d = bytearray(segs[0][0])
            at = len(d) - ((d[-1] << 4) | (d[-2] & 15))
            if k == 0:
                d[at + 2:at + 4] = b"\xff\x95"
            return [(bytes(d), 1)] + segs[1:], numbps
        outcomes.append(_same(tmp_path, W.encode_image(
            img, levels=0, tamper=tamper)) is None)
    assert any(outcomes) and not all(outcomes), outcomes
    for align in range(4):   # the MEL bytes at the block's start
        try:
            j2k_ht._mel_check(bytes(2) + b"\xff\x95" + bytes(4), 8, 8,
                              align)
            fired = False
        except ValueError:
            fired = True
        assert fired == (align == 0), align


@pytest.mark.parametrize("body", [b"", b"\x00\x02", b"\x00\x02\x00\x00",
                                  b"\x00\x02\x00\x00\x00\x00\x12\x34"])
def test_cap_marker_bodies(tmp_path, body):
    """CAP marker segments of other lengths in the main header."""
    data = bytearray(_case_file("53_1pass_64"))
    at = data.index(b"\xff\x50")
    n = struct.unpack_from(">H", data, at + 2)[0]
    data[at:at + 2 + n] = b"\xff\x50" + struct.pack(">H", len(body) + 2) \
        + body
    _same(tmp_path, bytes(data))


# ------------------------------ cut and corrupt ----------------------------

@pytest.mark.parametrize("name", ["53_3pass", "97_2pass", "tiles",
                                  "layers_spread_2"])
def test_cut_files(tmp_path, name):
    """Files cut at marker, packet and codeword segment boundaries and one
    byte either side of each (every one, or every k-th past 150)."""
    w, h, c, prec, kw = CASES[name]
    layout = []
    data = W.encode_image(_img(w, h, c, prec, sum(map(ord, name))),
                          prec=prec, layout=layout, **kw)
    cuts = set()
    for at in layout:
        cuts.update((at - 1, at, at + 1))
    cuts = sorted(c for c in cuts if 0 < c < len(data))
    for k, cut in enumerate(cuts[::-(-len(cuts) // 150)]):   # <= 150
        _same(tmp_path, data[:cut], f"cut{k}.j2k")


SWEEP = ("53_1pass_64", "53_3pass", "97_2pass", "cblk_8x8_vsc")


def sweep_flips(n: int, seed: int) -> dict:
    """n seeded single-bit flips in each of SWEEP's files: how many decode
    equal to PIL's, raise in both, or differ (listed)."""
    out = {"equal": 0, "both raise": 0, "differ": []}
    for fi, name in enumerate(SWEEP):
        data = _case_file(name)
        rng = np.random.default_rng(seed * 100 + fi)
        for _ in range(n):
            bit = int(rng.integers(0, len(data) * 8))
            buf = bytearray(data)
            buf[bit >> 3] ^= 0x80 >> (bit & 7)
            want = _pil(bytes(buf))
            try:
                got = tio.decode_image(bytes(buf), "flip", ".j2k")
            except ValueError as e:
                got = e
            if isinstance(want, Exception) and isinstance(got, Exception):
                out["both raise"] += 1
            elif (not isinstance(want, Exception)
                  and not isinstance(got, Exception)
                  and np.array_equal(want, got)):
                out["equal"] += 1
            else:
                out["differ"].append((name, bit, repr(want)[:60],
                                      repr(got)[:60]))
    return out


def test_bit_flip_sweep():
    """240 seeded single-bit flips over four files (headers, packet
    headers and block data): PIL's image, or both raise."""
    res = sweep_flips(60, 1)
    assert not res["differ"], res["differ"][:5]
    assert res["equal"] + res["both raise"] == 240


# ------------------------------ fixtures ------------------------------

FIXTURE_CASES = {
    "lossless_53_rgb.j2k": "53_1pass_64",
    "three_pass_53.j2k": "53_3pass",
    "irreversible_97_two_pass.j2k": "97_2pass",
    "rgba_97_three_pass.j2k": "97_3pass_rgba",
    "grey16.j2k": "grey16",
    "cblk_1024x4.j2k": "cblk_1024x4",
    "stripe_causal_8x8.j2k": "cblk_8x8_vsc",
    "tiles_97.j2k": "tiles_97",
    "layers_spread.j2k": "layers_spread_2",
    "rpcl_precincts.j2k": "prog_2",
    "rgba.jp2": "jp2_rgba_97",
}


def fixture_files() -> dict:
    out = {name: _case_file(case) for name, case in FIXTURE_CASES.items()}
    out["cleanup_only_warning.j2k"] = W.encode_image(
        _img(40, 24, 3, seed=9), levels=2, tamper=_refinement_without_room)
    out["elements.icns"] = _icns([(b"ic11", W.encode_image(
        _img(32, 32, 3, seed=4), levels=2, passes=2, p_cup=1))])
    return out


# the courtyard's textures as 9/7 HTJ2K: the step scale (the 512 x 512
# stone maps coarser), chosen so the 12 files total under 300 KB
COURTYARD_STEP = {"stone": 1.5}


def courtyard_files() -> dict:
    """The courtyard's 12 textures as HTJ2K 9/7 codestreams (5 levels,
    64 x 64 blocks, one cleanup pass, the ICT on RGB)."""
    out = {}
    for png in sorted(DEMO.glob("*.png")):
        im = Image.open(png)
        im = np.asarray(im.convert("RGBA" if "A" in im.getbands()
                                   else "RGB"))
        step = COURTYARD_STEP.get(png.stem.split("_")[0], 1.0)
        out[png.stem + ".j2k"] = W.encode_image(im, irreversible=True,
                                                levels=5, step=step)
    return out


def write_fixtures():
    COURTYARD.mkdir(parents=True, exist_ok=True)
    for old in list(FIXTURES.glob("*")) + list(COURTYARD.glob("*")):
        if old.is_file():
            old.unlink()
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        want = _pil(data)
        assert not isinstance(want, Exception), (name, want)
        Image.fromarray(want).save(FIXTURES / (name + ".png"))
    for name, data in courtyard_files().items():
        (COURTYARD / name).write_bytes(data)
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    court = sum(p.stat().st_size for p in COURTYARD.iterdir())
    print(f"{len(list(FIXTURES.rglob('*')))} files, {total} bytes "
          f"(courtyard {court})")
    print("COURTYARD_HTJ2K_SHA256 = " + repr(courtyard_digests()))


def courtyard_digests() -> dict:
    """SHA-256 of PIL's RGBA decode of each committed courtyard file."""
    return {p.stem: hashlib.sha256(np.ascontiguousarray(np.asarray(
        Image.open(p).convert("RGBA"))).tobytes()).hexdigest()
        for p in sorted(COURTYARD.glob("*.j2k"))}


def test_committed_fixtures_equal_pil_and_their_pngs():
    """Each committed file decodes in the port as in PIL and equals the
    PNG of PIL's decode beside it; the set is the one fixture_files
    makes, byte for byte."""
    made = fixture_files()
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.is_file() and not p.name.endswith(".png"))
    assert names == sorted(made)
    for name in names:
        data = (FIXTURES / name).read_bytes()
        assert data == made[name], name
        got = tio.load_image(FIXTURES / name)
        np.testing.assert_array_equal(got, tio.load_image(
            FIXTURES / (name + ".png")), err_msg=name)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)


def test_courtyard_htj2k_digests_are_pils():
    """The 12 committed courtyard codestreams: PIL's decodes have the
    digests chip_smoke.COURTYARD_HTJ2K_SHA256 holds the port to on the
    card's machine; the port decodes the metal maps to them here (the
    rest on the card's machine, for time); the files total under 300 KB
    and the folder with them under 700 KB."""
    import chip_smoke

    assert courtyard_digests() == chip_smoke.COURTYARD_HTJ2K_SHA256
    assert sorted(p.name for p in COURTYARD.iterdir()) == sorted(
        p.stem + ".j2k" for p in DEMO.glob("*.png"))
    for p in sorted(COURTYARD.glob("metal_mr.j2k")):
        digest = hashlib.sha256(tio.load_image(p).tobytes()).hexdigest()
        assert digest == chip_smoke.COURTYARD_HTJ2K_SHA256[p.stem]
    assert sum(p.stat().st_size for p in COURTYARD.iterdir()) < 300_000
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 700_000


def print_decode_times():
    """Each committed file's host decode time (best of 3), in ms."""
    import time
    for path in sorted(FIXTURES.rglob("*")):
        if not path.is_file() or path.suffix == ".png":
            continue
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tio.load_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{path.relative_to(FIXTURES)}: {min(times):.2f} ms")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
    elif "--sweep" in sys.argv:   # --sweep N SEED
        i = sys.argv.index("--sweep")
        res = sweep_flips(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
        print(f"equal {res['equal']}, both raise {res['both raise']}, "
              f"differ {len(res['differ'])}")
        for d in res["differ"]:
            print(d)
    else:
        print_decode_times()
