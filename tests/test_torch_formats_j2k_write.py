"""JPEG 2000 writing in the port (assets/j2k_encode.py over j2k_fdwt.py,
j2k_t1_encode.py and j2k_t2_encode.py; jp2.encode_jp2; pdf.py's RGBA)
against the JAX package's save_image, which is PIL 12.1's default save
through its bundled OpenJPEG 2.5.4:

  - save_image byte for byte: L, RGB and RGBA at 1 x 1, 1 x 37, 37 x 1,
    9 x 13, 12 x 300, 33 x 40, 64 x 64, 65 x 129 and 96 x 128, each
    constant (empty code-blocks), a 0 / 255 checkerboard (every
    bit-plane), seeded noise, gradients and a picture with zeros in its
    last channel (alpha for RGBA); the six suffixes and upper-case ones
    (PIL writes a bare codestream only where the name ends in ".j2k");
    PDF's RGBA at a frozen ``time.gmtime``; every file read back by the
    port's load_image to the array;
  - each module alone: the forward 5/3 against the decoder's inverse,
    the MQ coder against a line-by-line transcription of mqc.c's encoder,
    the tier-1 symbols against a scan-order loop over the code-block (the
    flags of t1.c, one coefficient at a time) and its bytes through
    j2k_t1.decode_cblk, the packet header's bit writer through j2k_t2.Bio
    and its tag trees through j2k_t2.TagTree;
  - the digests chip_smoke.py holds the port to on the card's machine
    (which has no PIL): PIL's saves of the 12 courtyard textures as JP2
    (the RGB normal maps kept RGB), COURTYARD_JP2_WRITTEN_SHA256.

``PYTHONPATH=. python tests/test_torch_formats_j2k_write.py`` prints those
digests and the host time of the port's encode and decode of a 512 x 512
RGBA courtyard map. One thread, no card."""

import hashlib
import io
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu_torch.assets import (j2k_encode, j2k_fdwt, j2k_recon,
                                            j2k_t1, j2k_t1_encode, j2k_t2,
                                            j2k_t2_encode, jp2)
from plainrenderer_tpu_torch.assets import image_io as tio
from test_torch_formats import _picture

torch.set_num_threads(1)
DEMO = Path(__file__).resolve().parent.parent / "assets" / "demo"
SHAPES = [(1, 1), (1, 37), (37, 1), (9, 13), (12, 300), (33, 40), (64, 64),
          (65, 129), (96, 128)]
CONTENTS = ["constant", "checker", "noise", "gradient", "zeros"]
SUFFIXES = [".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c"]
CLOCK = time.gmtime(1_700_000_000)


def _content(kind: str, shape, mode: str, seed: int) -> np.ndarray:
    h, w = shape
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    y, x = np.mgrid[0:h, 0:w]
    if kind == "constant":
        a = np.full((h, w, c), 77 + 50 * np.arange(c) % 256)
    elif kind == "checker":
        a = np.repeat((((x + y) % 2) * 255)[..., None], c, -1)
    elif kind == "noise":
        a = np.random.default_rng(seed).integers(0, 256, (h, w, c))
    elif kind == "gradient":
        a = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                      (x + y) * 3 % 256, 255 - x * y % 256][:c], -1)
    else:  # a picture with a fifth of its last channel 0
        a = _picture(w, h, c, seed)
        a[..., -1][np.random.default_rng(seed).random((h, w)) < 0.2] = 0
    a = a.astype(np.uint8)
    return a[..., 0] if c == 1 else a


def _rgba(a: np.ndarray) -> np.ndarray:
    """What load_image gives for a file of `a`."""
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    if a.shape[2] == 3:
        a = np.concatenate([a, np.full(a.shape[:2] + (1,), 255, np.uint8)],
                           -1)
    return a


def _saves(tmp_path, name: str, a: np.ndarray):
    """(the port's file, the JAX package's file) of `a` under `name`."""
    ours, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
    ours.parent.mkdir(exist_ok=True)
    theirs.parent.mkdir(exist_ok=True)
    tio.save_image(ours, a)
    jio.save_image(theirs, a)
    return ours, theirs


# ------------------------------ save_image ------------------------------

@pytest.mark.parametrize("kind", CONTENTS)
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_save_image_equals_pil(tmp_path, shape, mode, kind):
    """The port's bytes are PIL's; .j2k and .jp2 alternate by case, and
    the port reads the file back to the array."""
    a = _content(kind, shape, mode, sum(shape) + len(mode))
    suffix = ".j2k" if (SHAPES.index(shape) + len(kind)) % 2 else ".jp2"
    ours, theirs = _saves(tmp_path, "a" + suffix, a)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(tio.load_image(ours), _rgba(a))


@pytest.mark.parametrize("name", [f"a{s}" for s in SUFFIXES]
                         + ["b.J2K", "c.J2k", "d.JP2", "e.Jpx"])
def test_every_suffix_equals_pil(tmp_path, name):
    """Every JPEG 2000 suffix, in any case, is PIL's file: a bare
    codestream for a name ending in ".j2k" only, JP2 boxes otherwise."""
    a = _content("zeros", (20, 27), "RGBA", 5)
    ours, theirs = _saves(tmp_path, name, a)
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    assert data.startswith(jp2.J2K_MAGIC if name.endswith(".j2k")
                           else jp2.JP2_MAGIC)


@pytest.mark.parametrize("shape", [(1, 1, 4), (9, 13, 4), (64, 80, 4)],
                         ids=str)
def test_pdf_rgba_equals_pil(tmp_path, shape):
    """PDF's RGBA: PIL's JPXDecode image object around the JP2 the port
    writes, at a frozen clock, byte for byte."""
    a = _content("zeros", shape[:2], "RGBA", shape[1])
    with mock.patch.object(time, "gmtime", lambda *a: CLOCK):
        ours, theirs = _saves(tmp_path, "page.pdf", a)
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    assert b"/JPXDecode\n/SMaskInData 1\n" in data
    assert jp2.encode_jp2(a) in data


# ------------------------------ the modules ------------------------------

@pytest.mark.parametrize("n", range(1, 10))
def test_fdwt53_lines_invert(n):
    """One line of every length up to 9, lows first at either parity:
    the decoder's inverse gives it back."""
    x = np.random.default_rng(n).integers(-300, 300, (5, n)).astype(np.int32)
    for cas in (0, 1):
        y = j2k_fdwt.fdwt53(x, cas)
        sn = (n + 1 - cas) // 2
        np.testing.assert_array_equal(j2k_recon._idwt53(y.copy(), sn, cas), x)


def _tile_component(w: int, h: int, numres: int):
    """Tile-component 0 of a one-component w x h image coded as PIL codes
    it but at `numres` resolutions."""
    cs, tcp = j2k_encode.coding_parameters(w, h, 1, numres)
    return j2k_t2.tile_geometry(cs, 0, tcp)[1][0]


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (13, 9), (64, 40),
                                  (65, 129)], ids=str)
def test_forward_dwt_inverts(size):
    """The whole tile-component's transform at PIL's resolutions and at
    4 (more than the small sides allow): the decoder's inverse gives the
    plane back."""
    w, h = size
    plane = np.random.default_rng(w * h).integers(
        -128, 128, (h, w)).astype(np.int32)
    for numres in {j2k_encode.num_resolutions(w, h), 4}:
        tc = _tile_component(w, h, numres)
        work = plane.copy()
        j2k_fdwt.forward_dwt(work, tc)
        if min(w, h) > 1:
            assert not np.array_equal(work, plane)
        j2k_recon._inverse_dwt(work, tc, numres, False)
        np.testing.assert_array_equal(work, plane)


def test_num_resolutions_is_pils():
    """PIL lowers OpenJPEG's 6 resolutions until 2^(n - 1) fits both
    sides: the COD marker of PIL's save carries that many levels."""
    for w, h in [(1, 1), (13, 9), (300, 12), (33, 40), (64, 64), (40, 33),
                 (2, 200)]:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((h, w), np.uint8)).save(buf, "JPEG2000",
                                                         no_jp2=True)
        data = buf.getvalue()
        cod = data.index(b"\xff\x52")
        assert data[cod + 9] + 1 == j2k_encode.num_resolutions(w, h), (w, h)


class _OpjMqc:
    """mqc.c's encoder, one procedure per function as OpenJPEG 2.5.4
    writes them (the bytes after the reserved byte before the stream)."""

    def __init__(self):
        self.ctx = list(j2k_t1.INIT)
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.buf = bytearray(b"\0")
        self.bp = 0

    def byteout(self):
        if self.buf[self.bp] == 0xFF:
            self.bp += 1
            self.buf.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif (self.c & 0x8000000) == 0:
            self.bp += 1
            self.buf.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[self.bp] += 1
            if self.buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self.bp += 1
                self.buf.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.bp += 1
                self.buf.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def renorme(self):
        while True:
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self.byteout()
            if self.a & 0x8000:
                return

    def encode(self, cx, d):
        k = self.ctx[cx]
        qe = j2k_t1.QE[k]
        if (k & 1) == d:  # codemps
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctx[cx] = j2k_t1.NEXT_MPS[k]
                self.renorme()
            else:
                self.c += qe
        else:  # codelps
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            self.ctx[cx] = j2k_t1.NEXT_LPS[k]
            self.renorme()

    def flush(self) -> bytes:
        tempc = self.c + self.a  # setbits
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self.byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self.byteout()
        if self.buf[self.bp] != 0xFF:
            self.bp += 1
        return bytes(self.buf[1:self.bp])


@pytest.mark.parametrize("seed", range(6))
def test_mq_encode_equals_mqc(seed):
    """Symbol streams over all 19 contexts, skewed from almost constant
    to even so that carries and 0xFF bytes occur: mq_encode's bytes are
    mqc.c's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6000))
    ctx = rng.integers(0, 19, n)
    p_one = rng.choice([0.001, 0.05, 0.3, 0.5, 0.9], 19)
    bits = (rng.random(n) < p_one[ctx]).astype(np.int64)
    ref = _OpjMqc()
    for cx, d in zip(ctx.tolist(), bits.tolist()):
        ref.encode(cx, d)
    want = ref.flush()
    got = j2k_t1_encode.mq_encode((ctx * 2 + bits).tolist())
    assert got == want
    if seed == 0:
        assert j2k_t1_encode.mq_encode([]) == _OpjMqc().flush()


# j2k_t1's neighbour flags: (bit, sign bit, dy, dx)
_DIRS = ((1, 0, -1, -1), (2, 256, -1, 0), (4, 0, -1, 1), (8, 1024, 0, -1),
         (16, 2048, 0, 1), (32, 0, 1, -1), (64, 512, 1, 0), (128, 0, 1, 1))


def _loop_symbols(c: np.ndarray, orient: int) -> list:
    """t1.c's three passes over code-block `c` one coefficient at a time
    in scan order: significance, visited and refined flags, a stripe
    column in run-length mode when its four coefficients and their
    neighbours are all insignificant and unvisited (the flags word zero);
    the symbols (context * 2 + decision) in coding order."""
    h, w = c.shape
    mag = np.zeros((h + 2, w + 2), np.int64)
    mag[1:-1, 1:-1] = np.abs(c)
    neg = np.zeros((h + 2, w + 2), bool)
    neg[1:-1, 1:-1] = c < 0
    sig = np.zeros((h + 2, w + 2), bool)
    visited = sig.copy()
    refined = sig.copy()
    out = []

    def flags(y, x):
        f = 0
        for bit, sgn, dy, dx in _DIRS:
            if sig[y + dy, x + dx]:
                f |= bit | (sgn if neg[y + dy, x + dx] else 0)
        return f

    def sign(y, x):
        f = flags(y, x)
        out.append(j2k_t1.SC_CTX[f] * 2 + (int(neg[y, x]) ^ j2k_t1.SC_XOR[f]))
        sig[y, x] = True

    def zero_coding(y, x, p):
        v = int(mag[y, x] >> p) & 1
        out.append(j2k_t1.ZC[orient][flags(y, x) & 0xFF] * 2 + v)
        if v:
            sign(y, x)

    numbps = int(mag.max()).bit_length()
    for p in range(numbps - 1, -1, -1):
        for kind in ("sig", "ref", "cln") if p < numbps - 1 else ("cln",):
            for k in range(0, h, 4):
                rows = list(range(k + 1, min(k + 4, h) + 1))
                for x in range(1, w + 1):
                    if kind == "sig":
                        for y in rows:
                            if not sig[y, x] and flags(y, x) & 0xFF:
                                zero_coding(y, x, p)
                                visited[y, x] = True
                        continue
                    if kind == "ref":
                        for y in rows:
                            if sig[y, x] and not visited[y, x]:
                                cx = 16 if refined[y, x] else (
                                    15 if flags(y, x) & 0xFF else 14)
                                out.append(cx * 2 + (int(mag[y, x] >> p) & 1))
                                refined[y, x] = True
                        continue
                    first = 0
                    if len(rows) == 4 and not any(
                            sig[y, x] or visited[y, x] or flags(y, x) & 0xFF
                            for y in rows):
                        run = next((i for i, y in enumerate(rows)
                                    if (mag[y, x] >> p) & 1), 4)
                        out.append(j2k_t1.CTX_AGG * 2 + (run != 4))
                        if run == 4:
                            continue
                        out += [j2k_t1.CTX_UNI * 2 + (run >> 1),
                                j2k_t1.CTX_UNI * 2 + (run & 1)]
                        sign(rows[run], x)
                        first = run + 1
                    for y in rows[first:]:
                        if not sig[y, x] and not visited[y, x]:
                            zero_coding(y, x, p)
                    for y in rows:
                        visited[y, x] = False
    return out


def _blocks(seed: int):
    """Code-blocks of every size class: sparse and dense, signed, with
    runs of zeros, and one all zero."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in [(1, 1), (1, 37), (37, 1), (5, 3), (9, 13), (16, 16),
                 (13, 64), (64, 64), (4, 7), (3, 2)]:
        c = rng.integers(-(1 << int(rng.integers(1, 11))), 1 << 10, (h, w))
        c[rng.random((h, w)) < rng.random()] = 0
        out.append((c.astype(np.int32), int(rng.integers(0, 4))))
    out.append((np.zeros((8, 8), np.int32), 0))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_tier1_symbols_equal_the_scan_loop(seed, monkeypatch):
    """encode_cblks, all code-blocks at once, codes each block's symbols
    in the order and contexts of the scan-order loop."""
    blocks = _blocks(seed)
    seen = []
    mq = j2k_t1_encode.mq_encode
    monkeypatch.setattr(j2k_t1_encode, "mq_encode",
                        lambda s: (seen.append(list(s)), mq(s))[1])
    coded = j2k_t1_encode.encode_cblks(blocks)
    want = [_loop_symbols(c, o) for c, o in blocks]
    assert seen == [[int(v) for v in s] for s in want if s]
    for (c, _o), (data, numbps, passes) in zip(blocks, coded):
        assert numbps == int(np.abs(c).max()).bit_length()
        assert passes == (3 * numbps - 2 if numbps else 0)
        assert bool(data) == bool(numbps)


@pytest.mark.parametrize("seed", range(3))
def test_tier1_bytes_decode_back(seed):
    """Each code-block's bytes through j2k_t1.decode_cblk (all passes in
    one segment) halve back to the coefficients."""
    blocks = _blocks(seed + 10)
    for (c, orient), (data, numbps, passes) in zip(
            blocks, j2k_t1_encode.encode_cblks(blocks)):
        if not numbps:
            continue
        h, w = c.shape
        v = j2k_t1.decode_cblk([(data, passes)], w, h, orient, numbps, 0, 0)
        np.testing.assert_array_equal(np.sign(v) * (np.abs(v) // 2), c)


def test_bit_writer_reads_back():
    """Random header bits, runs of ones among them: j2k_t2.Bio reads
    them back, a byte after 0xFF holding 7 bits, and the flush ends on a
    byte that is not 0xFF."""
    rng = np.random.default_rng(7)
    for n in (1, 7, 8, 9, 64, 1000):
        bits = (rng.random(n) < rng.random()).astype(int).tolist()
        bw = j2k_t2_encode.BitWriter()
        for b in bits:
            bw.bit(b)
        data = bw.flush()
        assert data[-1] != 0xFF
        bio = j2k_t2.Bio(data, 0, len(data))
        assert [bio.bit() for _ in bits] == bits


@pytest.mark.parametrize("size", [(1, 1), (1, 5), (3, 2), (4, 4), (7, 5)],
                         ids=str)
def test_tag_trees_decode_back(size):
    """An inclusion tree (every leaf against threshold 1, values 0 or
    999) and a zero bit-plane tree (threshold 999) written as a packet
    header writes them: TagTree reads the same values."""
    w, h = size
    rng = np.random.default_rng(w * 10 + h)
    incl = rng.random(w * h) < 0.6
    zero = rng.integers(0, 12, w * h).tolist()
    ti, tz = (j2k_t2_encode.TagTreeEncoder(w, h) for _ in range(2))
    for leaf in range(w * h):
        tz.set_value(leaf, zero[leaf])
        if incl[leaf]:
            ti.set_value(leaf, 0)
    bw = j2k_t2_encode.BitWriter()
    for leaf in range(w * h):
        ti.encode(bw, leaf, 1)
        if incl[leaf]:
            tz.encode(bw, leaf, 999)
    data = bw.flush()
    bio = j2k_t2.Bio(data, 0, len(data))
    di, dz = j2k_t2.TagTree(w, h), j2k_t2.TagTree(w, h)
    for leaf in range(w * h):
        assert di.decode(bio, leaf, 1) == incl[leaf]
        if incl[leaf]:
            i = 0
            while not dz.decode(bio, leaf, i + 1):
                i += 1
            assert i == zero[leaf]


# ------------------------------ chip_smoke ------------------------------

def courtyard_textures() -> dict:
    """The courtyard's 12 textures as the formats phase re-saves them:
    RGBA, the normal maps RGB."""
    out = {}
    for png in sorted(DEMO.glob("*.png")):
        img = np.asarray(Image.open(png).convert("RGBA"))
        out[png.stem] = img[..., :3].copy() if png.stem.endswith(
            "_normal") else img
    return out


def pil_courtyard_digests() -> dict:
    """SHA-256 of PIL's JP2 save of each courtyard texture."""
    out = {}
    for stem, img in courtyard_textures().items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG2000")
        out[stem] = hashlib.sha256(buf.getvalue()).hexdigest()
    return out


def test_courtyard_written_digests_are_pils():
    """chip_smoke.COURTYARD_JP2_WRITTEN_SHA256, which the card's machine
    holds the port's JP2 saves of the courtyard to, is PIL's; the port
    writes those bytes for a 256 x 256 map here (all 12 on the card's
    machine, for time)."""
    import chip_smoke

    assert chip_smoke.COURTYARD_JP2_WRITTEN_SHA256 == pil_courtyard_digests()
    img = courtyard_textures()["ivy_normal"]
    assert img.shape == (256, 256, 3)
    assert hashlib.sha256(jp2.encode_jp2(img)).hexdigest() == \
        chip_smoke.COURTYARD_JP2_WRITTEN_SHA256["ivy_normal"]


def print_digests_and_times():
    print("COURTYARD_JP2_WRITTEN_SHA256 = " + repr(pil_courtyard_digests()))
    img = courtyard_textures()["stone_albedo"]
    best = {}
    for what, fn in (("encode", lambda: jp2.encode_jp2(img)),
                     ("decode", lambda: jp2.read_jpeg2000(data))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
            if what == "encode":
                data = out
        best[what] = min(times)
    print(f"stone_albedo {img.shape} as JP2 ({len(data)} bytes) on the host,"
          f" best of 3: encode {best['encode']:.3f} s, decode "
          f"{best['decode']:.3f} s")


if __name__ == "__main__":
    print_digests_and_times()
