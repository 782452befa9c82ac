"""The port's JPEG decoder (assets/jpeg.py) against PIL's libjpeg decode,
``Image.open(...).convert("RGBA")``, which the JAX package's load_image
uses: every output byte equal, on JPEGs that PIL writes here (each
subsampling, grey, RGB kept as RGB, progressive, optimised Huffman
tables, restart intervals, qualities 10 / 75 / 95, sizes that are not
multiples of the MCU), on 4:4:0 and 4:1:1 files that this test encodes
itself (PIL writes neither), on the committed fixtures in
tests/data/jpeg (PIL's decodes of them committed as PNG, which
chip_smoke.py also checks on a machine without PIL), and through the
glTF import of a courtyard copy with a .jpg texture. The features the
decoder does not read raise ValueError naming them (CMYK / YCCK and the
block smoothing of cut progressive files are held to PIL in
tests/test_torch_formats.py, arithmetic coding and lossless mode in
tests/test_torch_formats_codecs.py).

Run as a script (``PYTHONPATH=. python tests/test_torch_jpeg.py``), it
prints the decoder's host time on 512^2 and 2048^2 pictures that PIL
encodes at quality 90, 4:2:0, baseline and progressive."""

import io
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from plainrenderer_tpu.assets import gltf_import as jgltf
from plainrenderer_tpu.render import scenebuild as jsb
from plainrenderer_tpu_torch.assets import gltf_import as tgltf
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import jpeg as tjpeg
from plainrenderer_tpu_torch.render import scenebuild as tsb

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _picture(w, h, seed=0):
    """Gradients, a hard edge and noise: every block has AC energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                  (x + y) * 7.0 % 256], -1)
    a[(x > w // 3) & (y < h // 2)] = [250, 20, 120]
    a += rng.normal(0, 20, a.shape)
    return Image.fromarray(np.clip(a, 0, 255).astype(np.uint8), "RGB")


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _save(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


CASES = (
    [((33, 47), "RGB", dict(quality=q, subsampling=s))
     for q in (10, 75, 95) for s in (0, 1, 2)]
    + [(size, "RGB", dict(quality=75, subsampling=s))
       for size in ((1, 1), (17, 9), (250, 130), (2, 2), (3, 5))
       for s in (0, 1, 2)]
    + [((33, 47), "L", dict(quality=75)),
       ((17, 9), "L", dict(quality=10)),
       ((250, 130), "RGB", dict(progressive=True)),
       ((250, 130), "RGB", dict(progressive=True, subsampling=0,
                                quality=95)),
       ((17, 9), "RGB", dict(progressive=True, subsampling=1)),
       ((250, 130), "L", dict(progressive=True)),
       ((250, 130), "RGB", dict(optimize=True)),
       ((250, 130), "RGB", dict(optimize=True, progressive=True,
                                quality=10)),
       ((250, 130), "RGB", dict(keep_rgb=True)),
       ((250, 130), "RGB", dict(restart_marker_blocks=3)),
       ((250, 130), "RGB", dict(restart_marker_rows=1, progressive=True)),
       ((33, 47), "L", dict(restart_marker_blocks=1, subsampling=2))])


@pytest.mark.parametrize("size,mode,kw", CASES,
                         ids=[f"{s[0]}x{s[1]}-{m}-" + "-".join(
                             f"{k}={v}" for k, v in kw.items())
                              for s, m, kw in CASES])
def test_decoder_equals_pil(size, mode, kw):
    data = _save(_picture(*size).convert(mode), **kw)
    got = tjpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 4)
    np.testing.assert_array_equal(got, _pil(data))


# ------------- a small baseline encoder for 4:4:0 and 4:1:1 -------------

def _segments(data):
    """Marker -> list of bodies of a JPEG's header segments."""
    out, i = {}, 2
    while data[i + 1] != 0xDA:
        n = data[i + 2] << 8 | data[i + 3]
        out.setdefault(data[i + 1], []).append(data[i + 4:i + 2 + n])
        i += 2 + n
    return out


def _codes(body):
    """(class, id) -> {symbol: (code, length)} from a DHT body."""
    tables, i = {}, 0
    while i < len(body):
        counts = list(body[i + 1:i + 17])
        syms = list(body[i + 17:i + 17 + sum(counts)])
        code, k, table = 0, 0, {}
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                table[syms[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        tables[(body[i] >> 4, body[i] & 15)] = table
        i += 17 + sum(counts)
    return tables


def _encode(img, factors):
    """A baseline JFIF JPEG of the RGB picture with Y sampled (h, v) =
    factors and Cb, Cr at (1, 1): PIL's quantisation and standard Huffman
    tables (taken from a 4:4:4 file PIL writes at quality 75), a float
    DCT, chroma averaged over each h x v box."""
    ref = _segments(_save(img, quality=75, subsampling=0))
    dht = b"".join(ref[0xC4])
    codes = {}
    for body in ref[0xC4]:
        codes.update(_codes(body))
    qts = {}
    for body in ref[0xDB]:
        i = 0
        while i < len(body):
            q = np.zeros(64, np.int64)
            q[tjpeg.ZIGZAG] = np.frombuffer(body[i + 1:i + 65], np.uint8)
            qts[body[i] & 15] = q.reshape(8, 8)
            i += 65
    rgb = np.asarray(img, np.float64)
    h, w = rgb.shape[:2]
    hy, vy = factors
    ycc = np.stack([
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
        -0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1]
        + 0.5 * rgb[..., 2] + 128,
        0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1]
        - 0.081312 * rgb[..., 2] + 128])
    mh, mw = -(-h // (8 * vy)), -(-w // (8 * hy))
    full = np.pad(ycc, ((0, 0), (0, mh * 8 * vy - h), (0, mw * 8 * hy - w)),
                  mode="edge")
    planes = [full[0]] + [
        full[c].reshape(mh * 8, vy, mw * 8, hy).mean(axis=(1, 3))
        for c in (1, 2)]
    n = np.arange(8)
    basis = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)
    scale = np.where(n == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    dct = basis * scale[None, :]

    def blocks(p, q):
        b = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8) \
            .transpose(0, 2, 1, 3) - 128
        coef = np.einsum("xu,abxy,yv->abuv", dct, b, dct)
        return np.round(coef / q).astype(np.int64).reshape(
            b.shape[0], b.shape[1], 64)[..., tjpeg.ZIGZAG]

    comps = [blocks(planes[0], qts[0]), blocks(planes[1], qts[1]),
             blocks(planes[2], qts[1])]
    bits = []

    def put(code, length):
        bits.extend((code >> (length - 1 - k)) & 1 for k in range(length))

    def category(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = [0, 0, 0]
    for my in range(mh):
        for mx in range(mw):
            for ci, (bh, bv) in enumerate([(hy, vy), (1, 1), (1, 1)]):
                dc_t, ac_t = codes[(0, min(ci, 1))], codes[(1, min(ci, 1))]
                for v in range(bv):
                    for u in range(bh):
                        blk = comps[ci][my * bv + v, mx * bh + u]
                        s, extra = category(blk[0] - pred[ci])
                        pred[ci] = blk[0]
                        put(*dc_t[s])
                        put(extra, s)
                        run = 0
                        last = max([k for k in range(1, 64) if blk[k]],
                                   default=0)
                        for k in range(1, last + 1):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_t[0xF0])
                                run -= 16
                            s, extra = category(blk[k])
                            put(*ac_t[run << 4 | s])
                            put(extra, s)
                            run = 0
                        if last < 63:
                            put(*ac_t[0x00])
    bits.extend([1] * (-len(bits) % 8))
    scan = np.packbits(np.array(bits, np.uint8)).tobytes() \
        .replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + body

    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([3, 1, hy << 4 | vy, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + b"".join(seg(0xE0, b) for b in ref[0xE0])
            + b"".join(seg(0xDB, b) for b in ref[0xDB]) + seg(0xC0, sof)
            + seg(0xC4, dht) + seg(0xDA, sos) + scan + b"\xff\xd9")


@pytest.mark.parametrize("factors", [(1, 2), (4, 1), (2, 2), (3, 1)],
                         ids=["4:4:0", "4:1:1", "4:2:0", "3x1"])
@pytest.mark.parametrize("size", [(33, 47), (7, 5), (64, 32)])
def test_decoder_equals_pil_on_other_sampling_factors(factors, size):
    """h1v2 fancy upsampling (4:4:0), 4x and 3x replication (4:1:1, 3:1)
    and h2v2 again, from this test's own encoder."""
    data = _encode(_picture(*size, seed=3), factors)
    want = _pil(data)
    assert want.std() > 10  # the encoder wrote a picture
    np.testing.assert_array_equal(tjpeg.decode_jpeg(data), want)


def _patched(data, offset_of, value):
    b = bytearray(data)
    b[offset_of(b)] = value
    return bytes(b)


def test_unsupported_features_raise_naming_themselves():
    base = _save(_picture(16, 16), quality=75)
    sof = base.index(b"\xff\xc0")
    # arithmetic coding is read now: the baseline file's data under SOF9
    # decodes as libjpeg-turbo decodes it (real SOF9 / SOF10 / SOF3 files:
    # tests/test_torch_formats_codecs.py)
    arith = _patched(base, lambda b: sof + 1, 0xC9)
    np.testing.assert_array_equal(tjpeg.decode_jpeg(arith), _pil(arith))
    for marker, name in ((0xC3, "lossless"), (0xC5, "hierarchical")):
        data = _patched(base, lambda b: sof + 1, marker)
        with pytest.raises(OSError):  # PIL refuses these files too
            _pil(data)
        with pytest.raises(ValueError, match=name):
            tjpeg.decode_jpeg(data)
    with pytest.raises(ValueError, match="12-bit"):
        tjpeg.decode_jpeg(_patched(base, lambda b: sof + 4, 12))
    with pytest.raises(ValueError):
        tjpeg.decode_jpeg(base[:200])


def test_committed_fixtures_equal_their_pil_decodes():
    """tests/data/jpeg: baseline 4:2:0, progressive, grey and restart
    intervals, each beside PIL's decode as PNG (read by the port's PNG
    reader); PIL decodes them to the same bytes here."""
    names = sorted(p.stem for p in FIXTURES.glob("*.jpg"))
    assert names == ["baseline420", "grey", "progressive", "restart"]
    for name in names:
        got = tio.load_image(FIXTURES / f"{name}.jpg")
        want = tio.load_image(FIXTURES / f"{name}.png")
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            got, _pil((FIXTURES / f"{name}.jpg").read_bytes()))


def test_gltf_with_a_jpeg_texture_imports_as_the_reference(tmp_path):
    """A copy of the courtyard whose stone albedo is re-encoded as .jpg:
    the port's glTF import and the JAX package's give the same meshes,
    texture paths and mean albedo, and their render scenes the same
    texture pool."""
    for p in [DEMO / "courtyard.gltf", DEMO / "courtyard.bin",
              *DEMO.glob("*.png")]:
        shutil.copy(p, tmp_path)
    Image.open(tmp_path / "stone_albedo.png").convert("RGB").save(
        tmp_path / "stone_albedo.jpg", quality=90)
    doc = json.loads((tmp_path / "courtyard.gltf").read_text())
    changed = 0
    for image in doc["images"]:
        if image.get("uri") == "stone_albedo.png":
            image["uri"] = "stone_albedo.jpg"
            changed += 1
    assert changed == 1
    (tmp_path / "courtyard.gltf").write_text(json.dumps(doc))
    (tmp_path / "stone_albedo.png").unlink()
    t_scene = tgltf.load_model_gltf(tmp_path / "courtyard.gltf")
    j_scene = jgltf.load_model_gltf(tmp_path / "courtyard.gltf")
    jpg_meshes = [m for m in t_scene.meshes
                  if m.texture_paths.albedo.endswith(".jpg")]
    assert jpg_meshes
    for tm, jm in zip(t_scene.meshes, j_scene.meshes, strict=True):
        assert vars(tm.texture_paths) == vars(jm.texture_paths)
        np.testing.assert_array_equal(tm.mean_albedo, jm.mean_albedo)
    assert not any((m.mean_albedo == 0.5).all() for m in jpg_meshes)
    t_rs, j_rs = tsb.build_render_scene(t_scene), \
        jsb.build_render_scene(j_scene)
    for key in ("tex_info", "tex_word0", "tex_word1", "material_table"):
        a, b = getattr(t_rs, key, None), getattr(j_rs, key, None)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=key)


def time_decodes(sizes=(512, 2048), repeats=2):
    """The best of `repeats` decode_jpeg wall times on the host, in ms,
    for each size, baseline and progressive."""
    for n in sizes:
        for progressive in (False, True):
            data = _save(_picture(n, n), quality=90, subsampling=2,
                         progressive=progressive)
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                tjpeg.decode_jpeg(data)
                times.append((time.perf_counter() - t0) * 1e3)
            kind = "progressive" if progressive else "baseline"
            print(f"{n}x{n} {kind}, {len(data)} bytes: decoded in "
                  f"{min(times):.1f} ms (best of {repeats})", flush=True)


if __name__ == "__main__":
    time_decodes()
