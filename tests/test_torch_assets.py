"""The port's host-side asset code against the JAX package's (which
imports no JAX): compressed vertex types, the .plain reader and writer on
the courtyard demo, DDS volumes, the PNG and Radiance readers (held to PIL
and imageio, which the card's machine lacks), the glTF import and the
offline pipeline."""

import io
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plainrenderer_tpu.assets import compressed as jcomp
from plainrenderer_tpu.assets import dds as jdds
from plainrenderer_tpu.assets import image_io as jio
from plainrenderer_tpu.assets import plain_format as jpf
from plainrenderer_tpu.assets.pipeline import run_pipeline as j_run_pipeline
from plainrenderer_tpu.assets.sdf_bake import bake_mesh_sdf as j_bake
from plainrenderer_tpu_torch.assets import compressed as tcomp
from plainrenderer_tpu_torch.assets import dds as tdds
from plainrenderer_tpu_torch.assets import gltf_import as tgltf
from plainrenderer_tpu_torch.assets import image_io as tio
from plainrenderer_tpu_torch.assets import plain_format as tpf
from plainrenderer_tpu_torch.assets.pipeline import run_pipeline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "demo"
DEMO_PNGS = sorted(DEMO.glob("*.png"))
DEMO_DDS = sorted((DEMO / "sdfTextures").glob("*.dds"))


def test_compressed_types_round_trip_bit_for_bit():
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.uniform(-1.5, 1.5, 4000),
                        [-1.0, -0.5, 0.0, 0.5, 1.0, np.nan]]).astype(
                            np.float32)
    with np.errstate(invalid="ignore"):
        for name in ("float_to_unorm16", "float_to_snorm16"):
            want = getattr(jcomp, name)(f)
            got = getattr(tcomp, name)(f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    v = rng.normal(size=(2000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]
    packed = tcomp.vec3_to_r10g10b10a2(v)
    np.testing.assert_array_equal(packed, jcomp.vec3_to_r10g10b10a2(v))
    np.testing.assert_array_equal(tcomp.r10g10b10a2_to_vec3(packed),
                                  jcomp.r10g10b10a2_to_vec3(packed))
    words = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tcomp.r10g10b10a2_to_vec3(words),
                                  jcomp.r10g10b10a2_to_vec3(words))


def _assert_same(a, b, where=""):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _assert_same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def test_plain_scene_loads_and_saves_as_the_reference(tmp_path):
    """Every array and path of courtyard.plain equal to the JAX package's
    reader; saved again, the same bytes; decoded meshes equal."""
    path = DEMO / "courtyard.plain"
    got, want = tpf.load_binary_scene(path), jpf.load_binary_scene(path)
    assert len(got.meshes) == len(want.meshes) == 4
    assert len(got.objects) == len(want.objects) == 4
    for a, b in zip(got.objects + got.meshes, want.objects + want.meshes):
        _assert_same(a, b)
    for m in got.meshes:
        _assert_same(tpf.mesh_binary_to_arrays(m),
                     jpf.mesh_binary_to_arrays(m))
    assert all(m.texture_paths.albedo.startswith("assets/demo/")
               for m in got.meshes)
    out = tmp_path / "again.plain"
    tpf.save_binary_scene(out, got)
    assert out.read_bytes() == path.read_bytes()


def test_sdf_volumes_read_as_the_reference(tmp_path):
    assert len(DEMO_DDS) == 3
    shapes = set()
    for p in DEMO_DDS:
        got, want = tdds.read_sdf_volume(p), jdds.read_sdf_volume(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        shapes.add(got.shape)
        out = tmp_path / p.name
        tdds.write_sdf_volume(out, got)
        assert out.read_bytes() == p.read_bytes()
    assert shapes == {(64, 16, 64), (32, 16, 32), (16, 16, 16)}
    rgba = np.random.default_rng(2).integers(0, 256, (8, 16, 4), np.uint8)
    tdds.write_dds(tmp_path / "t.dds", 16, 8, 1, rgba, fmt="rgba8")
    img = tdds.read_dds(tmp_path / "t.dds")
    assert (img.width, img.height, img.depth, img.format) == (16, 8, 1,
                                                              "rgba8")
    np.testing.assert_array_equal(tio.load_image(tmp_path / "t.dds"), rgba)
    np.testing.assert_array_equal(jio.load_image(tmp_path / "t.dds"), rgba)


@pytest.mark.parametrize("path", DEMO_PNGS, ids=lambda p: p.name)
def test_demo_pngs_decode_as_pil(path):
    got = tio.load_image(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGBA"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------- a PNG writer for every variant ----------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows, bpp, rng):
    """Filter (h, stride) u8 rows, each with a random filter type 0-4."""
    out = []
    prev = np.zeros(rows.shape[1], np.int16)
    for row in rows.astype(np.int16):
        f = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int16), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int16), prev[:-bpp]])
        pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
        pc = np.abs(left + prev - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][f]
        out.append(bytes([f]) + ((row - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _write_png(samples, ctype, depth, interlace, rng, palette=None,
               trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        vals = sub.reshape(sub.shape[0], -1)
        if depth == 16:
            rows = vals.astype(">u2").view(np.uint8)
        elif depth == 8:
            rows = vals.astype(np.uint8)
        else:
            bits = (vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(vals.shape[0], -1).astype(
                np.uint8), axis=1)
        raw += _filter_rows(rows, bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_CASES = [(c, d, i) for c, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                      (3, (1, 2, 4, 8)), (4, (8, 16)),
                                      (6, (8, 16)))
          for d in depths for i in (0, 1)]


@pytest.mark.parametrize("ctype,depth,interlace", _CASES)
def test_generated_pngs_decode_as_pil(ctype, depth, interlace):
    """Seeded images in every colour type and bit depth, plain and Adam7,
    every row under a random one of the five filters, with a tRNS chunk
    where the colour type allows one; sizes that leave Adam7 passes
    empty (1 x 1) and partial."""
    rng = np.random.default_rng(100 * ctype + 10 * depth + interlace)
    for h, w in ((1, 1), (13, 11), (37, 70)):
        ch = _CHANNELS[ctype]
        top = (1 << depth) if ctype != 3 else min(1 << depth, 40)
        samples = rng.integers(0, top, (h, w, ch))
        palette = trns = None
        if ctype == 3:  # a palette shorter than the index range
            palette = rng.integers(0, 256, (min(1 << depth, 30), 3))
            trns = bytes(rng.integers(0, 256, min(1 << depth, 12)).tolist())
        elif ctype in (0, 2):  # a key that some pixels hit
            key = samples[0, 0]
            trns = b"".join(struct.pack(">H", int(k)) for k in key)
        data = _write_png(samples, ctype, depth, interlace, rng, palette,
                          trns)
        got = tio.decode_png(data)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGBA"))
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")


def test_png_errors_raise_value_error(tmp_path):
    """Formats this test named as refused are read now (IM and ICNS since
    slice 18, JPEG 2000 since slice 20, and AVIF): an AVIF, a
    JPEG (read since slice 14) and a JPEG 2000 file load equal to PIL's
    decode; a bad CRC, a truncated file and bad image data raise
    ValueError."""
    avif = tmp_path / "a.avif"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(avif)
    with Image.open(avif) as im:
        np.testing.assert_array_equal(tio.load_image(avif),
                                      np.asarray(im.convert("RGBA")))
    jp2 = tmp_path / "a.jp2"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(jp2)
    with Image.open(jp2) as im:
        np.testing.assert_array_equal(tio.load_image(jp2),
                                      np.asarray(im.convert("RGBA")))
    jpg = tmp_path / "a.jpg"
    pixels = np.random.default_rng(1).integers(0, 256, (9, 13, 3), np.uint8)
    Image.fromarray(pixels).save(jpg)
    with Image.open(jpg) as im:
        np.testing.assert_array_equal(tio.load_image(jpg),
                                      np.asarray(im.convert("RGBA")))
    good = _write_png(np.zeros((4, 4, 3), np.int64), 2, 8, 0,
                      np.random.default_rng(0))
    bad_crc = bytearray(good)
    bad_crc[20] ^= 1
    head = good[:33]  # signature and IHDR
    end = _chunk(b"IEND", b"")
    for data in (bytes(bad_crc), good[:40],
                 head + _chunk(b"IDAT", b"not zlib") + end,
                 head + _chunk(b"IDAT", zlib.compress(b"\x00" * 5)) + end,
                 head + end):
        with pytest.raises(ValueError):
            tio.decode_png(data)


def test_saved_png_reads_back_in_pil_and_the_port(tmp_path):
    rng = np.random.default_rng(4)
    for c in (3, 4):
        img = rng.integers(0, 256, (33, 47, c)).astype(np.uint8)
        tio.save_image(tmp_path / f"x{c}.png", img)
        with Image.open(tmp_path / f"x{c}.png") as im:
            assert im.mode == ("RGB" if c == 3 else "RGBA")
            np.testing.assert_array_equal(np.asarray(im), img)
        back = tio.load_image(tmp_path / f"x{c}.png")
        np.testing.assert_array_equal(back[..., :c], img)


def _rle_scanline(row):
    """New-style RGBE run-length encoding of one (w, 4) u8 scanline."""
    w = row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        v, x = row[:, c], 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and v[x + run] == v[x]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, int(v[x])])
                x += run
                continue
            start = x
            while x < w and x - start < 128 and not (
                    x + 2 < w and v[x] == v[x + 1] == v[x + 2]):
                x += 1
            out += bytes([x - start]) + v[start:x].tobytes()
    return bytes(out)


def test_hdr_decodes_as_imageio(tmp_path):
    """Seeded RGBE files, one of flat scanlines and one run-length
    encoded, against the JAX package's load_image: imageio's default
    reader for .hdr here (OpenCV at its default flags, 8-bit RGB), cast to
    f32 and padded with alpha 1. tests/test_torch_formats_bcn.py sweeps
    every RGBE pair and the header variants."""
    from plainrenderer_tpu.assets import image_io as jio

    rng = np.random.default_rng(6)
    h, w = 9, 40
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(118, 140, (h, w))
    rgbe[2, :20] = rgbe[2, 0]  # runs
    rgbe[3, 5, 3] = 0  # a black texel
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
    for name, body in (("flat", rgbe.tobytes()), ("rle", b"".join(
            _rle_scanline(rgbe[y]) for y in range(h)))):
        path = tmp_path / f"{name}.hdr"
        path.write_bytes(head + body)
        got = tio.load_image(path)
        want = jio.load_image(path)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (h, w, 4)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (got[..., 3] == 1.0).all()
        # the radiance itself, before the 8-bit conversion
        e = rgbe[..., 3].astype(np.int32)
        radiance = rgbe[..., :3] * np.where(
            e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)[..., None]
        np.testing.assert_array_equal(tio.read_hdr(path.read_bytes()),
                                      radiance.astype(np.float32))


def test_mean_albedo_reads_as_the_reference():
    for p in DEMO_PNGS:
        if "albedo" in p.name:
            from plainrenderer_tpu.assets.gltf_import import \
                _compute_mean_albedo as j_mean
            np.testing.assert_array_equal(tgltf._compute_mean_albedo(p),
                                          j_mean(p))
    assert (tgltf._compute_mean_albedo(DEMO / "missing.png") == 0.5).all()


def test_pipeline_matches_the_reference(tmp_path, monkeypatch):
    """run_pipeline on one copy of courtyard.gltf, .bin and the PNGs, the
    JAX package's run_pipeline on another (both from their own directory,
    so the paths in the two files are the same): the .plain files are
    byte-equal, and the port's DDS volumes (its dense bake, f16) are
    within one f16 spacing of the JAX package's exact numpy bake
    (bake_mesh_sdf(..., use_native=False))."""
    dirs = {}
    for side in ("jax", "port"):
        d = dirs[side] = tmp_path / side
        d.mkdir()
        for p in [DEMO / "courtyard.gltf", DEMO / "courtyard.bin",
                  *DEMO_PNGS]:
            shutil.copy(p, d)
    monkeypatch.chdir(dirs["jax"])
    j_run_pipeline("courtyard.gltf")
    monkeypatch.chdir(dirs["port"])
    run_pipeline("courtyard.gltf", device="cpu")
    got = (dirs["port"] / "courtyard.plain").read_bytes()
    assert got == (dirs["jax"] / "courtyard.plain").read_bytes()
    scene = tgltf.load_model_gltf("courtyard.gltf")
    baked = 0
    for mesh in scene.meshes:
        if not mesh.texture_paths.sdf:
            continue
        vol = tdds.read_sdf_volume(mesh.texture_paths.sdf)
        want = j_bake(mesh.positions, mesh.indices, use_native=False)
        assert vol.shape == want.shape
        spacing = np.spacing(np.abs(want).astype(np.float16)).astype(
            np.float32)
        assert (np.abs(vol - want) <= spacing).all()
        baked += 1
    assert baked == 3
