"""DDS image read/write, byte-compatible with the reference's ImageIO
(a copy of plainrenderer_tpu/assets/dds.py).

Parity: Plain/src/Common/ImageIO.cpp:118-446 (reader) and :448-586 (writer).
The renderer uses DDS for two things:
  - baked 3D SDF volumes: R16_FLOAT via DX10 header (SceneSDF.cpp:506-508)
  - optionally BC-compressed material textures (reader passes raw blocks).

We implement the DX10-header path fully (R16_FLOAT, R8G8B8A8_UNORM) and read
BC1/BC3/BC5 headers with raw payload passthrough, like the reference.

A file that starts ``DDS `` under any other suffix than .dds is an image
that the JAX package reads through PIL: ``read_dds_image`` decodes it as
Pillow 12.1's DdsImagePlugin does (uncompressed RGB(A) by bit masks,
8-bit L, 16-bit LA, 8-bit palette with an RGBA table, DX10
R8G8B8A8, BC1-BC5 in the legacy FourCC and the DX10 forms through
assets/bcn.py, BC6H (DXGI 95 and 96) through assets/bc6h.py and BC7
(DXGI 97-99, sRGB unconverted) through assets/bc7.py).
``encode_dds`` writes (H, W) and (H, W, 3|4) u8 as PIL's ``_save`` does:
uncompressed, with masks.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from . import bc6h, bc7, bcn, modes

MAGIC = 0x20534444  # 'DDS '

# DXGI formats we touch (ImageIO.cpp DXGI_FORMAT enum ordering)
DXGI_R8G8B8A8_UNORM = 28
DXGI_R16_FLOAT = 54

_D3D10_TEXTURE1D = 2
_D3D10_TEXTURE2D = 3
_D3D10_TEXTURE3D = 4

_FLAG_CAPS = 0x1
_FLAG_HEIGHT = 0x2
_FLAG_WIDTH = 0x4
_FLAG_PIXELFORMAT = 0x1000
_FLAG_MIPCOUNT = 0x20000
_FLAG_DEPTH = 0x800000
_CAPS_COMPLEX = 0x8
_CAPS_MIPMAP = 0x400000
_CAPS_TEXTURE = 0x1000
_CAPS2_VOLUME = 0x200000

_FOURCC_DX10 = int.from_bytes(b"DX10", "little")
_FOURCC_DXT1 = int.from_bytes(b"DXT1", "little")
_FOURCC_DXT5 = int.from_bytes(b"DXT5", "little")
_FOURCC_BC5 = int.from_bytes(b"ATI2", "little")
_PF_FLAG_FOURCC = 0x4


@dataclasses.dataclass
class DDSImage:
    width: int
    height: int
    depth: int
    mip_count: int
    format: str  # 'r16_sfloat' | 'rgba8' | 'bc1' | 'bc3' | 'bc5'
    data: bytes  # raw payload, mip-major as stored


def _mip_count_from_resolution(w: int, h: int, d: int) -> int:
    import math

    return 1 + int(math.floor(math.log2(max(w, h, d))))


def write_dds(path: str | Path, width: int, height: int, depth: int,
              data: np.ndarray | bytes, fmt: str = "r16_sfloat",
              mip_count: int = 1) -> None:
    """ImageIO.cpp:448-586 — magic + 124B header + DX10 header + payload."""
    if isinstance(data, np.ndarray):
        payload = data.tobytes()
    else:
        payload = bytes(data)

    flags = _FLAG_CAPS | _FLAG_WIDTH | _FLAG_HEIGHT | _FLAG_PIXELFORMAT
    if mip_count != 1:
        flags |= _FLAG_MIPCOUNT
    if depth != 1:
        flags |= _FLAG_DEPTH

    caps = _CAPS_TEXTURE
    if mip_count != 1:
        caps |= _CAPS_MIPMAP | _CAPS_COMPLEX
    if depth != 1:
        caps |= _CAPS_COMPLEX
    caps2 = _CAPS2_VOLUME if depth != 1 else 0

    # DDS_PixelFormat (ImageIO.cpp:530-543): DX10 fourCC, everything else 0
    pixel_format = struct.pack("<8I", 32, 0, _FOURCC_DX10, 0, 0, 0, 0, 0)

    header = struct.pack(
        "<7I44s32s5I",
        124, flags, height, width, 0, depth, mip_count,
        b"\0" * 44, pixel_format, caps, caps2, 0, 0, 0,
    )

    dxgi = {"r16_sfloat": DXGI_R16_FLOAT, "rgba8": DXGI_R8G8B8A8_UNORM}[fmt]
    dim = (
        _D3D10_TEXTURE3D if depth != 1
        else (_D3D10_TEXTURE2D if height != 1 else _D3D10_TEXTURE1D)
    )
    header_dx10 = struct.pack("<5I", dxgi, dim, 0, 1, 0)

    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC))
        f.write(header)
        f.write(header_dx10)
        f.write(payload)


def read_dds(path: str | Path) -> DDSImage:
    """ImageIO.cpp:118-446."""
    data = Path(path).read_bytes()
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != MAGIC:
        raise ValueError(f"not a DDS file: {path}")
    (
        header_size, _flags, height, width, _pitch, depth, mip_count,
    ) = struct.unpack_from("<7I", data, 4)
    if header_size != 124:
        raise ValueError(f"bad DDS header size {header_size} in {path}")
    depth = max(depth, 1)
    mip_count = max(mip_count, 1)
    # NOTE: like the reference reader (ImageIO.cpp:386-419) we key on the
    # fourCC alone — the reference writer leaves pixelFormat.flags at 0
    # (ImageIO.cpp:530-543), so requiring the FOURCC flag bit would reject
    # its own files.
    _pf_flags, fourcc = struct.unpack_from("<II", data, 4 + 28 + 44 + 4)
    offset = 4 + 124
    if fourcc == _FOURCC_DX10:
        dxgi, _dim, _misc, _arr, _misc2 = struct.unpack_from("<5I", data, offset)
        offset += 20
        if dxgi == DXGI_R16_FLOAT:
            fmt = "r16_sfloat"
        elif dxgi == DXGI_R8G8B8A8_UNORM:
            fmt = "rgba8"
        else:
            raise ValueError(f"unsupported DDS DXGI format {dxgi} in {path}")
    elif fourcc == _FOURCC_DXT1:
        fmt = "bc1"
    elif fourcc == _FOURCC_DXT5:
        fmt = "bc3"
    elif fourcc == _FOURCC_BC5:
        fmt = "bc5"
    else:
        raise ValueError(f"unsupported DDS pixel format in {path}")
    return DDSImage(
        width=width, height=height, depth=depth, mip_count=mip_count,
        format=fmt, data=data[offset:],
    )


def read_sdf_volume(path: str | Path) -> np.ndarray:
    """Baked SDF volume -> (depth, height, width) float32 distances.

    Reference layout: f16 texels, x fastest (SceneSDF.cpp:506-508 writes
    z-major order via writeDDSFile).
    """
    img = read_dds(path)
    if img.format != "r16_sfloat":
        raise ValueError(f"SDF volume must be r16_sfloat, got {img.format}")
    n = img.width * img.height * img.depth
    vol = np.frombuffer(img.data, np.float16, n).astype(np.float32)
    return vol.reshape(img.depth, img.height, img.width)


def write_sdf_volume(path: str | Path, volume: np.ndarray) -> None:
    """(depth, height, width) float distances -> reference-format DDS."""
    d, h, w = volume.shape
    write_dds(path, w, h, d, volume.astype(np.float16), fmt="r16_sfloat")


# ---------------------- DDS as PIL reads and writes it -------------------

_PF_ALPHAPIXELS, _PF_PALETTE8, _PF_RGB, _PF_LUMINANCE = 0x1, 0x20, 0x40, 0x20000
# FourCC -> (bcn number, signed), DdsImagePlugin.D3DFMT
_BCN_FOURCC = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
               b"BC4U": (4, False), b"ATI1": (4, False),
               b"BC5S": (5, True), b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (bcn number, signed); 0: raw RGBA
_BCN_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False),
             76: (3, False), 77: (3, False), 79: (4, False), 80: (4, False),
             82: (5, False), 83: (5, False), 84: (5, True), 27: (0, False),
             28: (0, False), 29: (0, False)}


def _mask_channel(values: np.ndarray, mask: int) -> np.ndarray:
    """DdsRgbDecoder: int((value & mask) >> shift) / (mask >> shift) * 255,
    0 for an empty mask."""
    if mask == 0:
        return np.zeros(values.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    total = mask >> shift
    v = ((values & mask) >> shift).astype(np.float64)
    return (v / total * 255).astype(np.uint8)


def read_dds_image(buf: bytes, where: str = "<dds>") -> np.ndarray:
    """DDS bytes -> (H, W, 4) u8 as ``Image.open(...).convert("RGBA")``
    gives them."""
    if not buf.startswith(b"DDS "):
        raise ValueError(f"not a DDS file: {where}")
    (hsize,) = struct.unpack_from("<I", buf, 4)
    if hsize != 124 or len(buf) < 128:
        raise ValueError(f"DDS header size {hsize} is not 124, or the "
                         f"header is incomplete: {where}")
    h, w = struct.unpack_from("<2I", buf, 12)
    pfflags, fourcc, bits = struct.unpack_from("<I4sI", buf, 80)
    if h == 0 or w == 0:
        raise ValueError(f"DDS size {w}x{h}: {where}")
    modes.check_size(w, h)
    pos = 128
    if pfflags & _PF_RGB:
        n = 4 if pfflags & _PF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", buf, 92)
        # DdsRgbDecoder reads bits // 8 bytes a pixel, little-endian; past
        # the end of the file it reads zeros
        nbytes = bits // 8
        raw = np.zeros((w * h, nbytes), np.uint8).reshape(-1)
        body = np.frombuffer(buf, np.uint8, offset=pos)[:raw.size]
        raw[:len(body)] = body
        values = np.zeros(w * h, np.uint64)
        for k, col in enumerate(raw.reshape(w * h, nbytes).T):
            values |= col.astype(np.uint64) << np.uint64(8 * k)
        px = np.stack([_mask_channel(values, m) for m in masks], -1)
        return modes.to_rgba("RGBA" if n == 4 else "RGB",
                             px.reshape(h, w, n))
    palette = None
    if pfflags & _PF_LUMINANCE:
        if bits == 8:
            mode, bands = "L", 1
        elif bits == 16 and pfflags & _PF_ALPHAPIXELS:
            mode, bands = "LA", 2
        else:
            raise ValueError(f"DDS luminance at {bits} bits is not read by "
                             f"PIL: {where}")
    elif pfflags & _PF_PALETTE8:
        mode, bands = "P", 1
        palette = np.frombuffer(buf[pos:pos + 1024], np.uint8)
        palette = palette[:len(palette) // 4 * 4].reshape(-1, 4)
        pos += 1024
    elif pfflags & _PF_FLAG_FOURCC:
        if fourcc == b"DX10":
            (dxgi,) = struct.unpack_from("<I", buf, pos)
            pos += 20
            if dxgi in (95, 96):
                return bc6h.decode_bc6h(buf[pos:], w, h, dxgi == 96, where)
            if dxgi in (97, 98, 99):
                return bc7.decode_bc7(buf[pos:], w, h, where)
            if dxgi not in _BCN_DXGI:
                raise ValueError(f"DDS DXGI format {dxgi} is not read by "
                                 f"PIL: {where}")
            n, signed = _BCN_DXGI[dxgi]
        elif fourcc in _BCN_FOURCC:
            n, signed = _BCN_FOURCC[fourcc]
        else:
            raise ValueError(f"DDS pixel format {fourcc!r} is not read by "
                             f"PIL: {where}")
        if n == 0:
            mode, bands = "RGBA", 4
        else:
            px = bcn.decode_bcn(buf[pos:], n, w, h, where, signed)
            return modes.to_rgba({1: "RGBA", 4: "L", 5: "RGB"}.get(
                n, "RGBA"), px[..., 0] if n == 4 else px)
    else:
        raise ValueError(f"DDS pixel format flags {pfflags:#x} are not read "
                         f"by PIL: {where}")
    need = w * h * bands
    if len(buf) - pos < need:
        raise ValueError(f"DDS data truncated: {where}")
    px = np.frombuffer(buf, np.uint8, need, pos).reshape(h, w, bands)
    return modes.to_rgba(mode, px[..., 0] if bands == 1 else px, palette)


def encode_dds(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> DDS bytes as PIL's DdsImagePlugin._save
    writes modes L, RGB and RGBA: uncompressed, the pixels as B, G, R(, A)
    or grey, with their masks."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    flags = _FLAG_CAPS | _FLAG_HEIGHT | _FLAG_WIDTH | _FLAG_PIXELFORMAT | 0x8
    if c == 1:
        pf, masks, px = _PF_LUMINANCE, [0xFF000000] * 3 + [0], img
    else:
        pf = _PF_RGB | (_PF_ALPHAPIXELS if c == 4 else 0)
        masks = [0xFF0000, 0xFF00, 0xFF, 0xFF000000 if c == 4 else 0]
        px = img[..., [2, 1, 0, 3][:c]]
    head = (struct.pack("<I7I", MAGIC, 124, flags, h, w, (w * 8 * c + 7) // 8,
                        0, 0) + bytes(44)
            + struct.pack("<4I", 32, pf, 0, 8 * c) + struct.pack("<4I", *masks)
            + struct.pack("<5I", _CAPS_TEXTURE, 0, 0, 0, 0))
    return head + np.ascontiguousarray(px).tobytes()
