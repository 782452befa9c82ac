"""DDS image read/write, byte-compatible with the reference's ImageIO
(a copy of plainrenderer_tpu/assets/dds.py).

Parity: Plain/src/Common/ImageIO.cpp:118-446 (reader) and :448-586 (writer).
The renderer uses DDS for two things:
  - baked 3D SDF volumes: R16_FLOAT via DX10 header (SceneSDF.cpp:506-508)
  - optionally BC-compressed material textures (reader passes raw blocks).

We implement the DX10-header path fully (R16_FLOAT, R8G8B8A8_UNORM) and read
BC1/BC3/BC5 headers with raw payload passthrough, like the reference.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

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
