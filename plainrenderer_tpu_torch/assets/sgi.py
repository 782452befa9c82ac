"""SGI image reading and writing without PIL, as Pillow 12.1's
SgiImagePlugin.py reads (with its C run-length decoder, SgiRleDecode.c)
and writes it.

Read: verbatim and run-length storage, 1 and 2 bytes a sample, 1, 3 and 4
channels (the (bytes, dimension, channels) layouts of PIL's MODES table:
L, RGB and RGBA; 2-byte samples keep their high byte, as PIL's ;16B raw
modes do); rows bottom-up. What PIL refuses (2 channels, other layouts, a
run past the row or the file) raises ValueError naming it. PIL's decoder
quirks are kept: a run-length row that stops early keeps the previous
row's pixels after its end, and a row whose last counted byte is not the
terminator ends the decode there (later rows stay 0).

Write: L, RGB and RGBA with 1 byte a sample, verbatim, as PIL writes
them (.sgi, .rgb, .rgba and .bw alike), the file's stem in the header's
name field.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes

MAGIC = 474
EXTENSIONS = (".bw", ".rgb", ".rgba", ".sgi")
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
          (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
          (2, 3, 4): "RGBA"}
_HEADER = 512


def looks_like_sgi(head: bytes) -> bool:
    return len(head) >= 2 and struct.unpack_from(">H", head)[0] == MAGIC


def _expand_row(ptr, start, n, dest, bpc, end, xsize):
    """SgiRleDecode.c expandrow / expandrow2 into `dest` (xsize samples of
    bpc bytes): 0 when the row ends at its terminator, 1 when its last
    counted byte is not one, -1 on an overrun."""
    x, src = 0, start
    while n > 0:
        if src + bpc - 1 > end:
            return -1
        pixel = ptr[src + bpc - 1]
        src += bpc
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        if pixel & 0x80:
            if src + bpc * count > end:
                return -1
            dest[x:x + count] = np.frombuffer(
                ptr, np.uint8, bpc * count, src).reshape(count, bpc)[:, 0]
            src += bpc * count
        else:
            if src + bpc - 1 > end:
                return -1
            dest[x:x + count] = ptr[src]
            src += bpc
        x += count
        n -= 1
    return 0


def read_sgi(buf: bytes, where: str = "<sgi>") -> np.ndarray:
    """SGI bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if len(buf) < _HEADER or not looks_like_sgi(buf):
        raise ValueError(f"not an SGI file: {where}")
    storage, bpc = buf[2], buf[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">HHHH", buf, 4)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError(f"SGI layout of {bpc} bytes a sample, dimension "
                         f"{dimension} and {zsize} channels is not one PIL "
                         f"reads (Unsupported SGI image mode): {where}")
    if storage not in (0, 1):
        raise ValueError(f"SGI storage {storage} is neither verbatim nor "
                         f"run-length (PIL: cannot load this image): {where}")
    modes.check_size(xsize, ysize)
    bands = len(mode)
    px = np.zeros((ysize, xsize, bands), np.uint8)
    if storage == 0:
        page = xsize * ysize * bpc
        if len(buf) < _HEADER + bands * page:
            raise ValueError(f"SGI data truncated: {where}")
        data = np.frombuffer(buf, np.uint8, bands * page, _HEADER)
        planes = data.reshape(bands, ysize, xsize, bpc)[..., 0]
        px = planes.transpose(1, 2, 0)[::-1]
    else:
        n_rows = ysize * bands
        tables = np.frombuffer(buf, ">u4", 2 * n_rows, _HEADER)
        starts, lengths = tables[:n_rows], tables[n_rows:]
        ptr = buf[_HEADER:]
        end = len(ptr) - 1
        row = np.zeros((xsize, bands), np.uint8)
        for y in range(ysize):
            status = 0
            for c in range(bands):
                off = int(starts[y + c * ysize])
                length = int(lengths[y + c * ysize])
                if off < _HEADER:
                    raise ValueError(f"SGI run-length row {y} of channel {c} "
                                     f"starts in the header: {where}")
                status = _expand_row(ptr, off - _HEADER, length, row[:, c],
                                     bpc, end, xsize)
                if status == -1:
                    raise ValueError(f"SGI run-length row {y} of channel {c} "
                                     f"overruns its row or the file: {where}")
                if status == 1:
                    break
            if status == 1:
                break
            px[ysize - 1 - y] = row
    if mode == "L":
        px = np.repeat(px, 3, axis=2)
    out = np.full((ysize, xsize, 4), 255, np.uint8)
    out[..., :px.shape[2]] = px
    return out


def encode_sgi(image: np.ndarray, name: str = "") -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> verbatim SGI bytes as PIL's _save writes
    them for a file whose stem is `name`."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    z = 1 if img.ndim == 2 else img.shape[2]
    dimension = (1 if h == 1 else 2) if z == 1 else 3
    head = (struct.pack(">hBBHHHHll", MAGIC, 0, 1, dimension, w, h, z, 0,
                        255) + bytes(4)
            + struct.pack("79s", name.encode("ascii", "ignore")) + b"\0"
            + struct.pack(">l", 0) + bytes(404))
    planes = img.reshape(h, w, z)[::-1].transpose(2, 0, 1)
    return head + np.ascontiguousarray(planes).tobytes()
