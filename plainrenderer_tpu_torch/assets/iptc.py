"""IPTC/NAA image records without PIL, as Pillow 12.1's IptcImagePlugin.py
reads them.

PIL tries every file as IPTC (the plugin has no magic test): the fields
are 0x1C, record, dataset, then a 16-bit size (or, above 0x80, a size of
that many further bytes); a first byte other than 0x1C or a record number
outside 1-9 and 240 is not IPTC. The header fields before the first
image-data field (8:10) give the layers and component flag (3:60), the
width (3:20), the height (3:30), the compression (3:120: 1 raw, 5 JPEG)
and, for RGB and CMYK, the band the data fills (3:65, counted from 1; 0
is the last band). The image is every consecutive 8:10 field's bytes:
raw data is PIL's P5 stream of the header's size; JPEG data is decoded as
the file it is (assets/jpeg.py for a band, which must be grey; any format
image_io reads for a grey image). A band image is that band with the
others zero.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jpeg, modes

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _int(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(buf: bytes, pos: int):
    """IptcImageFile.field: (tag or None, size, next position)."""
    s = buf[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 3:
        raise IndexError("IPTC field cut short")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise modes.NotThisFormat("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        n = size - 128
        size = _int(buf[pos:pos + n])
        pos += n
    else:
        size = struct.unpack(">H", s[3:5])[0]
    return tag, size, pos


def read_iptc(buf: bytes, where: str = "<iptc>",
              decode_image=None) -> np.ndarray:
    """IPTC bytes -> (H, W, 4) u8; `decode_image` is image_io's, for
    an image record that holds another file."""
    info = {}
    pos = 0
    try:
        while True:
            offset = pos
            tag, size, pos = _field(buf, pos)
            if not tag or tag == (8, 10):
                break
            data = buf[pos:pos + size] if size else None
            pos += size if size else 0
            if tag in info:
                old = info[tag]
                info[tag] = (old if isinstance(old, list) else [old]) + [data]
            else:
                info[tag] = data
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        if layers == 1 and not component:
            mode, band = "L", None
        else:
            mode = {3: "RGB", 4: "CMYK"}.get(layers, "") if component else ""
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = _int(info[(3, 20)]), _int(info[(3, 30)])
    except (KeyError, IndexError, TypeError, struct.error) as e:
        raise modes.NotThisFormat(f"not an IPTC image: {e!r}") from None
    except ValueError as e:
        if isinstance(e, modes.NotThisFormat):
            raise
        raise ValueError(f"{e}: {where}") from None
    try:
        compression = {1: "raw", 5: "jpeg"}[_int(info[(3, 120)])]
    except KeyError:
        raise ValueError(f"unknown IPTC image compression: {where}") from None
    except TypeError:
        raise modes.NotThisFormat("IPTC compression field empty") from None
    if not mode or w <= 0 or h <= 0:
        raise modes.NotThisFormat("IPTC image without a mode PIL opens")
    modes.check_size(w, h)
    if tag != (8, 10):
        raise ValueError(f"IPTC record without image data (PIL: cannot load "
                         f"this image): {where}")
    parts, pos = [], offset
    while True:
        try:
            tag, size, pos = _field(buf, pos)
        except (IndexError, struct.error, modes.NotThisFormat) as e:
            raise ValueError(f"IPTC image data field broken ({e}): "
                             f"{where}") from None
        if tag != (8, 10):
            break
        parts.append(buf[pos:pos + size])
        pos += size
    data = b"".join(parts)
    if compression == "raw":
        if len(data) < w * h:
            raise ValueError(f"IPTC raw image truncated: {where}")
        grey = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
    elif band is None:
        return decode_image(data, where)
    else:
        if not data.startswith(b"\xff\xd8"):
            raise ValueError(f"IPTC band image that is not JPEG is not read "
                             f"by the port: {where}")
        samples, _ = jpeg.decode_components(data, where)
        if samples.shape[2] != 1:
            raise ValueError(f"IPTC band image is not grey (PIL: mode "
                             f"mismatch): {where}")
        grey = samples[..., 0]
    if band is None:
        return modes.to_rgba("L", grey)
    n = 3 if mode == "RGB" else 4
    if not -n <= band < n:
        raise ValueError(f"IPTC band {band + 1} of {mode}: {where}")
    px = np.zeros(grey.shape + (n,), np.uint8)
    px[..., band] = grey
    return modes.to_rgba(mode, px)
