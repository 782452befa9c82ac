"""PDF writing without PIL, as Pillow 12.1's PdfImagePlugin._save writes
one image with its default arguments, through PdfParser's writer: the
header and comment, the catalog (object 4) and page tree (5), the image
XObject (1) with PIL's default JPEG of the image as its DCTDecode stream
(assets/jpeg_encode.py; DeviceGray for grey, DeviceRGB for RGB), or for
RGBA PIL's default JPEG 2000 save as a JP2 file (assets/jp2.py) in a
JPXDecode stream with ``/SMaskInData 1`` (the alpha is in the data) and
no colour space or bit depth, the page (2) at 72 dpi and its content
stream (3), the info dictionary (6: the title, which is the file name
without its suffix, then the creation and modification dates from
``time.gmtime()`` at the call), the xref table and the trailer.
"""

from __future__ import annotations

import codecs
import time

import numpy as np

from . import jp2, jpeg_encode


def _string(value: bytes) -> bytes:
    """pdf_repr of bytes: a literal string with \\, ( and ) escaped."""
    value = value.replace(b"\\", b"\\\\").replace(b"(", b"\\(")
    return b"(" + value.replace(b")", b"\\)") + b")"


def _date(t: time.struct_time) -> bytes:
    return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode("us-ascii") \
        + b")"


def _dict(items: list[tuple[bytes, bytes]]) -> bytes:
    return b"<<" + b"".join(b"\n/" + k + b" " + v for k, v in items) \
        + b"\n>>"


def encode_pdf(image: np.ndarray, title: str = "") -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> PDF bytes; `title` is the file name's
    stem (PIL's Title entry, left out where empty)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    grey = img.ndim == 2
    if img.ndim == 3 and img.shape[2] == 4:
        stream = jp2.encode_jp2(img)
        kind = [(b"Filter", b"/JPXDecode"), (b"SMaskInData", b"1")]
    else:
        stream = jpeg_encode.encode_jpeg(img)
        kind = [(b"Filter", b"/DCTDecode"), (b"BitsPerComponent", b"8"),
                (b"ColorSpace", b"/DeviceGray" if grey else b"/DeviceRGB")]
    created, modified = time.gmtime(), time.gmtime()
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(num: int, body: bytes, stream: bytes | None = None) -> None:
        offsets[num] = len(out)
        out.extend(b"%d 0 obj" % num + body)
        if stream is not None:
            out.extend(b"stream\n" + stream + b"\nendstream\n")
        out.extend(b"endobj\n")

    obj(4, _dict([(b"Type", b"/Catalog"), (b"Pages", b"5 0 R")]))
    obj(5, _dict([(b"Type", b"/Pages"), (b"Count", b"1"),
                  (b"Kids", b"[ 2 0 R ]")]))
    obj(1, _dict([(b"Type", b"/XObject"), (b"Subtype", b"/Image"),
                  (b"Width", b"%d" % w), (b"Height", b"%d" % h)] + kind
                 + [(b"Length", b"%d" % len(stream))]), stream)
    resources = _dict([
        (b"ProcSet", b"[ /PDF /ImageB ]" if grey else b"[ /PDF /ImageC ]"),
        (b"XObject", _dict([(b"image", b"1 0 R")]))])
    box = f"[ 0 0 {w * 72.0 / 72.0} {h * 72.0 / 72.0} ]".encode()
    obj(2, _dict([(b"Resources", resources), (b"MediaBox", box),
                  (b"Contents", b"3 0 R"), (b"Type", b"/Page"),
                  (b"Parent", b"5 0 R")]))
    content = b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (w * 72.0 / 72.0,
                                                     h * 72.0 / 72.0)
    obj(3, _dict([(b"Length", b"%d" % len(content))]), content)
    info = [(b"Title", _string(codecs.BOM_UTF16_BE
                                + title.encode("utf_16_be")))] if title \
        else []
    obj(6, _dict(info + [(b"CreationDate", _date(created)),
                         (b"ModDate", _date(modified))]))
    start = len(out)
    out.extend(b"xref\n0 7\n%010d %05d f \n" % (0, 65536))
    for num in range(1, 7):
        out.extend(b"%010d %05d n \n" % (offsets[num], 0))
    out.extend(b"trailer\n" + _dict([(b"Root", b"4 0 R"), (b"Size", b"7"),
                                     (b"Info", b"6 0 R")])
               + b"\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)
