"""Encapsulated PostScript writing without PIL, as Pillow 12.1's
EpsImagePlugin._save writes .eps and .ps files (the same bytes for both):
the EPS header comments, an image procedure for 8-bit grey (``image``) or
RGB (``false 3 colorimage``), then the samples as lowercase hex by
libImaging/EpsEncode.c, 39 bytes (78 digits) to a line across rows, and
the closing lines. PIL's %-formatting gives "%ImageData" and leaves
"%%%%EndBinary" as it stands; both are kept. RGBA is refused, as PIL
refuses it.
"""

from __future__ import annotations

import numpy as np


def encode_eps(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) u8 -> EPS bytes."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError("EPS: image mode is not supported (PIL writes L "
                         "and RGB)")
    h, w = img.shape[:2]
    bands, op = (1, b"image") if img.ndim == 2 else (3, b"false 3 colorimage")
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)  # "%ImageData", as in PIL
            + b'%d %d 0 1 1 "%s"\n' % (8, bands, op)
            + b"gsave\n10 dict begin\n"
            + b"/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n%d %d 8\n" % (w, h, w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n" + op + b"\n")
    digits = np.ascontiguousarray(img).tobytes().hex().encode()
    lines = [digits[i:i + 78] for i in range(0, len(digits), 78)]
    return head + b"\n".join(lines) + b"\n%%%%EndBinary\ngrestore end\n"
