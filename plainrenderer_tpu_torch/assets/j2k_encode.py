"""JPEG 2000 codestreams written as PIL 12.1's default JPEG 2000 save
writes them through OpenJPEG 2.5.4 (lossless, one tile, one layer).

``encode_j2k`` takes (H, W), (H, W, 3) or (H, W, 4) uint8 and writes:

  - SOC;
  - SIZ: Rsiz 0, the image and its one tile at the origin, 8-bit
    unsigned components without subsampling;
  - COD: no precincts, SOP or EPH, LRCP, one layer, no colour transform
    (the MCT byte is 0 for RGB and RGBA too), min(5, floor(log2(min(W,
    H)))) decomposition levels (PIL lowers OpenJPEG's 6 resolutions
    until the smaller side holds 2^levels samples), 64 x 64 code-blocks,
    code-block style 0, the reversible 5/3 transform;
  - QCD: no quantisation with 2 guard bits, each sub-band's exponent the
    precision plus its gain (LL 0, HL and LH 1, HH 2), shifted up by 3;
  - COM: Rcom 1 (Latin text), ``Created by OpenJPEG version 2.5.4``;
  - SOT (tile 0, Psot the tile-part's length, part 0 of 1), SOD, the
    packets, EOC.

Each component is level-shifted by -128, transformed (j2k_fdwt), split
into the code-blocks of j2k_t2.tile_geometry, coded by j2k_t1_encode and
packed into packets by j2k_t2_encode."""

from __future__ import annotations

import struct
import types

import numpy as np

from . import j2k_fdwt, j2k_t1_encode, j2k_t2, j2k_t2_encode
from .j2k_codestream import COD, COM, EOC, QCD, SIZ, SOC, SOD, SOT, Tcp
from .j2k_recon import band_origin

COMMENT = b"Created by OpenJPEG version 2.5.4"
PREC = 8
GUARD_BITS = 2
CBLK_LOG2 = 6  # 64 x 64 code-blocks


def num_resolutions(w: int, h: int) -> int:
    """PIL's number of resolutions: OpenJPEG's default of 6, lowered
    until 2^(resolutions - 1) fits in both sides."""
    n = 6
    while w < 1 << (n - 1) or h < 1 << (n - 1):
        n -= 1
    return n


def _exponents(numres: int) -> list:
    """The reversible exponent of every sub-band in QCD order."""
    return [PREC] + [PREC + gain for _ in range(numres - 1)
                     for gain in (1, 1, 2)]


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def coding_parameters(w: int, h: int, nc: int, numres: int):
    """(codestream, tile coding parameters) as j2k_t2.tile_geometry and
    packet_order take them: nc 8-bit components in one w x h tile, PIL's
    coding options at numres resolutions."""
    cs = types.SimpleNamespace(x0=0, y0=0, x1=w, y1=h, tx0=0, ty0=0,
                               tdx=w, tdy=h, tw=1, th=1,
                               comps=[(PREC, 0, 1, 1)] * nc)
    tcp = Tcp(nc)
    tcp.numlayers = 1
    for t in tcp.tccps:
        t.numres = numres
        t.cblkw = t.cblkh = CBLK_LOG2
        t.qmfbid = 1
        t.numgbits = GUARD_BITS
        t.steps = [(e, 0) for e in _exponents(numres)]
        t.prcw = t.prch = [15] * numres
    return cs, tcp


def encode_j2k(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) uint8 -> a J2K codestream."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    numres = num_resolutions(w, h)
    exps = _exponents(numres)
    cs, tcp = coding_parameters(w, h, nc, numres)
    tile, comps = j2k_t2.tile_geometry(cs, 0, tcp)
    blocks, cblks = [], []
    for c, tc in enumerate(comps):
        plane = img[..., c].astype(np.int32) - (1 << (PREC - 1))
        j2k_fdwt.forward_dwt(plane, tc)
        for resno, r in enumerate(tc.res):
            for b in r.bands:
                xoff, yoff = band_origin(tc, resno, b)
                for pr in b.precincts:
                    for cb in pr.cblks:
                        x0, y0 = cb.x0 - b.x0 + xoff, cb.y0 - b.y0 + yoff
                        blocks.append((plane[y0:y0 + cb.y1 - cb.y0,
                                             x0:x0 + cb.x1 - cb.x0],
                                       b.bandno))
                        cblks.append(cb)
    for cb, (data, numbps, passes) in zip(
            cblks, j2k_t1_encode.encode_cblks(blocks)):
        cb.chunks, cb.numbps, cb.newpasses = [data], numbps, passes
    data = j2k_t2_encode.encode_tile_packets(tcp, comps, tile)
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) \
        + bytes([PREC - 1, 1, 1]) * nc
    cod = bytes([0, 0, 0, 1, 0, numres - 1, CBLK_LOG2 - 2, CBLK_LOG2 - 2,
                 0, 1])
    qcd = bytes([GUARD_BITS << 5] + [e << 3 for e in exps])
    sot = struct.pack(">HIBB", 0, 14 + len(data), 0, 1)
    return (struct.pack(">H", SOC) + _segment(SIZ, siz) + _segment(COD, cod)
            + _segment(QCD, qcd) + _segment(COM, b"\x00\x01" + COMMENT)
            + _segment(SOT, sot) + struct.pack(">H", SOD) + data
            + struct.pack(">H", EOC))
