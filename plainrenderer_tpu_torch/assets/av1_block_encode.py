"""Writing AV1 tiles: the tile decoder of assets/av1_block.py run with a
symbol writer in its symbol decoder's place.

Every syntax element of a tile is a read of the tile decoder: the writer
answers each read with the value a decision source gives for it, writes
that value with the arithmetic encoder (assets/av1_msac_encode.py) over
the very CDF the decoder passes, and returns it, so the decoder goes on
exactly as it would reading the written tile. The partition and
coefficient contexts, the CDF adaptation, the prediction and the
reconstruction are the decoder's own: the frame the writer leaves behind
is what any decoder of its tiles reconstructs.

A decision source answers ``symbol(name, cdf)`` (name as
av1_block.cdf_names gives it) and ``bool(icdf0)``. ``Replay`` answers
from the elements a RecordingDecoder read out of a file.
"""

from __future__ import annotations

import copy

from . import av1_block
from .av1_msac_encode import SymbolEncoder


class SymbolWriter:
    """The symbol decoder's interface over a SymbolEncoder and a source."""

    def __init__(self, source, disable_cdf_update: bool):
        self.enc = SymbolEncoder(disable_cdf_update)
        self.src = source
        self.names = {}

    def symbol(self, cdf: list) -> int:
        v = self.src.symbol(self.names.get(id(cdf), ("?", ())), cdf)
        return self.enc.symbol(cdf, v)

    def bool_prob(self, icdf0: int) -> int:
        return self.enc.bool_prob(icdf0, self.src.bool(icdf0))

    def bool(self) -> int:
        return self.bool_prob(16384)

    def literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bool_prob(16384)
        return x

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)


class Replay:
    """Answers each read with the next recorded element, which must be of
    the same kind."""

    def __init__(self, entries: list):
        self.entries = entries
        self.i = 0

    def _next(self, what):
        if self.i >= len(self.entries):
            raise ValueError(f"replay ran out of elements at {what}")
        e = self.entries[self.i]
        self.i += 1
        return e

    def symbol(self, name, cdf):
        e = self._next(name)
        if (e[0], e[1]) != name:
            raise ValueError(f"replay element {self.i - 1} is {e[:2]}, "
                             f"the decoder reads {name}")
        return e[2]

    def bool(self, icdf0):
        e = self._next("bool")
        if e[0] != "bool" or e[1] != icdf0:
            raise ValueError(f"replay element {self.i - 1} is {e[:2]}, "
                             f"the decoder reads a bit at {icdf0}")
        return e[2]


def write_tiles(seq, hdr, sources: list, tile_decoder=av1_block.TileDecoder):
    """Each tile's bytes, written in tile order with sources[t] deciding
    tile t, and the frame state the writing left (the reconstruction
    before the post filters). A source with a ``start`` method is handed
    its tile decoder before the tile."""
    fs = av1_block.FrameState(seq, hdr)
    fs.cdfs = av1_block.default_cdfs(hdr.base_q_idx)
    tiles = []
    for t, src in enumerate(sources):
        row, col = divmod(t, hdr.tile_cols)
        sw = SymbolWriter(src, hdr.disable_cdf_update)
        cdfs = copy.deepcopy(fs.cdfs)
        td = tile_decoder(fs, cdfs, sw, hdr.mi_row_starts[row],
                          hdr.mi_row_starts[row + 1], hdr.mi_col_starts[col],
                          hdr.mi_col_starts[col + 1])
        sw.names = av1_block.cdf_names(cdfs, td.mv_cdfs)
        if hasattr(src, "start"):
            src.start(td)
        td.decode()
        tiles.append(sw.enc.done())
    return tiles, fs
