"""AV1's multi-symbol arithmetic decoder (the AV1 specification, section
8.2: init_symbol, read_symbol with CDF adaptation, read_bool, read_literal,
exit_symbol).

The CDFs are Python lists in the inverted form assets/av1_cdf.py stores:
``32768 - cdf`` for each of the N symbols (the last is 0), then the
adaptation count. The decoder keeps the specification's 15-bit
SymbolValue as the top of a wider window of inverted stream bits, so a
byte is read only when fewer than 16 bits of lookahead are left; the
arithmetic on the window equals the specification's bit by bit.
"""

from __future__ import annotations


class SymbolDecoder:
    __slots__ = ("data", "start", "pos", "end", "dif", "k", "rng", "update",
                 "shifted")

    def __init__(self, data: bytes, pos: int, size: int,
                 disable_cdf_update: bool):
        if size < 1:
            raise ValueError("AV1 tile of size 0")
        self.data = data
        self.start = pos
        self.pos = pos
        self.end = pos + size
        self.update = not disable_cdf_update
        self.dif = 0
        self.k = -15           # lookahead bits below the 15-bit value
        self.rng = 0x8000
        self.shifted = 0       # renormalisation bits so far
        self._refill()

    def _refill(self):
        data, pos, end, dif, k = self.data, self.pos, self.end, self.dif, self.k
        while k < 16:
            b = data[pos] if pos < end else 0
            pos += 1
            dif = (dif << 8) | (b ^ 0xFF)
            k += 8
        self.pos, self.dif, self.k = pos, dif, k

    def symbol(self, cdf: list) -> int:
        """read_symbol over an N-symbol CDF (len(cdf) == N + 1)."""
        n = len(cdf) - 1
        k = self.k
        c = self.dif >> k
        r8 = self.rng >> 8
        u = v = self.rng
        val = -1
        while True:
            val += 1
            u = v
            v = ((r8 * (cdf[val] >> 6)) >> 1) + 4 * (n - 1 - val)
            if c >= v:
                break
        self.dif -= v << k
        rng = u - v
        d = 16 - rng.bit_length()
        self.rng = rng << d
        self.shifted += d
        k -= d
        self.k = k
        if k < 16:
            self._refill()
        if self.update:
            cnt = cdf[n]
            rate = 4 + (cnt >> 4) + (n > 3)
            for i in range(n - 1):
                if i < val:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            cdf[n] = cnt + (cnt < 32)
        return val

    def bool_prob(self, icdf0: int) -> int:
        """A two-symbol read with the fixed inverted CDF [icdf0, 0] (no
        adaptation): 1 with probability icdf0 / 32768."""
        k = self.k
        c = self.dif >> k
        v = (((self.rng >> 8) * (icdf0 >> 6)) >> 1) + 4
        if c >= v:
            self.dif -= v << k
            rng = self.rng - v
            bit = 0
        else:
            rng = v
            bit = 1
        d = 16 - rng.bit_length()
        self.rng = rng << d
        self.shifted += d
        k -= d
        self.k = k
        if k < 16:
            self._refill()
        return bit

    def bool(self) -> int:
        return self.bool_prob(16384)

    def literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bool_prob(16384)
        return x

    def ns(self, n: int) -> int:
        """NS(n) read with bools (palette map start, loop restoration)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)

    def trailing_ok(self) -> bool:
        """exit_symbol's padding check: the bit after the consumed ones is
        1 and the rest of the tile is 0 (a parse that kept step with the
        encoder ends there)."""
        pos = self.start * 8 + self.shifted
        if pos >= self.end * 8:
            return False
        byte = self.data[pos >> 3]
        if not (byte >> (7 - (pos & 7))) & 1:
            return False
        rest = byte & ((1 << (7 - (pos & 7))) - 1)
        return rest == 0 and not any(self.data[(pos >> 3) + 1:self.end])
