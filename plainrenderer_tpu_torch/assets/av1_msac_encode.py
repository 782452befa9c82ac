"""AV1's multi-symbol arithmetic encoder, the inverse of assets/
av1_msac.py: the Daala range encoder as libaom writes AV1 tiles
(od_ec_encode_q15, od_ec_encode_bool_q15, od_ec_enc_normalize and
od_ec_enc_done, with the carry propagated over the bytes at the end).

The encoder mirrors the decoder's interface: ``symbol(cdf, value)`` and
``bool_prob(icdf0, bit)`` over the same inverted CDF lists, which it
adapts as the decoder does, so one CDF state serves both directions.
``done()`` returns the tile's bytes, ending in the padding the decoder's
exit process checks (a 1 bit after the last one it needs, then zeros).
"""

from __future__ import annotations


class SymbolEncoder:
    __slots__ = ("low", "rng", "cnt", "buf", "update")

    def __init__(self, disable_cdf_update: bool = False):
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.buf = []          # bytes before the carry (each up to 0x1FF)
        self.update = not disable_cdf_update

    def _normalize(self, low: int, rng: int):
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.buf.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self.buf.append(low >> c)
            s = c + d - 24
            low &= m
        self.low = low << d
        self.rng = rng << d
        self.cnt = s

    def symbol(self, cdf: list, val: int) -> int:
        """Encode val over an N-symbol CDF (len(cdf) == N + 1) and adapt
        the CDF as read_symbol does."""
        n = len(cdf) - 1
        r = self.rng
        r8 = r >> 8
        low = self.low
        v = ((r8 * (cdf[val] >> 6)) >> 1) + 4 * (n - 1 - val)
        if val > 0:
            u = ((r8 * (cdf[val - 1] >> 6)) >> 1) + 4 * (n - val)
            low += r - u
            r = u - v
        else:
            r -= v
        self._normalize(low, r)
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

    def bool_prob(self, icdf0: int, bit: int) -> int:
        """A two-symbol write with the fixed inverted CDF [icdf0, 0]."""
        r = self.rng
        v = (((r >> 8) * (icdf0 >> 6)) >> 1) + 4
        low = self.low
        if bit:
            low += r - v
            r = v
        else:
            r -= v
        self._normalize(low, r)
        return bit

    def done(self) -> bytes:
        """od_ec_enc_done: the fewest bits that decode every symbol written
        whatever follows, a 1 bit, zeros to the byte, carries propagated."""
        buf = list(self.buf)
        low, c = self.low, self.cnt
        s = c + 10
        m = 0x3FFF
        e = ((low + m) & ~m) | (m + 1)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                buf.append(e >> (c + 16))
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry += buf[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)
