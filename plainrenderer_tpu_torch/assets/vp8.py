"""VP8 (lossy WebP) decoding without PIL, bit for bit as libwebp 1.6
decodes a key frame (Pillow 12.1 reads WebP through libwebp):

  - the boolean decoder (src/utils/bit_reader_inl_utils.h VP8GetBit,
    VP8GetSigned, VP8GetValue), the frame and segment headers, the loop
    filter header, token partitions, quantisers (src/dec/quant_dec.c, the
    y2 AC * 155 / 100 rule and its floor of 8) and the coefficient
    probabilities with their updates (src/dec/tree_dec.c, vp8_dec.c);
  - the intra modes (16x16 and 4x4 luma with the 10 x 10 x 9 context
    probabilities, chroma) and the residual tokens with their non-zero
    contexts (vp8_dec.c GetCoeffs, ParseResiduals);
  - reconstruction (src/dec/frame_dec.c ReconstructRow): the 127 / 129
    borders, the above-right pixels of 4x4 blocks (replicated down the
    macroblock's right column), the DC modes without top or left, the
    inverse Walsh-Hadamard and DCT of src/dsp/dec.c with their int16
    storage;
  - the simple and normal loop filters (src/dsp/dec.c, strengths from
    PrecomputeFilterStrengths with segment and mode deltas and sharpness)
    over the whole frame in macroblock order, after reconstruction (intra
    prediction reads unfiltered pixels, as libwebp's top and left caches
    do);
  - the fancy upsampling of src/dsp/upsampling.c (UpsampleRgbaLinePair:
    the first row alone, then row pairs, the last row of an even height
    alone) and src/dsp/yuv.h's fixed-point YUV -> RGB (14-bit constants,
    YUV_FIX2 6).

The tables (coefficient probabilities and their update probabilities,
the 4x4 mode probabilities, the DC and AC quantiser steps) are libwebp's
(src/dec/tree_dec.c, src/dec/quant_dec.c). Tokens are decoded by a
Python loop; prediction per 4x4 block in Python; transforms, filters and
colour conversion in numpy.
"""

from __future__ import annotations

import types

import numpy as np

_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff"
    "fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff"
    "fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff"
    "fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee"
    "fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff"
    "fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe"
    "fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff"
    "fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff"
    "fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff"
    "fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_COEFFS_PROBA0 = bytes.fromhex(
    "8080808080808080808080808080808080808080808080808080808080808080"
    "80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80"
    "80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680"
    "808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff"
    "ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080"
    "8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051"
    "63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80"
    "80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80"
    "80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5"
    "f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080"
    "80d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7"
    "9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc"
    "cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179"
    "ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001"
    "01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda"
    "bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa"
    "2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b"
    "1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f"
    "ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566"
    "84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43"
    "2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e"
    "16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b"
    "33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045"
    "3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f"
    "069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b"
    "769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418")
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c"
    "1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a"
    "3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56,
    57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119,
    122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161,
    164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213,
    217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279,
    284)

_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
            (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: the 4x4 mode tree (-mode at the leaves)
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                  -8, -9)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3


class _Bool:
    """libwebp's VP8BitReader: range_ is the range minus 1, value_ holds
    the bits not yet consumed above bit position bits_."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.bits, self.range = 0, -8, 254
        self.eof = False

    def _load(self):
        if self.pos < len(self.data):
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
        else:
            self.value <<= 8
            self.eof = True
        self.bits += 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng = self.range
        pos = self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits = pos - shift
        return bit

    def signed(self, v: int) -> int:
        """VP8GetSigned: one bit at probability 1/2, always a shift of 1."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        neg = (self.value >> pos) > split
        self.bits = pos - 1
        if neg:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _i16(x):
    return ((np.asarray(x, np.int64) + 32768) & 0xFFFF) - 32768


# the rows x0 x1 x2 x3, MUL1(x0..3), MUL2(x0..3) -> TransformOne's four
# outputs of a pass (a = x0 + x2, b = x0 - x2, c = MUL2(x1) - MUL1(x3),
# d = MUL1(x1) + MUL2(x3); out = a + d, b + c, b - c, a - d)
_IDCT_PASS = np.array([[1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 1],
                       [1, 0, -1, 0, 0, 0, 0, -1, 0, 1, 0, 0],
                       [1, 0, -1, 0, 0, 0, 0, 1, 0, -1, 0, 0],
                       [1, 0, 1, 0, 0, -1, 0, 0, 0, 0, 0, -1]], np.int64)


def _mul12(x):
    """MUL1 and MUL2 of TransformOne."""
    return ((x * 20091) >> 16) + x, (x * 35468) >> 16


def idct_residual(c):
    """(..., 16) coefficients -> (..., 4, 4) residual (v >> 3) of
    TransformOne_C (the DC and AC3 shortcuts give the same values): each
    pass a product of the rows and their MUL1 / MUL2 images."""
    x = np.asarray(c, np.int64).reshape(c.shape[:-1] + (4, 4))
    m1, m2 = _mul12(x)
    tmp = _IDCT_PASS @ np.concatenate([x, m1, m2], -2)  # [k][col]
    tmp[..., 0] += 4
    t = np.swapaxes(tmp, -1, -2)  # [col][k]
    m1, m2 = _mul12(t)
    out = _IDCT_PASS @ np.concatenate([t, m1, m2], -2)  # [x][k]
    return np.swapaxes(out, -1, -2) >> 3


def _wht(dc):
    """TransformWHT_C: (16,) int16 -> the 16 blocks' DC, int16."""
    i = np.asarray(dc, np.int64).reshape(4, 4)
    a0, a1 = i[0] + i[3], i[1] + i[2]
    a2, a3 = i[1] - i[2], i[0] - i[3]
    tmp = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])
    d0 = tmp[:, 0] + 3
    b0, b1 = d0 + tmp[:, 3], tmp[:, 1] + tmp[:, 2]
    b2, b3 = tmp[:, 1] - tmp[:, 2], d0 - tmp[:, 3]
    out = np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], axis=1) >> 3
    return _i16(out.reshape(16))  # block 4 * row + k


def _parse_header(data: bytes, where: str):
    if len(data) < 10:
        raise ValueError(f"VP8 data truncated: {where}")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError(f"VP8 interframe (not a key frame): {where}")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"VP8 profile {(bits >> 1) & 7}: {where}")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"VP8 key frame start code missing: {where}")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError(f"VP8 frame of size {w}x{h}: {where}")
    if 10 + part0 > len(data):
        raise ValueError(f"VP8 first partition truncated: {where}")
    br = _Bool(data[10:10 + part0])
    hd = types.SimpleNamespace()
    hd.w, hd.h = w, h
    br.bit(0x80)  # colour space
    br.bit(0x80)  # clamping type
    hd.use_segment = br.bit(0x80)
    hd.update_map = 0
    hd.absolute_delta = 1
    hd.quantizer = [0] * 4
    hd.filter_strength = [0] * 4
    hd.segment_probs = [255] * 3
    if hd.use_segment:
        hd.update_map = br.bit(0x80)
        if br.bit(0x80):  # update data
            hd.absolute_delta = br.bit(0x80)
            hd.quantizer = [br.signed_value(7) if br.bit(0x80) else 0
                            for _ in range(4)]
            hd.filter_strength = [br.signed_value(6) if br.bit(0x80) else 0
                                  for _ in range(4)]
        if hd.update_map:
            hd.segment_probs = [br.value_bits(8) if br.bit(0x80) else 255
                                for _ in range(3)]
    hd.simple = br.bit(0x80)
    hd.level = br.value_bits(6)
    hd.sharpness = br.value_bits(3)
    hd.use_lf_delta = br.bit(0x80)
    hd.ref_lf_delta = [0] * 4
    hd.mode_lf_delta = [0] * 4
    if hd.use_lf_delta and br.bit(0x80):
        for i in range(4):
            if br.bit(0x80):
                hd.ref_lf_delta[i] = br.signed_value(6)
        for i in range(4):
            if br.bit(0x80):
                hd.mode_lf_delta[i] = br.signed_value(6)
    hd.filter_type = 0 if hd.level == 0 else 1 if hd.simple else 2
    # token partitions
    nparts = 1 << br.value_bits(2)
    rest = data[10 + part0:]
    if len(rest) < 3 * (nparts - 1):
        raise ValueError(f"VP8 partition sizes truncated: {where}")
    start = 3 * (nparts - 1)
    parts = []
    for p in range(nparts - 1):
        size = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16
        size = min(size, len(rest) - start)
        parts.append(_Bool(rest[start:start + size]))
        start += size
    parts.append(_Bool(rest[start:]))
    hd.parts = parts
    # quantisers
    base_q0 = br.value_bits(7)
    dq = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = dq

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v
    hd.dqm = []
    for s in range(4):
        if hd.use_segment:
            q = hd.quantizer[s] + (0 if hd.absolute_delta else base_q0)
        elif s > 0:
            hd.dqm.append(hd.dqm[0])
            continue
        else:
            q = base_q0
        y1 = (_DC_TABLE[clip(q + dqy1_dc, 127)], _AC_TABLE[clip(q, 127)])
        y2 = (_DC_TABLE[clip(q + dqy2_dc, 127)] * 2,
              max(8, (_AC_TABLE[clip(q + dqy2_ac, 127)] * 101581) >> 16))
        uv = (_DC_TABLE[clip(q + dquv_dc, 117)],
              _AC_TABLE[clip(q + dquv_ac, 127)])
        hd.dqm.append((y1, y2, uv))
    br.bit(0x80)  # update_proba, ignored
    proba = []
    for i in range(1056):
        proba.append(br.value_bits(8) if br.bit(_COEFFS_UPDATE_PROBA[i])
                     else _COEFFS_PROBA0[i])
    # bands[t][n] -> the three contexts' probabilities at position n
    hd.bands = [[[proba[((t * 8 + _BANDS[n]) * 3 + c) * 11:
                        ((t * 8 + _BANDS[n]) * 3 + c) * 11 + 11]
                  for c in range(3)] for n in range(17)] for t in range(4)]
    hd.use_skip = br.bit(0x80)
    hd.skip_p = br.value_bits(8) if hd.use_skip else 0
    hd.br = br
    return hd


def _parse_modes(hd):
    """Every macroblock's segment, skip flag and intra modes (the first
    partition, after the header)."""
    br = hd.br
    mbw, mbh = (hd.w + 15) >> 4, (hd.h + 15) >> 4
    top = [0] * (4 * mbw)
    mbs = []
    for _ in range(mbh):
        left = [0] * 4
        row = []
        for mx in range(mbw):
            if hd.update_map:
                p = hd.segment_probs
                seg = br.bit(p[1]) if not br.bit(p[0]) else 2 + br.bit(p[2])
            else:
                seg = 0
            skip = br.bit(hd.skip_p) if hd.use_skip else 0
            is4 = not br.bit(145)
            t = top[4 * mx:4 * mx + 4]
            if not is4:
                ymode = (TM_PRED if br.bit(128) else H_PRED) if br.bit(156) \
                    else (V_PRED if br.bit(163) else DC_PRED)
                modes = [ymode]
                t = [ymode] * 4
                left = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        base = (t[x] * 10 + ymode) * 9
                        i = _YMODES_INTRA4[br.bit(_BMODES_PROBA[base])]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(
                                _BMODES_PROBA[base + i])]
                        ymode = -i
                        t[x] = ymode
                        modes.append(ymode)
                    left[y] = ymode
            top[4 * mx:4 * mx + 4] = t
            uvmode = DC_PRED if not br.bit(142) else V_PRED \
                if not br.bit(114) else TM_PRED if br.bit(183) else H_PRED
            row.append((seg, skip, is4, modes, uvmode))
        mbs.append(row)
    return mbs


def _large_value(br, p):
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT3456[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br, prob, ctx, dq, n, out, base):
    """GetCoeffs: tokens of one block from position n into out[base:];
    returns the position after the last non-zero coefficient."""
    p = prob[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        nxt = prob[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        out[base + _ZIGZAG[n]] = br.signed(v) * dq[n > 0]
        n += 1
    return 16


def _residuals(hd, mbs):
    """All tokens -> per macroblock (coefficients (25, 16) int16 with the
    WHT's DCs in the Y blocks, whether any is non-zero)."""
    mbw = len(mbs[0])
    top_nz = [[0] * 9 for _ in range(mbw)]  # 4 y, 2 u, 2 v, dc
    coefs = []
    inner = []
    for my, row in enumerate(mbs):
        br = hd.parts[my & (len(hd.parts) - 1)]
        left_nz = [0] * 9
        for mx, (seg, skip, is4, modes, uvmode) in enumerate(row):
            tn = top_nz[mx]
            c = [0] * 384
            if hd.use_skip and skip:
                for k in range(8):
                    tn[k] = left_nz[k] = 0
                if not is4:
                    tn[8] = left_nz[8] = 0
                coefs.append(np.zeros((24, 16), np.int64))
                inner.append(False)
                continue
            y1, y2, uv = hd.dqm[seg]
            any_nz = False
            if not is4:
                dc = [0] * 16
                nz = _coeffs(br, hd.bands[1], tn[8] + left_nz[8], y2, 0, dc,
                             0)
                tn[8] = left_nz[8] = int(nz > 0)
                dcv = _i16(dc)
                if nz > 1:
                    dcs = _wht(dcv)
                else:
                    dcs = np.full(16, (int(dcv[0]) + 3) >> 3, np.int64)
                for k in range(16):
                    c[16 * k] = int(dcs[k])
                first, ac = 1, hd.bands[0]
                any_nz = any_nz or bool(dcs.any())
            else:
                first, ac = 0, hd.bands[3]
            for y in range(4):
                for x in range(4):
                    nz = _coeffs(br, ac, left_nz[y] + tn[x], y1, first, c,
                                 16 * (4 * y + x))
                    left_nz[y] = tn[x] = int(nz > first)
                    any_nz = any_nz or nz > first
            for ch in (0, 2):
                for y in range(2):
                    for x in range(2):
                        blk = 16 + 2 * ch + 2 * y + x
                        nz = _coeffs(br, hd.bands[2],
                                     left_nz[4 + ch + y] + tn[4 + ch + x],
                                     uv, 0, c, 16 * blk)
                        left_nz[4 + ch + y] = tn[4 + ch + x] = int(nz > 0)
                        any_nz = any_nz or nz > 0
            arr = _i16(c).reshape(24, 16)
            coefs.append(arr)
            inner.append(bool(arr.any()) or any_nz)
    return coefs, inner


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode, top, left, tl):
    """A 4x4 block's prediction (rows of 4) from its 8 top pixels (the
    last 4 above-right), 4 left pixels and the top-left one."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == 0:  # DC
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == 1:  # TM
        return [[min(255, max(0, left[y] + top[x] - X)) for x in range(4)]
                for y in range(4)]
    if mode == 2:  # VE
        r = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [r[:] for _ in range(4)]
    if mode == 3:  # HE
        vals = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                _avg3(K, L, L)]
        return [[v] * 4 for v in vals]
    d = [[0] * 4 for _ in range(4)]
    if mode == 4:  # RD
        e = [L, K, J, I, X, A, B, C, D]
        for y in range(4):
            for x in range(4):
                k = 3 - y + x + 1
                d[y][x] = _avg3(e[k - 1], e[k], e[k + 1])
        return d
    if mode == 5:  # VR
        d[0][0] = d[2][1] = _avg2(X, A)
        d[0][1] = d[2][2] = _avg2(A, B)
        d[0][2] = d[2][3] = _avg2(B, C)
        d[0][3] = _avg2(C, D)
        d[3][0] = _avg3(K, J, I)
        d[2][0] = _avg3(J, I, X)
        d[1][0] = d[3][1] = _avg3(I, X, A)
        d[1][1] = d[3][2] = _avg3(X, A, B)
        d[1][2] = d[3][3] = _avg3(A, B, C)
        d[1][3] = _avg3(B, C, D)
        return d
    if mode == 6:  # LD
        e = [A, B, C, D, E, F, G, H, H]
        for y in range(4):
            for x in range(4):
                k = x + y
                d[y][x] = _avg3(e[k], e[k + 1], e[k + 2])
        return d
    if mode == 7:  # VL
        d[0][0] = _avg2(A, B)
        d[0][1] = d[2][0] = _avg2(B, C)
        d[0][2] = d[2][1] = _avg2(C, D)
        d[0][3] = d[2][2] = _avg2(D, E)
        d[1][0] = _avg3(A, B, C)
        d[1][1] = d[3][0] = _avg3(B, C, D)
        d[1][2] = d[3][1] = _avg3(C, D, E)
        d[1][3] = d[3][2] = _avg3(D, E, F)
        d[2][3] = _avg3(E, F, G)
        d[3][3] = _avg3(F, G, H)
        return d
    if mode == 8:  # HD
        d[0][0] = d[1][2] = _avg2(I, X)
        d[1][0] = d[2][2] = _avg2(J, I)
        d[2][0] = d[3][2] = _avg2(K, J)
        d[3][0] = _avg2(L, K)
        d[0][3] = _avg3(A, B, C)
        d[0][2] = _avg3(X, A, B)
        d[0][1] = d[1][3] = _avg3(I, X, A)
        d[1][1] = d[2][3] = _avg3(J, I, X)
        d[2][1] = d[3][3] = _avg3(K, J, I)
        d[3][1] = _avg3(L, K, J)
        return d
    # HU
    d[0][0] = _avg2(I, J)
    d[0][2] = d[1][0] = _avg2(J, K)
    d[1][2] = d[2][0] = _avg2(K, L)
    d[0][1] = _avg3(I, J, K)
    d[0][3] = d[1][1] = _avg3(J, K, L)
    d[1][3] = d[2][1] = _avg3(K, L, L)
    d[2][3] = d[2][2] = d[3][0] = d[3][1] = d[3][2] = d[3][3] = L
    return d


def _pred_block(mode, size, top, left, tl, mx, my):
    """16x16 luma or 8x8 chroma prediction (numpy)."""
    if mode == DC_PRED:
        shift = 4 if size == 8 else 5
        if mx and my:
            v = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) \
                >> shift
        elif my:  # no left
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mx:  # no top
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(left[:, None] + top[None, :] - tl, 0, 255)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size)).copy()
    return np.broadcast_to(left[:, None], (size, size)).copy()


def _reconstruct(hd, mbs, coefs):
    mbw, mbh = len(mbs[0]), len(mbs)
    Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
    U = np.zeros((8 * mbh, 8 * mbw), np.int64)
    V = np.zeros((8 * mbh, 8 * mbw), np.int64)
    res = idct_residual(np.concatenate(coefs).reshape(-1, 16)).reshape(
        mbh, mbw, 24, 4, 4)
    for my in range(mbh):
        for mx in range(mbw):
            seg, skip, is4, modes, uvmode = mbs[my][mx]
            r = res[my, mx]
            y0, x0 = 16 * my, 16 * mx
            if my:
                top = Y[y0 - 1, x0:x0 + 16]
                tl = int(Y[y0 - 1, x0 - 1]) if mx else 129
            else:
                top = np.full(16, 127, np.int64)
                tl = 127
            left = Y[y0:y0 + 16, x0 - 1] if mx else np.full(16, 129, np.int64)
            if is4:
                if my == 0:
                    tr = [127] * 4
                elif mx == mbw - 1:
                    tr = [int(top[15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                wb = [[0] * 21 for _ in range(17)]
                wb[0] = [tl] + top.tolist() + tr
                for k in range(16):
                    wb[k + 1][0] = int(left[k])
                for k in (4, 8, 12):
                    wb[k][17:21] = tr
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    t = wb[4 * by][1 + 4 * bx:9 + 4 * bx]
                    lft = [wb[4 * by + 1 + k][4 * bx] for k in range(4)]
                    p = _pred4(modes[n], t, lft, wb[4 * by][4 * bx])
                    rb = r[n].tolist()
                    for yy in range(4):
                        rowp = wb[4 * by + 1 + yy]
                        for xx in range(4):
                            v = p[yy][xx] + rb[yy][xx]
                            rowp[1 + 4 * bx + xx] = 0 if v < 0 else \
                                255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.asarray(wb)[1:17, 1:17]
            else:
                p = _pred_block(modes[0], 16, top, left, tl, mx, my)
                blk = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
                    .reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(p + blk, 0, 255)
            c0, d0 = 8 * my, 8 * mx
            for plane, first in ((U, 16), (V, 20)):
                if my:
                    ctop = plane[c0 - 1, d0:d0 + 8]
                    ctl = int(plane[c0 - 1, d0 - 1]) if mx else 129
                else:
                    ctop = np.full(8, 127, np.int64)
                    ctl = 127
                cleft = plane[c0:c0 + 8, d0 - 1] if mx else \
                    np.full(8, 129, np.int64)
                p = _pred_block(uvmode, 8, ctop, cleft, ctl, mx, my)
                blk = r[first:first + 4].reshape(2, 2, 4, 4).transpose(
                    0, 2, 1, 3).reshape(8, 8)
                plane[c0:c0 + 8, d0:d0 + 8] = np.clip(p + blk, 0, 255)
    return Y, U, V


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _filter_edge(seg, thresh, ithresh, hev_t, kind):
    """One edge: seg is (n, 8) lines across it, p3 p2 p1 p0 | q0 q1 q2 q3,
    filtered in place by kind "simple", "mb" (FilterLoop26) or "inner"
    (FilterLoop24)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k].copy() for k in range(8))
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        mask &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh)
                 & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh)
                 & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    # DoFilter2 where hev (all of the simple filter)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    f2 = mask & hev
    seg[:, 3] = np.where(f2, _clip1(p0 + a2), seg[:, 3])
    seg[:, 4] = np.where(f2, _clip1(q0 - a1), seg[:, 4])
    if kind == "simple":
        return
    rest = mask & ~hev
    if kind == "mb":  # DoFilter6
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        b1 = (27 * a + 63) >> 7
        b2 = (18 * a + 63) >> 7
        b3 = (9 * a + 63) >> 7
        for k, v in ((1, p2 + b3), (2, p1 + b2), (3, p0 + b1),
                     (4, q0 - b1), (5, q1 - b2), (6, q2 - b3)):
            seg[:, k] = np.where(rest, _clip1(v), seg[:, k])
    else:  # DoFilter4
        a = 3 * (q0 - p0)
        b1 = _sclip2((a + 4) >> 3)
        b2 = _sclip2((a + 3) >> 3)
        b3 = (b1 + 1) >> 1
        for k, v in ((2, p1 + b3), (3, p0 + b2), (4, q0 - b1),
                     (5, q1 - b3)):
            seg[:, k] = np.where(rest, _clip1(v), seg[:, k])


def _filter_strengths(hd):
    out = {}
    for s in range(4):
        if hd.use_segment:
            base = hd.filter_strength[s] + (0 if hd.absolute_delta
                                            else hd.level)
        else:
            base = hd.level
        for i4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0]
                if i4:
                    level += hd.mode_lf_delta[0]
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                ilevel = level
                if hd.sharpness > 0:
                    ilevel >>= 2 if hd.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hd.sharpness)
                ilevel = max(ilevel, 1)
                out[s, i4] = (2 * level + ilevel, ilevel,
                              2 if level >= 40 else 1 if level >= 15 else 0)
            else:
                out[s, i4] = (0, 0, 0)
    return out


def _loop_filter(hd, mbs, inner, Y, U, V):
    if hd.filter_type == 0:
        return
    strengths = _filter_strengths(hd)
    mbw = len(mbs[0])
    for my, row in enumerate(mbs):
        for mx, (seg, skip, is4, modes, uvmode) in enumerate(row):
            limit, ilevel, hev_t = strengths[seg, int(is4)]
            if limit == 0:
                continue
            f_inner = is4 or inner[my * mbw + mx]
            planes = ((Y, 16),) if hd.filter_type == 1 else \
                ((Y, 16), (U, 8), (V, 8))
            kind_mb = "simple" if hd.filter_type == 1 else "mb"
            kind_in = "simple" if hd.filter_type == 1 else "inner"
            order = []  # DoFilter's order: left, inner columns, top, rows
            if mx > 0:
                order.append(("h", limit + 4, kind_mb))
            if f_inner:
                order.append(("hi", limit, kind_in))
            if my > 0:
                order.append(("v", limit + 4, kind_mb))
            if f_inner:
                order.append(("vi", limit, kind_in))
            for direction, thresh, kind in order:
                for plane, size in planes:
                    y0, x0 = size * my, size * mx
                    edges = [0] if direction in ("h", "v") else \
                        list(range(4, size, 4))
                    for e in edges:
                        if direction.startswith("h"):
                            x = x0 + e
                            seg_ = plane[y0:y0 + size, x - 4:x + 4]
                            _filter_edge(seg_, thresh, ilevel, hev_t, kind)
                        else:
                            y = y0 + e
                            seg_ = plane[y - 4:y + 4, x0:x0 + size].T
                            _filter_edge(seg_, thresh, ilevel, hev_t, kind)


def _upsample_rows(top_u, cur_u, W):
    """UpsampleRgbaLinePair's chroma for one channel: the top and bottom
    output rows' samples (W each) from two chroma rows."""
    tl, l_ = top_u[:-1], cur_u[:-1]
    t, uv = top_u[1:], cur_u[1:]
    avg = tl + t + l_ + uv + 8
    d12 = (avg + 2 * (t + l_)) >> 3
    d03 = (avg + 2 * (tl + uv)) >> 3
    top = np.empty(W, np.int64)
    bot = np.empty(W, np.int64)
    top[0] = (3 * top_u[0] + cur_u[0] + 2) >> 2
    bot[0] = (3 * cur_u[0] + top_u[0] + 2) >> 2
    npair = (W - 1) >> 1
    top[1:2 * npair:2] = ((d12 + tl) >> 1)[:npair]
    top[2:2 * npair + 1:2] = ((d03 + t) >> 1)[:npair]
    bot[1:2 * npair:2] = ((d03 + l_) >> 1)[:npair]
    bot[2:2 * npair + 1:2] = ((d12 + uv) >> 1)[:npair]
    if W % 2 == 0:
        k = npair
        top[W - 1] = (3 * top_u[k] + cur_u[k] + 2) >> 2
        bot[W - 1] = (3 * cur_u[k] + top_u[k] + 2) >> 2
    return top, bot


def _upsample(Uc, H, W):
    """Chroma (ceil(H/2), ceil(W/2)) -> (H, W) by libwebp's fancy
    upsampler."""
    out = np.empty((H, W), np.int64)
    out[0] = _upsample_rows(Uc[0], Uc[0], W)[0]
    for k in range(1, (H + 1) // 2 + 1):
        r = 2 * k - 1
        if r >= H:
            break
        if k < Uc.shape[0]:
            t, b = _upsample_rows(Uc[k - 1], Uc[k], W)
            out[r] = t
            if r + 1 < H:
                out[r + 1] = b
        else:  # the last row of an even height: its chroma row alone
            out[r] = _upsample_rows(Uc[k - 1], Uc[k - 1], W)[0]
    return out


def _yuv_to_rgb(y, u, v):
    def mh(a, c):
        return (a * c) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))
    r = clip8(mh(y, 19077) + mh(v, 26149) - 14234)
    g = clip8(mh(y, 19077) - mh(u, 6419) - mh(v, 13320) + 8708)
    b = clip8(mh(y, 19077) + mh(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_rgb(data: bytes, where: str = "<vp8>") -> np.ndarray:
    """A VP8 key frame (the "VP8 " chunk's payload) -> (H, W, 3) u8 RGB as
    libwebp's WebPDecode gives it in MODE_RGBA with fancy upsampling."""
    hd = _parse_header(data, where)
    mbs = _parse_modes(hd)
    coefs, inner = _residuals(hd, mbs)
    Y, U, V = _reconstruct(hd, mbs, coefs)
    _loop_filter(hd, mbs, inner, Y, U, V)
    H, W = hd.h, hd.w
    uh, uw = (H + 1) // 2, (W + 1) // 2
    u = _upsample(U[:uh, :uw], H, W)
    v = _upsample(V[:uh, :uw], H, W)
    return _yuv_to_rgb(Y[:H, :W], u, v)
