"""The lossless (VP8L) stream of a WebP alpha plane, byte for byte as
libwebp 1.6.0 writes it for Pillow's lossy saves (src/enc/alpha_enc.c
EncodeLossless: the plane in the green channel of an otherwise zero
ARGB picture, exact, method 4, quality 8 * 4 = 32; src/enc/vp8l_enc.c
VP8LEncodeStream without the 5-byte VP8L header):

  - analysis (EncoderAnalyze, AnalyzeEntropy): a palette of the plane's
    values, sorted, always fits; 16 values or fewer take it at once, more
    compare the fixed-point entropies of the direct, spatially predicted,
    green-subtracted and palette codings (the green-subtracted ones never
    win on a green-only picture and are refused here);
  - the palette path: the deltas-minimising order where the sorted
    deltas change sign (PaletteSortMinimizeDeltas), the indices bundled
    8, 4 or 2 to a pixel for 2, 4 or 16 values, the palette stored delta
    coded as a sub-image, the colour cache capped at log2(values) + 1
    bits, and standard-plus-RLE and box LZ77 both tried for 16 values or
    fewer;
  - the spatial path: one of the 14 predictors per tile by the
    fixed-point cost of its residuals against the running histograms
    (GetBestPredictorForTile), the tile size grown where neighbouring
    tiles agree (VP8LOptimizeSampling), the predictor image and the
    residuals;
  - every image (EncodeImageInternal, EncodeImageNoHuffman): the hash
    chain (quality 32: 8 + 32 * 32 / 128 candidates, a window of 64
    rows), LZ77 (standard, RLE, box), the colour-cache size by estimated
    bits, the cost-model re-parse (BackwardReferencesTraceBackwards,
    quality >= 25), 2-D distance codes, the histogram image with its
    stochastic and greedy clustering, length-limited Huffman codes with
    the RLE-friendly count smoothing, and the code-length codes.

Only that configuration is ported; a picture outside it raises
ValueError. Python loops per pixel: fine for texture-sized alpha planes.
"""

from __future__ import annotations

import math

import numpy as np

from .vp8l import _CODE_TO_PLANE
from .vp8l import _subimage_size as subsample

LOG2_BITS = 23
_LOG2_RECIPROCAL_FIXED = 12102203
_LOG2_RECIPROCAL_FIXED_DOUBLE = 12102203.161561485
LOG2_TABLE = [0] + [math.floor(math.log2(i) * (1 << LOG2_BITS) + 0.5)
                    for i in range(1, 256)]
SLOG2_TABLE = [0] + [math.floor(i * math.log2(i) * (1 << LOG2_BITS) + 0.5)
                     for i in range(1, 256)]
MAX_LENGTH_BITS = 12
MAX_LENGTH = (1 << MAX_LENGTH_BITS) - 1
WINDOW_SIZE = (1 << 20) - 120
MIN_LENGTH = 4
NUM_LITERAL_CODES, NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 256, 24, 40
MAX_COLOR_CACHE_BITS = 10
MAX_PALETTE_SIZE = 256
MIN_TRANSFORM_BITS, MAX_TRANSFORM_BITS = 2, 9
MIN_HUFFMAN_BITS, MAX_HUFFMAN_BITS = 2, 9
MAX_HUFF_IMAGE_SIZE = 2600
NON_TRIVIAL = 0xFFFF
ARGB_BLACK = 0xFF000000
_STORAGE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                  14, 15)
LZ77_STANDARD, LZ77_RLE, LZ77_BOX = 1, 2, 4
LITERAL, CACHE, COPY = 0, 1, 2
DIRECT, SPATIAL, SUB_GREEN, SPATIAL_SUB_GREEN, PALETTE = range(5)
# plane_to_code_lut: the inverse of the decoder's kCodeToPlane
_PLANE_TO_CODE = [255] * 128
for _code, _v in enumerate(_CODE_TO_PLANE):
    _PLANE_TO_CODE[_v] = _code


def _div_round(a: int, b: int) -> int:
    """DivRound: a / b rounded half away from zero, as C computes it."""
    if (a < 0) == (b < 0):
        return _cdiv(a + b // 2 if b >= 0 else a + -((-b) // 2), b)
    return _cdiv(a - (b // 2 if b >= 0 else -((-b) // 2)), b)


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fast_log2(v: int) -> int:
    """VP8LFastLog2 in LOG2_BITS fixed point."""
    if v < 256:
        return LOG2_TABLE[v]
    if v < 65536:
        log_cnt = v.bit_length() - 1 - 7
        y = 1 << log_cnt
        out = LOG2_TABLE[v >> log_cnt] + (log_cnt << LOG2_BITS)
        if v >= 4096:
            out += _div_round(_LOG2_RECIPROCAL_FIXED * (v & (y - 1)), v)
        return out
    return int(_LOG2_RECIPROCAL_FIXED_DOUBLE * math.log(v) + .5)


def fast_slog2(v: int) -> int:
    """VP8LFastSLog2: v * log2(v) in LOG2_BITS fixed point."""
    if v < 256:
        return SLOG2_TABLE[v]
    if v < 65536:
        log_cnt = v.bit_length() - 1 - 7
        y = 1 << log_cnt
        return (v * (LOG2_TABLE[v >> log_cnt] + (log_cnt << LOG2_BITS))
                + _LOG2_RECIPROCAL_FIXED * (v & (y - 1)))
    return int(_LOG2_RECIPROCAL_FIXED_DOUBLE * v * math.log(v) + .5)


def _refine(nonzeros: int, total: int, max_val: int, entropy: int) -> int:
    """BitsEntropyRefine."""
    if nonzeros < 5:
        if nonzeros <= 1:
            return 0
        if nonzeros == 2:
            return _div_round(99 * (total << LOG2_BITS) + entropy, 100)
        mix = 950 if nonzeros == 3 else 700
    else:
        mix = 627
    min_limit = (2 * total - max_val) << LOG2_BITS
    min_limit = _div_round(mix * min_limit + (1000 - mix) * entropy, 1000)
    return max(entropy, min_limit)


def bits_entropy(array) -> int:
    """VP8LBitsEntropy."""
    total = nonzeros = max_val = ent = 0
    for x in array:
        if x:
            total += x
            nonzeros += 1
            ent += fast_slog2(x)
            if x > max_val:
                max_val = x
    return _refine(nonzeros, total, max_val, fast_slog2(total) - ent)


def _initial_huffman_cost() -> int:
    return ((19 * 3) << LOG2_BITS) - _div_round(91 << LOG2_BITS, 10)


_INITIAL_HUFFMAN_COST = _initial_huffman_cost()


def population_cost(pop):
    """PopulationCost over a population (VP8LGetEntropyUnrefined with
    streaks): (cost, trivial symbol, whether used)."""
    total = nonzeros = max_val = ent = 0
    nonzero_code = NON_TRIVIAL
    counts = [0, 0]
    streaks = [[0, 0], [0, 0]]
    n = len(pop)
    i_prev = 0
    x_prev = pop[0]
    i = 1

    def helper(val, i):
        nonlocal total, nonzeros, max_val, ent, nonzero_code, x_prev, i_prev
        streak = i - i_prev
        if x_prev:
            total += x_prev * streak
            nonzeros += streak
            nonzero_code = i_prev
            ent += fast_slog2(x_prev) * streak
            if x_prev > max_val:
                max_val = x_prev
        nz = 1 if x_prev else 0
        counts[nz] += streak > 3
        streaks[nz][streak > 3] += streak
        x_prev = val
        i_prev = i

    while i < n:
        x = pop[i]
        if x != x_prev:
            helper(x, i)
        i += 1
    helper(0, i)
    ent = fast_slog2(total) - ent
    extra = (counts[0] * 1600 + 240 * streaks[0][1] + counts[1] * 2640
             + 720 * streaks[1][1] + 1840 * streaks[0][0]
             + 3360 * streaks[1][0])
    cost = _refine(nonzeros, total, max_val, ent) + _INITIAL_HUFFMAN_COST \
        + (extra << (LOG2_BITS - 10))
    trivial = nonzero_code if nonzeros == 1 else NON_TRIVIAL
    used = bool(streaks[1][0] or streaks[1][1])
    return cost, trivial, used


def _extra_cost(pop, length: int) -> int:
    cost = pop[4] + pop[5]
    for i in range(2, length // 2 - 1):
        cost += i * (pop[2 * i + 2] + pop[2 * i + 3])
    return cost


def prefix_encode(distance: int):
    """VP8LPrefixEncode: (code, extra bits, extra bits' value)."""
    if distance <= 2:
        return distance - 1, 0, 0
    d = distance - 1
    hb = d.bit_length() - 1
    second = (d >> (hb - 1)) & 1
    extra = hb - 1
    return 2 * hb + second, extra, d & ((1 << extra) - 1)


def distance_to_plane_code(xsize: int, dist: int) -> int:
    yoffset = dist // xsize
    xoffset = dist - yoffset * xsize
    if xoffset <= 8 and yoffset < 8:
        return _PLANE_TO_CODE[yoffset * 16 + 8 - xoffset] + 1
    if xoffset > xsize - 8 and yoffset < 7:
        return _PLANE_TO_CODE[(yoffset + 1) * 16 + 8 + (xsize - xoffset)] + 1
    return dist + 120


def _hash_pix(argb: int, shift: int) -> int:
    return ((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift


def _sub_pixels(a: int, b: int) -> int:
    return ((0x00FF00FF + (a & 0xFF00FF00) - (b & 0xFF00FF00)) & 0xFF00FF00
            | (0xFF00FF00 + (a & 0x00FF00FF) - (b & 0x00FF00FF))
            & 0x00FF00FF)


# ------------------------------------------------------------ histograms

class Histogram:
    """VP8LHistogram: literal (green, lengths, cache), red, blue, alpha,
    distance populations, their cached costs."""

    def __init__(self, cache_bits: int):
        self.cache_bits = cache_bits
        self.pops = [[0] * (280 + ((1 << cache_bits) if cache_bits else 0)),
                     [0] * 256, [0] * 256, [0] * 256, [0] * 40]
        self.costs = [0] * 5
        self.trivial = [NON_TRIVIAL] * 5
        self.used = [False] * 5
        self.bit_cost = 0

    def add(self, v, xsize=None) -> None:
        """HistogramAddSinglePixOrCopy (with the plane-code distance
        modifier where xsize is given)."""
        kind, a, length = v
        lit, red, blue, alpha, dist = self.pops
        if kind == LITERAL:
            alpha[a >> 24] += 1
            red[(a >> 16) & 255] += 1
            lit[(a >> 8) & 255] += 1
            blue[a & 255] += 1
        elif kind == CACHE:
            lit[280 + a] += 1
        else:
            lit[256 + prefix_encode(length)[0]] += 1
            d = a if xsize is None else distance_to_plane_code(xsize, a)
            dist[prefix_encode(d)[0]] += 1

    def update_cost(self) -> None:
        for i in range(5):
            self.costs[i], self.trivial[i], self.used[i] = \
                population_cost(self.pops[i])
        self.bit_cost = sum(self.costs)

    def estimate_bits(self) -> int:
        """VP8LHistogramEstimateBits."""
        cost = sum(population_cost(p)[0] for p in self.pops)
        return cost + ((_extra_cost(self.pops[0][256:], 24)
                        + _extra_cost(self.pops[4], 40)) << LOG2_BITS)


def histogram_of(refs, cache_bits, xsize=None) -> Histogram:
    h = Histogram(cache_bits)
    for v in refs:
        h.add(v, xsize)
    return h


def _combined_entropy(h1, h2, i) -> int:
    """GetCombinedEntropy for population i."""
    used1, used2 = h1.used[i], h2.used[i]
    trivial = h1.trivial[i] != NON_TRIVIAL and h1.trivial[i] == h2.trivial[i]
    if trivial or not used1 or not used2:
        return h1.costs[i] if used1 else h2.costs[i]
    pop = [a + b for a, b in zip(h1.pops[i], h2.pops[i])]
    return population_cost(pop)[0]


def _combined_cost(h1, h2):
    costs = [_combined_entropy(h1, h2, i) for i in range(5)]
    return sum(costs), costs


def _histo_add(h1, h2) -> Histogram:
    """HistogramAdd into a new histogram."""
    out = Histogram(h1.cache_bits)
    for i in range(5):
        if h1.used[i] and h2.used[i]:
            out.pops[i] = [a + b for a, b in zip(h1.pops[i], h2.pops[i])]
        elif h1.used[i]:
            out.pops[i] = list(h1.pops[i])
        elif h2.used[i]:
            out.pops[i] = list(h2.pops[i])
        out.trivial[i] = h1.trivial[i] if h1.trivial[i] == h2.trivial[i] \
            else NON_TRIVIAL
        out.used[i] = h1.used[i] or h2.used[i]
    return out


class _Queue:
    """HistoQueue: pairs [cost_diff, idx1, idx2, cost_combo, costs]."""

    def __init__(self, max_size):
        self.q = []
        self.max_size = max_size

    def update_head(self, k):
        if self.q[k][0] < self.q[0][0]:
            self.q[0], self.q[k] = self.q[k], self.q[0]

    def pop(self, k):
        self.q[k] = self.q[-1]
        self.q.pop()

    @staticmethod
    def pair(histos, idx1, idx2, threshold):
        h1, h2 = histos[idx1], histos[idx2]
        sum_cost = h1.bit_cost + h2.bit_cost
        combo, costs = _combined_cost(h1, h2)
        if threshold + sum_cost <= 0 or combo >= threshold + sum_cost:
            return [combo - sum_cost if threshold + sum_cost > 0 else
                    -sum_cost, idx1, idx2, 0, costs]
        return [combo - sum_cost, idx1, idx2, combo, costs]

    def push(self, arr, idx1, idx2, threshold) -> int:
        if len(self.q) == self.max_size:
            return 0
        if idx1 > idx2:
            idx1, idx2 = idx2, idx1
        p = self.pair(arr, idx1, idx2, threshold)
        if p[0] >= threshold:
            return 0
        self.q.append(p)
        self.update_head(len(self.q) - 1)
        return p[0]


def _merge_remove(arr, size, p) -> int:
    """Merge arr[p.idx2] into arr[p.idx1] with the pair's costs, then
    HistogramSetRemoveHistogram: the last histogram takes idx2's slot
    (its old slot keeps pointing at it). Returns the new size."""
    _, idx1, idx2, combo, costs = p
    out = _histo_add(arr[idx2], arr[idx1])
    out.costs = list(costs)
    out.bit_cost = combo
    arr[idx1] = out
    arr[idx2] = arr[size - 1]
    return size - 1


def _combine_stochastic(arr, size, min_cluster_size):
    """HistogramCombineStochastic over arr[:size] (MINSTD pair picks):
    (new size, whether the greedy pass follows)."""
    if size < min_cluster_size:
        return size, True
    seed = 1
    tries_no_success = 0
    outer_iters = size
    num_tries_no_success = outer_iters // 2
    queue = _Queue(9)
    for _ in range(outer_iters):
        if size < min_cluster_size:
            break
        tries_no_success += 1
        if tries_no_success >= num_tries_no_success:
            break
        best_cost = queue.q[0][0] if queue.q else 0
        rand_range = (size - 1) * size
        num_tries = size // 2
        j = 0
        while size >= 2 and j < num_tries:
            seed = (seed * 48271) % 2147483647
            tmp = seed % rand_range
            idx1 = tmp // (size - 1)
            idx2 = tmp % (size - 1)
            if idx2 >= idx1:
                idx2 += 1
            curr = queue.push(arr, idx1, idx2, best_cost)
            if curr < 0:
                best_cost = curr
                if len(queue.q) == queue.max_size:
                    break
            j += 1
        if not queue.q:
            continue
        best = queue.q[0]
        b1, b2 = best[1], best[2]
        size = _merge_remove(arr, size, best)
        j = 0
        while j < len(queue.q):
            p = queue.q[j]
            is1 = p[1] in (b1, b2)
            is2 = p[2] in (b1, b2)
            if is1 and is2:
                queue.pop(j)
                continue
            if is1 or is2:
                if is1:
                    p[1] = b1
                else:
                    p[2] = b1
                if p[1] > p[2]:
                    p[1], p[2] = p[2], p[1]
                p[:] = _Queue.pair(arr, p[1], p[2], 0)
                if p[0] >= 0:
                    queue.pop(j)
                    continue
            if p[1] == size:
                p[1] = b2
            if p[2] == size:
                p[2] = b2
            if p[1] > p[2]:
                p[1], p[2] = p[2], p[1]
            queue.update_head(j)
            j += 1
        tries_no_success = 0
    return size, size <= min_cluster_size


def _combine_greedy(arr, size) -> int:
    """HistogramCombineGreedy over arr[:size]; returns the new size."""
    queue = _Queue(size * size)
    for i in range(size):
        for j in range(i + 1, size):
            queue.push(arr, i, j, 0)
    while queue.q:
        best = queue.q[0]
        idx1, idx2 = best[1], best[2]
        size = _merge_remove(arr, size, best)
        i = 0
        while i < len(queue.q):
            p = queue.q[i]
            if p[1] in (idx1, idx2) or p[2] in (idx1, idx2):
                queue.pop(i)
                continue
            if p[1] == size:
                p[1] = idx2
            if p[2] == size:
                p[2] = idx2
            if p[1] > p[2]:
                p[1], p[2] = p[2], p[1]
            queue.update_head(i)
            i += 1
        for i in range(size):
            if i != idx1:
                queue.push(arr, idx1, i, 0)
    return size


def _bin_id(lo: int, hi: int, v: int) -> int:
    return int((v - lo) * 3.999999 / (hi - lo)) if hi > lo else 0


def _trivial_rba(h) -> bool:
    return all(h.trivial[i] != NON_TRIVIAL for i in (1, 2, 3))


def _combine_entropy_bins(arr, size, quality, raw_size) -> int:
    """HistogramAnalyzeEntropyBin and HistogramCombineEntropyBin: each
    histogram binned by its literal, red and blue costs (4 x 4 x 4 bins),
    merged into the first of its bin where that saves a cost-factor share
    of its bits (and the merge keeps red, blue and alpha trivial, or
    neither side had them trivial, or the bin failed 32 times)."""
    factor = 16
    if quality < 90:
        for limit in (256, 512, 1024):
            if raw_size > limit:
                factor //= 2
        if quality <= 50:
            factor //= 2
    lo = [min(h.costs[i] for h in arr[:size]) for i in range(3)]
    hi = [max(h.costs[i] for h in arr[:size]) for i in range(3)]
    bins = {}
    for h in arr[:size]:
        b = 0
        for i in range(3):
            b = b * 4 + _bin_id(lo[i], hi[i], h.costs[i])
        bins[id(h)] = b
    first = [-1] * 64
    failures = [0] * 64
    idx = 0
    while idx < size:
        h = arr[idx]
        b = bins[id(h)]
        if first[b] == -1:
            first[b] = idx
            idx += 1
            continue
        f = arr[first[b]]
        thresh = -_div_round(h.bit_cost * factor, 100) + f.bit_cost \
            + h.bit_cost
        combo, costs = _combined_cost(f, h)
        if thresh <= 0 or combo >= thresh:
            idx += 1
            continue
        merged = _histo_add(f, h)
        merged.costs, merged.bit_cost = costs, combo
        if (_trivial_rba(merged) or (not _trivial_rba(h)
                                     and not _trivial_rba(f))
                or failures[b] >= 32):
            arr[first[b]] = merged
            arr[idx] = arr[size - 1]
            size -= 1
        else:
            failures[b] += 1
            idx += 1
    return size


def histo_image_symbols(xsize, ysize, refs, quality, histogram_bits,
                        cache_bits):
    """VP8LGetHistoImageSymbols: (cluster histograms, symbol per tile)."""
    hx = subsample(xsize, histogram_bits)
    hy = subsample(ysize, histogram_bits)
    orig = [Histogram(cache_bits) for _ in range(hx * hy)]
    x = y = 0
    for v in refs:
        orig[(y >> histogram_bits) * hx + (x >> histogram_bits)].add(v)
        x += v[2]
        while x >= xsize:
            x -= xsize
            y += 1
    symbols = [0] * (hx * hy)
    arr = []
    for i, h in enumerate(orig):
        h.update_cost()
        if not any(h.used):
            orig[i] = None
            continue
        c = Histogram(cache_bits)
        c.pops = [list(p) for p in h.pops]
        c.costs, c.trivial, c.used = list(h.costs), list(h.trivial), \
            list(h.used)
        c.bit_cost = h.bit_cost
        arr.append(c)
    size = len(arr)
    if size > 2 * 64 and quality < 100:
        size = _combine_entropy_bins(arr, size, quality, hx * hy)
    threshold = 1 + _div_round(quality ** 3 * 99, 100 ** 3)
    size, do_greedy = _combine_stochastic(arr, size, threshold)
    if do_greedy:
        size = _combine_greedy(arr, size)
    out = arr[:size]
    if len(out) > 1:
        for i, h in enumerate(orig):
            if h is None:
                symbols[i] = symbols[i - 1]
                continue
            best_out, best_bits = 0, None
            for k, o in enumerate(out):
                thresh = (1 << 63) - 1 if best_bits is None \
                    else best_bits + o.bit_cost
                if thresh <= 0:
                    continue
                cost, _ = _combined_cost(o, h)
                if cost < thresh:
                    best_bits = cost - o.bit_cost
                    best_out = k
            symbols[i] = best_out
    final = [Histogram(cache_bits) for _ in out]
    for f in final:
        f.used = [False] * 5
    for i, h in enumerate(orig):
        if h is None:
            continue
        f = final[symbols[i]]
        for k in range(5):
            if h.used[k]:
                f.pops[k] = [a + b for a, b in zip(f.pops[k], h.pops[k])] \
                    if f.used[k] else list(h.pops[k])
            f.used[k] = f.used[k] or h.used[k]
    return final, symbols


# ------------------------------------------------------------ Huffman

def _optimize_for_rle(counts) -> None:
    """OptimizeHuffmanForRle, in place."""
    length = len(counts)
    while length > 0 and counts[length - 1] == 0:
        length -= 1
    if length == 0:
        return
    good = [False] * length
    symbol = counts[0]
    stride = 0
    for i in range(length + 1):
        if i == length or counts[i] != symbol:
            if (symbol == 0 and stride >= 5) or (symbol != 0 and stride >= 7):
                for k in range(stride):
                    good[i - k - 1] = True
            stride = 1
            if i != length:
                symbol = counts[i]
        else:
            stride += 1
    stride = 0
    limit = counts[0]
    total = 0
    for i in range(length + 1):
        if (i == length or good[i] or (i != 0 and good[i - 1])
                or not abs(counts[i] - limit) < 4):
            if stride >= 4 or (stride >= 3 and total == 0):
                count = (total + stride // 2) // stride
                if count < 1:
                    count = 1
                if total == 0:
                    count = 0
                for k in range(stride):
                    counts[i - k - 1] = count
            stride = 0
            total = 0
            if i < length - 3:
                limit = (counts[i] + counts[i + 1] + counts[i + 2]
                         + counts[i + 3] + 2) // 4
            elif i < length:
                limit = counts[i]
            else:
                limit = 0
        stride += 1
        if i != length:
            total += counts[i]
            if stride >= 4:
                limit = (total + stride // 2) // stride


def _optimal_depths(histogram, limit):
    """GenerateOptimalTree: code lengths of at most `limit` bits."""
    n = len(histogram)
    depths = [0] * n
    nonzero = [j for j in range(n) if histogram[j]]
    if not nonzero:
        return depths
    count_min = 1
    while True:
        # leaves: [count, value, left, right]
        tree = sorted(([max(histogram[j], count_min), j, -1, -1]
                       for j in nonzero), key=lambda t: (-t[0], t[1]))
        pool = []
        if len(tree) > 1:
            while len(tree) > 1:
                pool.append(tree.pop())
                pool.append(tree.pop())
                count = pool[-1][0] + pool[-2][0]
                k = 0
                while k < len(tree) and tree[k][0] > count:
                    k += 1
                tree.insert(k, [count, -1, len(pool) - 1, len(pool) - 2])
            stack = [(tree[0], 0)]
            while stack:
                node, level = stack.pop()
                if node[2] >= 0:
                    stack.append((pool[node[3]], level + 1))
                    stack.append((pool[node[2]], level + 1))
                else:
                    depths[node[1]] = level
        else:
            depths[tree[0][1]] = 1
        if max(depths) <= limit:
            return depths
        count_min *= 2


def _codes(depths):
    """ConvertBitDepthsToSymbols: canonical codes, bit-reversed."""
    count = [0] * 16
    for d in depths:
        count[d] += 1
    count[0] = 0
    next_code = [0] * 16
    code = 0
    for i in range(1, 16):
        code = (code + count[i - 1]) << 1
        next_code[i] = code
    out = []
    for d in depths:
        c = next_code[d]
        next_code[d] += 1
        out.append(int(f"{c:0{d}b}"[::-1], 2) if d else 0)
    return out


class Code:
    def __init__(self, histogram, limit=15):
        counts = list(histogram)
        _optimize_for_rle(counts)
        self.lengths = _optimal_depths(counts, limit)
        self.codes = _codes(self.lengths)

    def clear_if_single(self):
        if sum(1 for d in self.lengths if d) <= 1:
            self.lengths = [0] * len(self.lengths)
            self.codes = [0] * len(self.codes)


class BitWriter:
    """VP8LBitWriter: LSB first."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.used = 0

    def put(self, value: int, nbits: int) -> None:
        if nbits:
            self.acc |= value << self.used
            self.used += nbits
            while self.used >= 8:
                self.buf.append(self.acc & 255)
                self.acc >>= 8
                self.used -= 8

    def num_bytes(self) -> int:
        return len(self.buf) + ((self.used + 7) >> 3)

    def clone(self) -> "BitWriter":
        c = BitWriter()
        c.buf, c.acc, c.used = bytearray(self.buf), self.acc, self.used
        return c

    def finish(self) -> bytes:
        return bytes(self.buf) + (bytes((self.acc & 255,)) if self.used
                                  else b"")


def _rle_tokens(lengths):
    """VP8LCreateCompressedHuffmanTree: (code, extra bits) tokens."""
    tokens = []
    prev = 8
    i, n = 0, len(lengths)
    while i < n:
        value = lengths[i]
        k = i + 1
        while k < n and lengths[k] == value:
            k += 1
        runs = k - i
        if value == 0:
            while runs >= 1:
                if runs < 3:
                    tokens += [(0, 0)] * runs
                    break
                if runs < 11:
                    tokens.append((17, runs - 3))
                    break
                if runs < 139:
                    tokens.append((18, runs - 11))
                    break
                tokens.append((18, 0x7F))
                runs -= 138
        else:
            if value != prev:
                tokens.append((value, 0))
                runs -= 1
            while runs >= 1:
                if runs < 3:
                    tokens += [(value, 0)] * runs
                    break
                if runs < 7:
                    tokens.append((16, runs - 3))
                    break
                tokens.append((16, 3))
                runs -= 6
            prev = value
        i += k - i
    return tokens


def store_code(bw: BitWriter, code: Code) -> None:
    """StoreHuffmanCode."""
    syms = [i for i, d in enumerate(code.lengths) if d][:3]
    count = len(syms)
    if count == 0:
        bw.put(0x01, 4)
    elif count <= 2 and all(s < 256 for s in syms):
        bw.put(1, 1)
        bw.put(count - 1, 1)
        if syms[0] <= 1:
            bw.put(0, 1)
            bw.put(syms[0], 1)
        else:
            bw.put(1, 1)
            bw.put(syms[0], 8)
        if count == 2:
            bw.put(syms[1], 8)
    else:
        bw.put(0, 1)
        tokens = _rle_tokens(code.lengths)
        hist = [0] * 19
        for c, _ in tokens:
            hist[c] += 1
        cl = Code(hist, 7)
        n_store = 19
        while n_store > 4 and cl.lengths[_STORAGE_ORDER[n_store - 1]] == 0:
            n_store -= 1
        bw.put(n_store - 4, 4)
        for i in range(n_store):
            bw.put(cl.lengths[_STORAGE_ORDER[i]], 3)
        cl.clear_if_single()
        trailing = 0
        trimmed = len(tokens)
        for c, _ in reversed(tokens):
            if c in (0, 17, 18):
                trimmed -= 1
                trailing += cl.lengths[c] + (3 if c == 17 else 7 if c == 18
                                             else 0)
            else:
                break
        write_trimmed = trimmed > 1 and trailing > 12
        length = trimmed if write_trimmed else len(tokens)
        bw.put(int(write_trimmed), 1)
        if write_trimmed:
            if trimmed == 2:
                bw.put(0, 5)
            else:
                nbits = (trimmed - 2).bit_length() - 1
                nbitpairs = nbits // 2 + 1
                bw.put(nbitpairs - 1, 3)
                bw.put(trimmed - 2, nbitpairs * 2)
        for c, extra in tokens[:length]:
            bw.put(cl.codes[c], cl.lengths[c])
            if c == 16:
                bw.put(extra, 2)
            elif c == 17:
                bw.put(extra, 3)
            elif c == 18:
                bw.put(extra, 7)


def store_image(bw, width, histo_bits, refs, symbols, codes) -> None:
    """StoreImageToBitMask."""
    hx = subsample(width, histo_bits) if histo_bits else 1
    mask = -(1 << histo_bits) if histo_bits else 0
    x = y = 0
    tile = (0, 0)
    group = codes[symbols[0]]
    for kind, a, length in refs:
        if tile != (x & mask, y & mask):
            tile = (x & mask, y & mask)
            group = codes[symbols[(y >> histo_bits) * hx + (x >> histo_bits)]]
        if kind == LITERAL:
            for k, s in ((0, 8), (1, 16), (2, 0), (3, 24)):
                c = group[k]
                sym = (a >> s) & 255
                bw.put(c.codes[sym], c.lengths[sym])
        elif kind == CACHE:
            c = group[0]
            bw.put(c.codes[280 + a], c.lengths[280 + a])
        else:
            code, nb, bits = prefix_encode(length)
            c = group[0]
            bw.put(c.codes[256 + code], c.lengths[256 + code])
            bw.put(bits, nb)
            code, nb, bits = prefix_encode(a)
            c = group[4]
            bw.put(c.codes[code], c.lengths[code])
            bw.put(bits, nb)
        x += length
        while x >= width:
            x -= width
            y += 1


# ------------------------------------------------- backward references

def _hash64(p0: int, p1: int) -> int:
    key = ((p1 * 0xC6A4A793) & 0xFFFFFFFF) + ((p0 * 0x5BD1E996) & 0xFFFFFFFF)
    return (key & 0xFFFFFFFF) >> 14


class _Pixels:
    """The picture as a list, with fast mismatch lengths."""

    def __init__(self, argb):
        self.a = list(argb)
        self.np = np.asarray(argb, np.uint32)

    def mismatch(self, i: int, j: int, n: int) -> int:
        """VP8LVectorMismatch of a[i:] and a[j:] over n."""
        a = self.a
        k = 0
        while k < n and k < 16:
            if a[i + k] != a[j + k]:
                return k
            k += 1
        if k == n:
            return n
        d = np.flatnonzero(self.np[i + k:i + n] != self.np[j + k:j + n])
        return k + int(d[0]) if len(d) else n

    def match(self, i: int, j: int, best: int, n: int) -> int:
        """FindMatchLength(a + i, a + j, best, n)."""
        if self.a[i + best] != self.a[j + best]:
            return 0
        return self.mismatch(i, j, n)


def hash_chain_fill(px: _Pixels, xsize, ysize, quality):
    """VP8LHashChainFill -> offset << 12 | length per pixel."""
    argb = px.a
    size = xsize * ysize
    if size <= 2:
        return [0] * size
    iter_max = 8 + quality * quality // 128
    window = (WINDOW_SIZE if quality > 75 else xsize << 8 if quality > 50
              else xsize << 6 if quality > 25 else xsize << 4)
    window = min(window, WINDOW_SIZE)
    chain = [-1] * size
    first = {}
    argb_comp = argb[0] == argb[1]
    pos = 0
    while pos < size - 2:
        comp_next = argb[pos + 1] == argb[pos + 2]
        if argb_comp and comp_next:
            color = argb[pos]
            ln = 1
            while pos + ln + 2 < size and argb[pos + ln + 2] == color:
                ln += 1
            if ln > MAX_LENGTH:
                pos += ln - MAX_LENGTH
                ln = MAX_LENGTH
            while ln:
                h = _hash64(color, ln)
                ln -= 1
                chain[pos] = first.get(h, -1)
                first[h] = pos
                pos += 1
            argb_comp = False
        else:
            h = _hash64(argb[pos], argb[pos + 1])
            chain[pos] = first.get(h, -1)
            first[h] = pos
            pos += 1
            argb_comp = comp_next
    chain[pos] = first.get(_hash64(argb[pos], argb[pos + 1]), -1)
    out = [0] * size
    base = size - 2
    while base > 0:
        max_len = min(size - 1 - base, MAX_LENGTH)
        it = iter_max
        best_length = best_distance = 0
        min_pos = base - window if base > window else 0
        length_max = min(max_len, 256)
        pos = chain[base]
        if base >= xsize:
            cl = px.match(base - xsize, base, best_length, max_len)
            if cl > best_length:
                best_length, best_distance = cl, xsize
            it -= 1
        cl = px.match(base - 1, base, best_length, max_len)
        if cl > best_length:
            best_length, best_distance = cl, 1
        it -= 1
        if best_length == MAX_LENGTH:
            pos = min_pos - 1
        best_argb = argb[base + best_length]
        while pos >= min_pos:
            it -= 1
            if it == 0:
                break
            if argb[pos + best_length] == best_argb:
                cl = px.mismatch(pos, base, max_len)
                if best_length < cl:
                    best_length = cl
                    best_distance = base - pos
                    best_argb = argb[base + best_length]
                    if best_length >= length_max:
                        break
            pos = chain[pos]
        max_base = base
        while True:
            out[base] = (best_distance << MAX_LENGTH_BITS) | best_length
            base -= 1
            if best_distance == 0 or base == 0:
                break
            if base < best_distance or argb[base - best_distance] != \
                    argb[base]:
                break
            if (best_length == MAX_LENGTH and best_distance != 1
                    and base + MAX_LENGTH < max_base):
                break
            if best_length < MAX_LENGTH:
                best_length += 1
                max_base = base
    return out


class _Cache:
    def __init__(self, bits):
        self.bits = bits
        self.colors = [0] * (1 << bits)

    def key(self, argb):
        return _hash_pix(argb, 32 - self.bits)

    def insert(self, argb):
        self.colors[self.key(argb)] = argb

    def contains(self, argb) -> int:
        k = self.key(argb)
        return k if self.colors[k] == argb else -1


def _literal(argb, cache, refs):
    if cache is not None:
        k = cache.key(argb)
        if cache.colors[k] == argb:
            refs.append((CACHE, k, 1))
            return
        cache.colors[k] = argb
    refs.append((LITERAL, argb, 1))


def lz77_standard(px, xsize, ysize, cache_bits, chain):
    argb = px.a
    cache = _Cache(cache_bits) if cache_bits else None
    refs = []
    n = xsize * ysize
    i = 0
    i_last_check = -1
    while i < n:
        ol = chain[i]
        offset, ln = ol >> MAX_LENGTH_BITS, ol & MAX_LENGTH
        if ln >= MIN_LENGTH:
            len_ini = ln
            max_reach = 0
            j_max = n - 1 if i + len_ini >= n else i + len_ini
            i_last_check = max(i, i_last_check)
            for j in range(i_last_check + 1, j_max + 1):
                len_j = chain[j] & MAX_LENGTH
                reach = j + (len_j if len_j >= MIN_LENGTH else 1)
                if reach > max_reach:
                    ln = j - i
                    max_reach = reach
                    if max_reach >= n:
                        break
        else:
            ln = 1
        if ln == 1:
            _literal(argb[i], cache, refs)
        else:
            refs.append((COPY, offset, ln))
            if cache is not None:
                for j in range(i, i + ln):
                    cache.insert(argb[j])
        i += ln
    return refs


def lz77_rle(px, xsize, ysize, cache_bits):
    argb = px.a
    cache = _Cache(cache_bits) if cache_bits else None
    refs = []
    n = xsize * ysize
    _literal(argb[0], cache, refs)
    i = 1
    while i < n:
        max_len = min(n - i, MAX_LENGTH)
        rle_len = px.match(i, i - 1, 0, max_len)
        prev_row = 0 if i < xsize else px.match(i, i - xsize, 0, max_len)
        if rle_len >= prev_row and rle_len >= MIN_LENGTH:
            refs.append((COPY, 1, rle_len))
            i += rle_len
        elif prev_row >= MIN_LENGTH:
            refs.append((COPY, xsize, prev_row))
            if cache is not None:
                for k in range(prev_row):
                    cache.insert(argb[i + k])
            i += prev_row
        else:
            _literal(argb[i], cache, refs)
            i += 1
    return refs


def _window_offsets(xsize):
    offsets = [0] * 32
    for y in range(7):
        for x in range(-6, 7):
            off = y * xsize + x
            if off <= 0:
                continue
            pc = distance_to_plane_code(xsize, off) - 1
            if pc >= 32:
                continue
            offsets[pc] = off
    offsets = [o for o in offsets if o]
    new = [o for o in offsets if not any(o == p + 1 for p in offsets)]
    return offsets, new


def lz77_box(px, xsize, ysize, cache_bits, chain_best):
    argb = px.a
    n = xsize * ysize
    counts = [0] * n
    counts[n - 1] = 1
    for i in range(n - 2, -1, -1):
        if argb[i] == argb[i + 1]:
            counts[i] = counts[i + 1] + (counts[i + 1] != MAX_LENGTH)
        else:
            counts[i] = 1
    offsets, offsets_new = _window_offsets(xsize)
    chain = [0] * n
    best_offset_prev = best_length_prev = -1
    for i in range(1, n):
        best_length = chain_best[i] & MAX_LENGTH
        do_compute = True
        if best_length >= MAX_LENGTH:
            best_offset = chain_best[i] >> MAX_LENGTH_BITS
            if best_offset in offsets:
                do_compute = False
        if do_compute:
            use_prev = 1 < best_length_prev < MAX_LENGTH
            cands = offsets_new if use_prev else offsets
            best_length = best_length_prev - 1 if use_prev else 0
            best_offset = best_offset_prev if use_prev else 0
            for off in cands:
                curr = 0
                j = i
                jo = i - off
                if jo < 0 or argb[jo] != argb[i]:
                    continue
                while True:
                    cjo, cj = counts[jo], counts[j]
                    if cjo != cj:
                        curr += min(cjo, cj)
                        break
                    curr += cjo
                    jo += cjo
                    j += cjo
                    if not (curr <= MAX_LENGTH and j < n
                            and argb[jo] == argb[j]):
                        break
                if best_length < curr:
                    best_offset = off
                    if curr >= MAX_LENGTH:
                        best_length = MAX_LENGTH
                        break
                    best_length = curr
        if best_length <= MIN_LENGTH:
            chain[i] = 0
            best_offset_prev = best_length_prev = 0
        else:
            chain[i] = (best_offset << MAX_LENGTH_BITS) | best_length
            best_offset_prev, best_length_prev = best_offset, best_length
    chain[0] = 0
    return lz77_standard(px, xsize, ysize, cache_bits, chain), chain


def refs_with_cache(argb, cache_bits, refs):
    """BackwardRefsWithLocalCache."""
    cache = _Cache(cache_bits)
    out = []
    p = 0
    for v in refs:
        if v[0] == LITERAL:
            k = cache.contains(v[1])
            if k >= 0:
                out.append((CACHE, k, 1))
            else:
                cache.insert(v[1])
                out.append(v)
            p += 1
        else:
            for k in range(v[2]):
                cache.insert(argb[p + k])
            p += v[2]
            out.append(v)
    return out


def best_cache_size(argb, quality, refs, cache_bits_max) -> int:
    """CalculateBestCacheSize."""
    if quality <= 25 or cache_bits_max == 0:
        return 0
    hists = [Histogram(i) for i in range(cache_bits_max + 1)]
    caches = [None] + [[0] * (1 << i) for i in range(1, cache_bits_max + 1)]
    p = 0
    for kind, a, length in refs:
        if kind == LITERAL:
            pix = argb[p]
            p += 1
            b4 = (pix >> 24, (pix >> 16) & 255, (pix >> 8) & 255, pix & 255)
            key = _hash_pix(pix, 32 - cache_bits_max)
            for h in (hists[0],):
                h.pops[3][b4[0]] += 1
                h.pops[1][b4[1]] += 1
                h.pops[0][b4[2]] += 1
                h.pops[2][b4[3]] += 1
            for i in range(cache_bits_max, 0, -1):
                if caches[i][key] == pix:
                    hists[i].pops[0][280 + key] += 1
                else:
                    caches[i][key] = pix
                    h = hists[i]
                    h.pops[3][b4[0]] += 1
                    h.pops[1][b4[1]] += 1
                    h.pops[0][b4[2]] += 1
                    h.pops[2][b4[3]] += 1
                key >>= 1
        else:
            code = prefix_encode(length)[0]
            for h in hists:
                h.pops[0][256 + code] += 1
            prev = argb[p] ^ 0xFFFFFFFF
            for _ in range(length):
                pix = argb[p]
                if pix != prev:
                    key = _hash_pix(pix, 32 - cache_bits_max)
                    for i in range(cache_bits_max, 0, -1):
                        caches[i][key] = pix
                        key >>= 1
                    prev = pix
                p += 1
    best, best_i = None, 0
    for i, h in enumerate(hists):
        e = h.estimate_bits()
        if i == 0 or e < best:
            best, best_i = e, i
    return best_i


def _to_bit_estimates(pop):
    total = sum(pop)
    if sum(1 for x in pop if x) <= 1:
        return [0] * len(pop)
    logsum = fast_log2(total)
    return [logsum - fast_log2(x) for x in pop]


def trace_backwards(px, xsize, ysize, cache_bits, chain, refs_src):
    """VP8LBackwardReferencesTraceBackwards."""
    argb = px.a
    n = xsize * ysize
    h = histogram_of(refs_src, cache_bits, xsize)
    lit, red, blue, alpha, dist_m = (_to_bit_estimates(p) for p in h.pops)

    def literal_cost(v):
        return alpha[v >> 24] + red[(v >> 16) & 255] + lit[(v >> 8) & 255] \
            + blue[v & 255]

    def length_cost(length):
        code, extra, _ = prefix_encode(length)
        return lit[256 + code] + (extra << LOG2_BITS)

    def distance_cost(d):
        code, extra, _ = prefix_encode(d)
        return dist_m[code] + (extra << LOG2_BITS)

    cache = _Cache(cache_bits) if cache_bits else None
    int_max = (1 << 63) - 1
    costs = [int_max] * n
    dist_array = [0] * n
    cc_size = min(n, MAX_LENGTH)
    cost_cache = [length_cost(i) for i in range(cc_size)]
    cache_intervals = []  # [start, end, cost]
    for i, c in enumerate(cost_cache):
        if not cache_intervals or c != cache_intervals[-1][2]:
            cache_intervals.append([i, i + 1, c])
        else:
            cache_intervals[-1][1] = i + 1
    mgr = _CostManager(costs, dist_array)

    def add_literal(idx, prev_cost):
        color = argb[idx]
        ix = cache.contains(color) if cache is not None else -1
        if ix >= 0:
            c = prev_cost + _div_round(lit[280 + ix] * 68, 100)
        else:
            if cache is not None:
                cache.insert(color)
            c = prev_cost + _div_round(literal_cost(color) * 82, 100)
        if costs[idx] > c:
            costs[idx] = c
            dist_array[idx] = 1

    def push_interval(distance_cost_, position, length):
        if length < 10:
            for j in range(position, position + length):
                k = j - position
                c = distance_cost_ + cost_cache[k]
                if costs[j] > c:
                    costs[j] = c
                    dist_array[j] = k + 1
            return
        mgr.push(cache_intervals, distance_cost_, position, length)

    add_literal(0, 0)
    offset_prev = len_prev = -1
    offset_cost = -1
    first_offset_is_constant = -1
    reach = 0
    for i in range(1, n):
        prev_cost = costs[i - 1]
        ol = chain[i]
        offset, ln = ol >> MAX_LENGTH_BITS, ol & MAX_LENGTH
        add_literal(i, prev_cost)
        if ln >= 2:
            if offset != offset_prev:
                code = distance_to_plane_code(xsize, offset)
                offset_cost = distance_cost(code)
                first_offset_is_constant = 1
                push_interval(prev_cost + offset_cost, i, ln)
            else:
                if first_offset_is_constant:
                    reach = i - 1 + len_prev - 1
                    first_offset_is_constant = 0
                if i + ln - 1 > reach:
                    len_j = 0
                    j = i
                    while j <= reach:
                        olj = chain[j + 1]
                        if olj >> MAX_LENGTH_BITS != offset:
                            len_j = chain[j] & MAX_LENGTH
                            break
                        j += 1
                    else:
                        len_j = chain[j] & MAX_LENGTH if j < n else 0
                        len_j = olj & MAX_LENGTH if reach >= i else len_j
                    mgr.update_at(j - 1, False)
                    mgr.update_at(j, False)
                    push_interval(costs[j - 1] + offset_cost, j, len_j)
                    reach = j + len_j - 1
        mgr.update_at(i, True)
        offset_prev, len_prev = offset, ln
    # TraceBackwards and FollowChosenPath
    path = []
    cur = n - 1
    while cur >= 0:
        path.append(dist_array[cur])
        cur -= dist_array[cur]
    path.reverse()
    cache = _Cache(cache_bits) if cache_bits else None
    refs = []
    i = 0
    for length in path:
        if length != 1:
            refs.append((COPY, chain[i] >> MAX_LENGTH_BITS, length))
            if cache is not None:
                for k in range(length):
                    cache.insert(argb[i + k])
            i += length
        else:
            idx = cache.contains(argb[i]) if cache is not None else -1
            if idx >= 0:
                refs.append((CACHE, idx, 1))
            else:
                if cache is not None:
                    cache.insert(argb[i])
                refs.append((LITERAL, argb[i], 1))
            i += 1
    return refs


class _Interval:
    __slots__ = ("cost", "start", "end", "index", "prev", "next")

    def __init__(self, cost, start, end, index):
        self.cost, self.start, self.end, self.index = cost, start, end, index
        self.prev = self.next = None


class _CostManager:
    """CostManager's ordered list of intervals of constant cost."""

    def __init__(self, costs, dist_array):
        self.costs, self.dist = costs, dist_array
        self.head = None
        self.count = 0

    def _update(self, i, position, cost):
        if self.costs[i] > cost:
            self.costs[i] = cost
            self.dist[i] = i - position + 1

    def _connect(self, prev, nxt):
        if prev is not None:
            prev.next = nxt
        else:
            self.head = nxt
        if nxt is not None:
            nxt.prev = prev

    def _pop(self, iv):
        if iv is None:
            return
        self._connect(iv.prev, iv.next)
        self.count -= 1

    def _position_orphan(self, cur, prev):
        if prev is None:
            prev = self.head
        while prev is not None and cur.start < prev.start:
            prev = prev.prev
        while prev is not None and prev.next is not None and \
                prev.next.start < cur.start:
            prev = prev.next
        self._connect(cur, prev.next if prev is not None else self.head)
        self._connect(prev, cur)

    def _insert(self, hint, cost, position, start, end):
        if start >= end:
            return
        if self.count >= 500:
            for i in range(start, end):
                self._update(i, position, cost)
            return
        iv = _Interval(cost, start, end, position)
        self._position_orphan(iv, hint)
        self.count += 1

    def update_at(self, i, clean):
        cur = self.head
        while cur is not None and cur.start <= i:
            nxt = cur.next
            if cur.end <= i:
                if clean:
                    self._pop(cur)
            else:
                self._update(i, cur.index, cur.cost)
            cur = nxt

    def push(self, cache_intervals, distance_cost, position, length):
        interval = self.head
        for c_start, c_end, c_cost in cache_intervals:
            if c_start >= length:
                break
            start = position + c_start
            end = position + (length if c_end > length else c_end)
            cost = distance_cost + c_cost
            while interval is not None and interval.start < end:
                nxt = interval.next
                if start >= interval.end:
                    interval = nxt
                    continue
                if cost >= interval.cost:
                    start_new = interval.end
                    self._insert(interval, cost, position, start,
                                 interval.start)
                    start = start_new
                    if start >= end:
                        break
                    interval = nxt
                    continue
                if start <= interval.start:
                    if interval.end <= end:
                        self._pop(interval)
                    else:
                        interval.start = end
                        break
                else:
                    if end < interval.end:
                        end_original = interval.end
                        interval.end = start
                        self._insert(interval, interval.cost, interval.index,
                                     end, end_original)
                        break
                    interval.end = start
                interval = nxt
            self._insert(interval, cost, position, start, end)


def backward_refs(px, xsize, ysize, quality, lz77_types, cache_bits_max,
                  chain):
    """GetBackwardReferences without the no-cache variant: (refs with 2-D
    distance codes, cache bits)."""
    argb = px.a
    best_cost, best_type, best_refs, best_bits = None, 0, None, 0
    chain_box = None
    for lz77 in (LZ77_STANDARD, LZ77_RLE, LZ77_BOX):
        if not lz77_types & lz77:
            continue
        if lz77 == LZ77_RLE:
            refs = lz77_rle(px, xsize, ysize, 0)
        elif lz77 == LZ77_STANDARD:
            refs = lz77_standard(px, xsize, ysize, 0, chain)
        else:
            refs, chain_box = lz77_box(px, xsize, ysize, 0, chain)
        bits = best_cache_size(argb, quality, refs, cache_bits_max)
        if bits:
            refs = refs_with_cache(argb, bits, refs)
        cost = histogram_of(refs, bits).estimate_bits()
        if best_cost is None or cost < best_cost:
            best_cost, best_type, best_refs, best_bits = cost, lz77, refs, \
                bits
    if best_type in (LZ77_STANDARD, LZ77_BOX) and quality >= 25:
        c = chain if best_type == LZ77_STANDARD else chain_box
        trace = trace_backwards(px, xsize, ysize, best_bits, c, best_refs)
        if histogram_of(trace, best_bits).estimate_bits() < best_cost:
            best_refs = trace
    out = [(COPY, distance_to_plane_code(xsize, a), ln) if k == COPY
           else (k, a, ln) for k, a, ln in best_refs]
    return out, best_bits


# ------------------------------------------------------------ images

def _codes_of(histogram: Histogram):
    return [Code(p) for p in histogram.pops]


def encode_no_huffman(bw, argb, width, height, quality):
    """EncodeImageNoHuffman: one set of codes, no cache."""
    px = _Pixels(argb)
    chain = hash_chain_fill(px, width, height, quality)
    refs, _ = backward_refs(px, width, height, quality,
                            LZ77_STANDARD | LZ77_RLE, 0, chain)
    codes = _codes_of(histogram_of(refs, 0))
    bw.put(0, 1)
    for c in codes:
        store_code(bw, c)
        c.clear_if_single()
    store_image(bw, width, 0, refs, [0], [codes])


def encode_internal(bw, argb, width, height, quality, lz77_configs,
                    cache_bits_init, histo_bits):
    """EncodeImageInternal: the best of the LZ77 sub-configurations."""
    px = _Pixels(argb)
    chain = hash_chain_fill(px, width, height, quality)
    best = None
    for lz77 in lz77_configs:
        refs, cache_bits = backward_refs(px, width, height, quality, lz77,
                                         cache_bits_init, chain)
        trial = bw.clone()
        histos, symbols = histo_image_symbols(width, height, refs, quality,
                                              histo_bits, cache_bits)
        codes = [_codes_of(h) for h in histos]
        if cache_bits:
            trial.put(1, 1)
            trial.put(cache_bits, 4)
        else:
            trial.put(0, 1)
        write_image = len(histos) > 1
        trial.put(int(write_image), 1)
        bits = histo_bits
        if write_image:
            hx, hy = subsample(width, bits), subsample(height, bits)
            img = [s << 8 for s in symbols]
            img, bits = optimize_sampling(img, width, height, bits,
                                          MAX_HUFFMAN_BITS)
            trial.put(bits - 2, 3)
            encode_no_huffman(trial, img, subsample(width, bits),
                              subsample(height, bits), quality)
            symbols = [v >> 8 for v in img]
            del hx, hy
        for group in codes:
            for c in group:
                store_code(trial, c)
                c.clear_if_single()
        store_image(trial, width, bits, refs, symbols, codes)
        if best is None or trial.num_bytes() < best.num_bytes():
            best = trial
    return best


def optimize_sampling(image, width, height, bits, max_bits):
    """VP8LOptimizeSampling: the largest tile bits that hold the same
    sub-image."""
    w, h = subsample(width, bits), subsample(height, bits)
    best = bits
    while best < max_bits:
        square = 1 << (best - bits)
        new_square = 1 << (best + 1 - bits)
        good = True
        y = 0
        while y + square < h:
            if image[y * w:(y + 1) * w] != \
                    image[(y + square) * w:(y + square + 1) * w]:
                good = False
                break
            y += new_square
        if not good:
            break
        best += 1
    if best == bits:
        return image, bits
    while best > bits:
        square = 1 << (best - bits)
        good = all(image[y * w + i] == image[y * w + x]
                   for y in range(h) for x in range(0, w, square)
                   for i in range(x + 1, min(x + square, w)))
        if good:
            break
        best -= 1
    if best == bits:
        return image, bits
    square = 1 << (best - bits)
    nw, nh = subsample(width, best), subsample(height, best)
    return [image[square * (y * w + x)] for y in range(nh)
            for x in range(nw)], best


# ------------------------------------------------------------ analysis

def _histo_bits(method, use_palette, width, height):
    bits = (9 if use_palette else 7) - method
    while subsample(width, bits) * subsample(height, bits) > \
            MAX_HUFF_IMAGE_SIZE:
        bits += 1
    return min(max(bits, MIN_HUFFMAN_BITS), MAX_HUFFMAN_BITS)


def analyze_entropy(argb, width, height, palette_size, transform_bits):
    """AnalyzeEntropy over direct, spatial, the two green-subtracted
    codings and the palette."""
    if palette_size <= 16:
        return PALETTE
    histo = [[0] * 256 for _ in range(13)]
    prev_row = None
    pix_prev = argb[0]
    for y in range(height):
        row = argb[y * width:(y + 1) * width]
        for x, pix in enumerate(row):
            diff = _sub_pixels(pix, pix_prev)
            pix_prev = pix
            if diff == 0 or (prev_row is not None and pix == prev_row[x]):
                continue
            for base, p in ((0, pix), (1, diff)):
                histo[0 + base][p >> 24] += 1
                histo[4 + base][(p >> 16) & 255] += 1
                histo[2 + base][(p >> 8) & 255] += 1
                histo[6 + base][p & 255] += 1
                g = p >> 8
                histo[8 + base][((p >> 16) - g) & 255] += 1
                histo[10 + base][(p - g) & 255] += 1
            hsh = ((((pix + (pix >> 19)) * 0x39C5FBA7) & 0xFFFFFFFF) >> 24)
            histo[12][hsh] += 1
        prev_row = row
    for k in (9, 11, 5, 3, 7, 1):
        histo[k][0] += 1
    e = [bits_entropy(h) for h in histo]
    sub = subsample(width, transform_bits) * subsample(height, transform_bits)
    entropy = [e[0] + e[4] + e[2] + e[6],
               e[1] + e[5] + e[3] + e[7] + sub * fast_log2(14),
               e[0] + e[8] + e[2] + e[10],
               e[1] + e[9] + e[3] + e[11] + sub * fast_log2(24),
               e[12] + ((palette_size * 8) << LOG2_BITS)]
    best = DIRECT
    for k in range(1, 5):
        if entropy[best] > entropy[k]:
            best = k
    return best


def _minimize_deltas(palette):
    """PaletteSortMinimizeDeltas (only where the sorted deltas are not
    monotonous)."""
    predict = 0
    found = 0
    for c in palette:
        d = _sub_pixels(c, predict)
        for s, lo in ((16, 1), (8, 8), (0, 64)):
            v = (d >> s) & 255
            if v:
                found |= lo if v < 0x80 else lo << 1
        predict = c
    if not found & (found << 1):
        return list(palette)
    out = list(palette)
    predict = 0

    def comp(v):
        return v if v <= 128 else 256 - v
    for i in range(len(out)):
        best_ix, best_score = i, None
        for k in range(i, len(out)):
            d = _sub_pixels(out[k], predict)
            score = 9 * (comp(d & 255) + comp((d >> 8) & 255)
                         + comp((d >> 16) & 255)) + comp(d >> 24)
            if best_score is None or best_score > score:
                best_score, best_ix = score, k
        out[best_ix], out[i] = out[i], out[best_ix]
        predict = out[i]
    return out


def _bundle(indices, width, height, xbits):
    """The palette indices packed 1 << xbits to a pixel (green), alpha
    0xff."""
    if xbits == 0:
        return [ARGB_BLACK | (i << 8) for i in indices]
    depth = 1 << (3 - xbits)
    mask = (1 << xbits) - 1
    out = []
    for y in range(height):
        row = indices[y * width:(y + 1) * width]
        packed = [ARGB_BLACK] * subsample(width, xbits)
        for x, v in enumerate(row):
            packed[x >> xbits] |= v << (8 + depth * (x & mask))
        out += packed
    return out


def _avg2(a, b):
    return (a + b) >> 1


def _predictions(px):
    """The 14 predictors of every pixel with a left and a top neighbour
    ((H, W, 4) channels A, R, G, B as int64; rows and columns 0 are
    replaced by the caller): (14, H - 1, W - 1, 4)."""
    h, w, _ = px.shape
    flat = px.reshape(-1, 4)
    idx = (np.arange(h - 1)[:, None] * w + np.arange(1, w)[None, :] + 1)
    L, T, TL = px[1:, :-1], px[:-1, 1:], px[:-1, :-1]
    TR = flat[idx]  # the pixel right of T, wrapping to the next row
    black = np.zeros_like(L)
    black[..., 0] = 255
    sel = (np.abs(L - TL).sum(-1) - np.abs(T - TL).sum(-1) <= 0)[..., None]
    avg_lt = _avg2(L, T)
    half = avg_lt - TL
    return np.stack([
        black, L, T, TR, TL, _avg2(_avg2(L, TR), T), _avg2(L, TL), avg_lt,
        _avg2(TL, T), _avg2(T, TR), _avg2(_avg2(L, TL), _avg2(T, TR)),
        np.where(sel, T, L), np.clip(L + T - TL, 0, 255),
        np.clip(avg_lt + np.where(half < 0, -((-half) // 2), half // 2), 0,
                255)])


def _mode_residuals(argb, width, height):
    """GetResidual of every pixel under each of the 14 predictors (the
    first row from the left, its first pixel from black, the first column
    from above): (14, H, W, 4) channels A, R, G, B."""
    a = np.asarray(argb, np.int64).reshape(height, width)
    px = np.stack([(a >> s) & 255 for s in (24, 16, 8, 0)], -1)
    pred = np.empty((14, height, width, 4), np.int64)
    pred[:, 0, 0] = (255, 0, 0, 0)
    pred[:, 0, 1:] = px[0, :-1]
    pred[:, 1:, 0] = px[:-1, 0]
    if height > 1 and width > 1:
        pred[:, 1:, 1:] = _predictions(px)
    return (px[None] - pred) & 255


def _prediction_cost_bias(counts) -> int:
    bits = counts[0] << LOG2_BITS
    exp_val = 94 << LOG2_BITS
    for i in range(1, 16):
        bits += _div_round(exp_val * (counts[i] + counts[256 - i]), 100)
        exp_val = _div_round(6 * exp_val, 10)
    return -_div_round(bits, 10)


def _combined_shannon(x, y) -> int:
    ret = 0
    sx = sxy = 0
    for a, b in zip(x, y):
        if a:
            xy = a + b
            sx += a
            ret += fast_slog2(a)
            sxy += xy
            ret += fast_slog2(xy)
        elif b:
            sxy += b
            ret += fast_slog2(b)
    return fast_slog2(sx) + fast_slog2(sxy) - ret


def residual_image(argb, width, height, bits):
    """VP8LResidualImage at one tile size: the predictor per tile and the
    residuals; returns (modes image, bits after OptimizeSampling,
    residual pixels)."""
    res = _mode_residuals(argb, width, height)
    tpr, tpc = subsample(width, bits), subsample(height, bits)
    accumulated = [[0] * 256 for _ in range(4)]
    modes = [0] * (tpr * tpc)
    bias = 15 << LOG2_BITS
    for ty in range(tpc):
        for tx in range(tpr):
            y0, x0 = ty << bits, tx << bits
            tile = res[:, y0:y0 + (1 << bits), x0:x0 + (1 << bits)]
            left = modes[ty * tpr + tx - 1] if tx > 0 else 0xFF
            above = modes[(ty - 1) * tpr + tx] if ty > 0 else 0xFF
            best_cost, best_mode, best_h = None, 0, None
            for mode in range(14):
                t = tile[mode].reshape(-1, 4)
                h = [np.bincount(t[:, c], minlength=256).tolist()
                     for c in range(4)]
                cost = sum(_prediction_cost_bias(h[i])
                           + _combined_shannon(h[i], accumulated[i])
                           for i in range(4))
                if mode == left:
                    cost -= bias
                if mode == above:
                    cost -= bias
                if best_cost is None or cost < best_cost:
                    best_cost, best_mode, best_h = cost, mode, h
            for i in range(4):
                accumulated[i] = [a + b for a, b in zip(accumulated[i],
                                                        best_h[i])]
            modes[ty * tpr + tx] = best_mode
    image = [ARGB_BLACK | (m << 8) for m in modes]
    image, bits = optimize_sampling(image, width, height, bits,
                                    MAX_TRANSFORM_BITS)
    tpr = subsample(width, bits)
    mode_of = np.asarray([(v >> 8) & 255 for v in image], np.int64)
    ys, xs = np.mgrid[0:height, 0:width]
    m = mode_of[(ys >> bits) * tpr + (xs >> bits)]
    r = np.take_along_axis(res, m[None, :, :, None], 0)[0]
    out = (r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) | r[..., 3]
    return image, bits, out.reshape(-1).tolist()


def _clamp_bits(width, height, bits, min_bits, max_bits, size_max):
    bits = min(max(bits, min_bits), max_bits)
    size = subsample(width, bits) * subsample(height, bits)
    while bits < max_bits and size > size_max:
        bits += 1
        size = subsample(width, bits) * subsample(height, bits)
    while bits > min_bits and size == 1:
        size = subsample(width, bits - 1) * subsample(height, bits - 1)
        if size != 1:
            break
        bits -= 1
    return bits


def encode_alpha_stream(alpha: np.ndarray) -> bytes:
    """(H, W) u8 (already filtered) -> the header-less VP8L stream of
    EncodeAlpha's lossless call."""
    height, width = alpha.shape
    method, quality = 4, 32
    argb = [int(v) << 8 for v in np.asarray(alpha, np.int64).reshape(-1)]
    palette = sorted(set(argb))
    use_palette = len(palette) <= MAX_PALETTE_SIZE
    histo_bits = _histo_bits(method, use_palette, width, height)
    transform_bits = min(histo_bits, 5)
    entropy_ix = analyze_entropy(argb, width, height, len(palette),
                                 transform_bits)
    bw = BitWriter()
    cache_bits_init = MAX_COLOR_CACHE_BITS
    lz77 = [LZ77_STANDARD | LZ77_RLE]
    cur_width = width
    if entropy_ix == PALETTE:
        pal = _minimize_deltas(palette)
        n = len(pal)
        if n <= 16:
            lz77.append(LZ77_BOX)
        index = {c: i for i, c in enumerate(pal)}
        xbits = (3 if n <= 2 else 2) if n <= 4 else (1 if n <= 16 else 0)
        image = _bundle([index[c] for c in argb], width, height, xbits)
        cur_width = subsample(width, xbits)
        if n < 1 << MAX_COLOR_CACHE_BITS:
            cache_bits_init = n.bit_length()
        n_enc = n - 1 if pal[-1] == 0 and n > 17 else n
        bw.put(1, 1)
        bw.put(3, 2)
        bw.put(n_enc - 1, 8)
        deltas = [pal[0]] + [_sub_pixels(pal[i], pal[i - 1])
                             for i in range(1, n_enc)]
        encode_no_huffman(bw, deltas, n_enc, 1, 20)
        argb = image
    elif entropy_ix == SPATIAL:
        bits = _clamp_bits(width, height, transform_bits, MIN_TRANSFORM_BITS,
                           MAX_TRANSFORM_BITS, 1 << 14)
        modes, bits, argb = residual_image(argb, width, height, bits)
        bw.put(1, 1)
        bw.put(0, 2)
        bw.put(bits - MIN_TRANSFORM_BITS, 3)
        encode_no_huffman(bw, modes, subsample(width, bits),
                          subsample(height, bits), quality)
    elif entropy_ix != DIRECT:
        raise ValueError("green-subtracting VP8L codings of an alpha plane "
                         "are not ported")
    bw.put(0, 1)  # no more transforms
    out = encode_internal(bw, argb, cur_width, height, quality, lz77,
                          cache_bits_init, histo_bits)
    return out.finish()
