"""PIL's adaptive palette without PIL: ``Image.convert("P",
palette=ADAPTIVE)`` at 256 colours, bit for bit (palette and indices), as
Pillow 12.1's libImaging/Quantize.c, QuantHash.c, QuantHeap.c and
QuantOctree.c compute it: median cut for RGB, fast octree for RGBA.

Median cut (``median_cut``):
  - the colours go into PIL's hash table (keyed by a hash of the colour,
    which is one-to-one on 24 bits); while it holds more than 65536
    entries, every colour is shifted right one more bit (the scale). The
    table's length follows its growth and shrink rule (QuantHash.c, whose
    prime search takes the first length with low four bits 1, 3, 7, 9, 11
    or 13, as the C code does), and its entries are listed bucket by
    bucket, each bucket in hash order;
  - three lists of the entries, sorted by red, green and blue in
    descending order (PIL's merge sort keeps the listing's order among
    equal values);
  - boxes split by a max-heap on pixel count (QuantHeap.c's sift rules);
    a box of one colour leaves the heap; a split takes the axis of the
    largest weighted range (77 red, 150 green, 29 blue), walks the sorted
    list until more than half the box's pixels are on the first side,
    takes the rest of that value along, and moves the last value back if
    nothing is left for the second side; at most 255 splits;
  - palette entry k is the k-th non-empty leaf, depth first, and its
    colour the mean of its pixels rounded half up;
  - each colour maps to its box's entry unless another entry is nearer:
    the entries are searched in order of their distance to the box's
    entry (ties by index), up to four times the colour's distance to it,
    the first strictly nearer one winning.

Fast octree (``fast_octree``, with alpha): transparent pixels take the
first transparent pixel's colour; a fine cube of 3/4/3/3 bits (R/G/B/A)
counts the pixels and sums their channels; a coarse cube of 2 bits a
channel sums the fine one; the fine buckets sorted by count (ties by
bucket order) give the palette's fine part, whose counts are taken out of
the coarse buckets their mean colours fall in, until the number of
non-empty coarse buckets settles; the coarse buckets so left, sorted the
same way, come first in the palette. Means truncate single-precision
quotients. Pixels look their colour up in a fine cube filled from the
coarse entries and then the fine ones, each written from the last entry
to the first; the palette always has 256 RGBA entries.
"""

from __future__ import annotations

import math

import numpy as np

MAX_HASH_ENTRIES = 65536
COLORS = 256  # convert("P", palette=ADAPTIVE) asks for 256


def _pixel_hash(rgb: np.ndarray) -> np.ndarray:
    """QuantHash's PIXEL_HASH of (n, 3) colours, as uint32."""
    r, g, b = (rgb[:, i].astype(np.uint64) for i in range(3))
    return (((r * np.uint64(463)) ^ ((g << np.uint64(8)) * np.uint64(10069))
             ^ ((b << np.uint64(16)) * np.uint64(64997)))
            & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _key(rgb: np.ndarray) -> np.ndarray:
    return (rgb[:, 0].astype(np.int64) << 16) | (rgb[:, 1].astype(np.int64)
                                                  << 8) | rgb[:, 2]


def _find_prime(start: int, step: int) -> int:
    """QuantHash.c's _findPrime: its divisor test never fires, so it
    returns the first number from `start` on whose low four bits are 1,
    3, 7, 9, 11 or 13."""
    while start > 1 and (start & 15) not in (1, 3, 7, 9, 11, 13):
        start += step
    return start


def _resize(length: int, count: int) -> int:
    """_hashtable_resize after an insert brings the count to `count`."""
    new = length
    if count * 3 < length:
        new = _find_prime(length // 2 - 1, -1)
    elif length * 3 < count:
        new = _find_prime(length * 2 + 1, 1)
    return length if new < 11 else new


def _hash_table(px: np.ndarray) -> tuple[int, int]:
    """create_pixel_hash: the final scale and table length. The pixels go
    in in order; each new entry may resize the table; after an insert
    that leaves more than 65536 entries the scale grows (the table
    rehashed at its length, merging entries) until at most 65536 are
    left."""
    scale, length, at = 0, 11, 0
    while True:
        _, first = np.unique(_key(px >> scale), return_index=True)
        first.sort()
        count = int(np.searchsorted(first, at))  # entries from px[:at]
        if count > MAX_HASH_ENTRIES:
            scale += 1
            continue
        for c in range(count + 1, min(len(first), MAX_HASH_ENTRIES + 1) + 1):
            length = _resize(length, c)
        if len(first) <= MAX_HASH_ENTRIES:
            return scale, length
        at = int(first[MAX_HASH_ENTRIES]) + 1
        scale += 1


def _heap_add(heap: list, node) -> None:
    """ImagingQuantHeapAdd (max-heap on pixel count, 1-based)."""
    heap.append(None)
    k = len(heap) - 1
    while k != 1 and node["count"] - heap[k // 2]["count"] > 0:
        heap[k] = heap[k // 2]
        k //= 2
    heap[k] = node


def _heap_remove(heap: list):
    """ImagingQuantHeapRemove."""
    top = heap[1]
    v = heap.pop()
    n = len(heap) - 1
    if n == 0:
        return top
    k = 1
    while k * 2 <= n:
        j = k * 2
        if j < n and heap[j]["count"] - heap[j + 1]["count"] < 0:
            j += 1
        if v["count"] - heap[j]["count"] > 0:
            break
        heap[k] = heap[j]
        k = j
    heap[k] = v
    return top


def _volume(node, vals) -> int:
    if node["volume"] < 0:
        lists = node["lists"]
        node["volume"] = math.prod(
            int(vals[lists[c][0], c]) - int(vals[lists[c][-1], c]) + 1
            for c in range(3))
    return node["volume"]


def _split(node, vals, counts) -> None:
    """split and splitlists."""
    lists = node["lists"]
    f = [(int(vals[lists[c][0], c]) - int(vals[lists[c][-1], c])) * w
         for c, w in enumerate((77, 150, 29))]
    axis = 0
    for i in (1, 2):
        if f[axis] < f[i]:
            axis = i
    order = lists[axis]
    v = vals[order, axis]
    cum = np.cumsum(counts[order])
    n_left = int(np.argmax(cum * 2 > node["count"])) + 1 \
        if (cum * 2 > node["count"]).any() else len(order)
    if n_left < len(order):  # take the rest of the last value along
        n_left += int(np.searchsorted(-v[n_left:], -v[n_left - 1],
                                      side="right"))
    if n_left == len(order):  # nothing right: move the last value back
        n_left -= int((v == v[-1]).sum())
    right = np.zeros(len(vals), bool)
    right[order[n_left:]] = True
    kids = []
    for side in (False, True):
        sub = [lst[right[lst] == side] for lst in lists]
        kids.append(dict(lists=sub, count=int(counts[sub[0]].sum()),
                         volume=-1, kids=None))
    node["kids"] = kids


def median_cut(image: np.ndarray):
    """(H, W, 3) u8 -> ((H, W) u8 indices, (n, 3) u8 palette), as PIL's
    quantize(256, method=MEDIANCUT)."""
    px = np.asarray(image).reshape(-1, 3)
    scale, length = _hash_table(px)
    scaled = px >> scale
    ukeys, inverse, counts = np.unique(_key(scaled), return_inverse=True,
                                       return_counts=True)
    vals = np.stack([ukeys >> 16, (ukeys >> 8) & 255, ukeys & 255], -1)
    h = _pixel_hash(vals)
    listing = np.lexsort((h, h % length))
    lists = [listing[np.argsort(-vals[listing, c], kind="stable")]
             for c in range(3)]
    root = dict(lists=lists, count=len(px), volume=-1, kids=None)
    heap = [None]
    _heap_add(heap, root)
    for _ in range(COLORS - 1):
        node = None
        while len(heap) > 1:  # boxes of one colour leave the heap
            node = _heap_remove(heap)
            if _volume(node, vals) != 1:
                break
            node = None
        if node is None:
            break
        _split(node, vals, counts)
        _heap_add(heap, node["kids"][0])
        _heap_add(heap, node["kids"][1])
    box = np.zeros(len(vals), np.int64)
    leaves = []
    stack = [root]
    while stack:  # depth first, first child first
        node = stack.pop()
        if node["kids"] is not None:
            stack += node["kids"][::-1]
        elif len(node["lists"][0]):
            box[node["lists"][0]] = len(leaves)
            leaves.append(node)
    n = len(leaves)
    pix_box = box[inverse]
    sums = np.zeros((n, 3), np.int64)
    for c in range(3):
        sums[:, c] = np.bincount(pix_box, px[:, c].astype(np.int64), n)
    num = np.bincount(pix_box, minlength=n).astype(np.float64)
    palette = np.trunc(0.5 + sums / num[:, None]).astype(np.int64)
    return _map_median(px, palette, pix_box), palette.astype(np.uint8)


def _map_median(px: np.ndarray, palette: np.ndarray,
                pix_box: np.ndarray) -> np.ndarray:
    """map_image_pixels_from_median_box, over the distinct colours."""
    n = len(palette)
    big = np.iinfo(np.int32).max
    avg = ((palette[:, None, :] - palette[None, :, :]) ** 2).sum(-1).astype(
        np.int32)
    rank = np.empty((n, n), np.int32)  # position in the stable sort
    order = np.argsort(avg, axis=1, kind="stable")
    rank[np.arange(n)[:, None], order] = np.arange(n)[None, :]
    colours, first, inverse = np.unique(_key(px), return_index=True,
                                        return_inverse=True)
    own = pix_box[first]
    rgb = px[first].astype(np.float64)
    pal = palette.astype(np.float64)
    pal_sq = (pal ** 2).sum(-1)
    out = np.empty(len(colours), np.int64)
    for s in range(0, len(colours), 4096):
        c, o = rgb[s:s + 4096], own[s:s + 4096]
        # squared distances, exact in double: |c|^2 + |p|^2 - 2 c.p
        d = ((c ** 2).sum(-1)[:, None] + pal_sq[None, :]
             - 2.0 * (c @ pal.T)).astype(np.int32)
        d0 = d[np.arange(len(c)), o]
        d = np.where(avg[o] <= (d0 << 2)[:, None], d, big)  # candidates
        dm = d.min(axis=1)
        best = np.where(d == dm[:, None], rank[o], big).argmin(axis=1)
        out[s:s + 4096] = np.where(d0 == dm, o, best)
    return out[inverse.reshape(-1)]


def _mean(count: np.ndarray, sums: np.ndarray) -> np.ndarray:
    """avg_color_from_color_bucket: single-precision quotients, truncated
    (0 for an empty bucket)."""
    c = count.astype(np.float32)[:, None]
    with np.errstate(invalid="ignore", divide="ignore"):
        q = sums.astype(np.float32) / c
    return np.where(c != 0, np.clip(np.trunc(np.nan_to_num(q)), 0, 255),
                    0).astype(np.int64)


class _Cube:
    def __init__(self, bits: tuple[int, ...]):
        self.bits = bits
        self.count = np.zeros(1 << sum(bits), np.int64)
        self.sums = np.zeros((1 << sum(bits), 4), np.int64)

    def offset(self, rgba: np.ndarray) -> np.ndarray:
        off = np.zeros(len(rgba), np.int64)
        for c, b in enumerate(self.bits):
            off = (off << b) | (rgba[:, c].astype(np.int64) >> (8 - b))
        return off

    def cells(self) -> np.ndarray:
        """(size, 4) channel cell numbers of each bucket."""
        idx = np.arange(len(self.count))
        out = np.empty((len(idx), 4), np.int64)
        shift = 0
        for c in (3, 2, 1, 0):
            out[:, c] = (idx >> shift) & ((1 << self.bits[c]) - 1)
            shift += self.bits[c]
        return out


FINE_BITS, COARSE_BITS = (3, 4, 3, 3), (2, 2, 2, 2)


def fast_octree(image: np.ndarray):
    """(H, W, 4) u8 -> ((H, W) u8 indices, (256, 4) u8 RGBA palette), as
    PIL's quantize(256, method=FASTOCTREE)."""
    px = np.asarray(image).reshape(-1, 4).astype(np.int64)
    clear = np.flatnonzero(px[:, 3] == 0)
    if len(clear):
        px[clear, :3] = px[clear[0], :3]
    fine = _Cube(FINE_BITS)
    off = fine.offset(px)
    fine.count = np.bincount(off, minlength=len(fine.count))
    for c in range(4):
        fine.sums[:, c] = np.bincount(off, px[:, c], len(fine.count))
    coarse = _Cube(COARSE_BITS)
    cells = fine.cells()
    to_coarse = np.zeros(len(fine.count), np.int64)
    for c in range(4):
        to_coarse = (to_coarse << COARSE_BITS[c]) | (
            cells[:, c] >> (FINE_BITS[c] - COARSE_BITS[c]))
    coarse.count = np.bincount(to_coarse, fine.count, len(coarse.count)
                               ).astype(np.int64)
    for c in range(4):
        coarse.sums[:, c] = np.bincount(to_coarse, fine.sums[:, c],
                                        len(coarse.count)).astype(np.int64)
    n_coarse = min(int((coarse.count > 0).sum()), COLORS)
    n_fine = COLORS - n_coarse
    order = np.argsort(-fine.count, kind="stable")
    f_count, f_sums = fine.count[order], fine.sums[order]
    f_mean = _mean(f_count, f_sums)

    def subtract(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            if f_count[i] == 0:
                continue
            k = coarse.offset(f_mean[i:i + 1])[0]
            coarse.count[k] -= f_count[i]
            coarse.sums[k] -= f_sums[i]

    subtract(0, n_fine)
    while n_coarse > int((coarse.count > 0).sum()):
        done = n_fine
        n_coarse = int((coarse.count > 0).sum())
        n_fine = COLORS - n_coarse
        subtract(done, n_fine)
    c_order = np.argsort(-coarse.count, kind="stable")
    p_count = np.concatenate([coarse.count[c_order][:n_coarse],
                              f_count[:n_fine]])
    p_sums = np.concatenate([coarse.sums[c_order][:n_coarse],
                             f_sums[:n_fine]])
    palette = _mean(p_count, p_sums)
    coarse_lookup = np.zeros(len(coarse.count), np.int64)
    for i in range(n_coarse - 1, -1, -1):
        coarse_lookup[coarse.offset(palette[i:i + 1])[0]] = i
    lookup = coarse_lookup[to_coarse]
    for i in range(n_coarse + n_fine - 1, n_coarse - 1, -1):
        lookup[fine.offset(palette[i:i + 1])[0]] = i
    return lookup[off].astype(np.uint8), palette.astype(np.uint8)
