"""Triangle rasterization: setup, binning, G-buffer and depth-only raster.

Port of plainrenderer_tpu/ops/raster.py: the main view and the sun-shadow
atlas, opaque and alpha-tested. The stages keep the reference's contracts
(the (3, 4|8, T) edge table, the (16|32, P) / (32, P) pair-row tables,
the packed int32 sort key, the packed depth | slot winner rule, the vis
encoding, the 13-channel G-buffer layout, 15 with a dynamic scene's
previous-frame NDC):

  1. geometry_setup (plain PyTorch): per-triangle 2D-homogeneous edge
     planes, reverse-Z depth plane, perspective-correct attribute planes
     and tile bboxes, as (T,) lane vectors in the JAX package's op order
     (or (B, T) for a batch of view matrices: the shadow cascades); with
     alpha slots, 4 more planes (u/w, v/w, 1/w, the mask slot); with a
     dynamic scene's previous corners, 9 more attribute rows (the
     previous-frame clip x, y, w planes);
  2. build_pairs: spans + int32 prefix sum, then kernel A (expand_keys,
     csrc/expand_keys.cu) maps every pair-stream slot to its sort key, one
     torch.sort orders the stream, torch.searchsorted finds each bin's
     segment; gather_pair_setups duplicates setup rows into pair order (or,
     with carry_table, kernel M expands them before the sort,
     csrc/expand_rows.cu). A vertical atlas of n_views views keys each pair
     by its view-local triangle;
  3. rasterize_gbuffer: kernel B (csrc/gbuffer.cu), warps over 16-row
     strips of each bin that skip the 16 x 16 blocks a pair cannot cover
     (block_may_cover), resolves visibility and evaluates the winner's
     attribute planes; alpha-tested pairs go through kernels K and L
     (csrc/gbuffer_alpha.cu); rasterize_depth: kernel E (csrc/depth.cu,
     the same strips), the depth-only clamped max of the shadow atlas,
     and kernel J (csrc/depth_alpha.cu) for alpha-tested casters.

Each kernel wrapper runs its plain PyTorch version (*_plain, in this
module) only when its inputs lie on the CPU; for CUDA tensors it launches
the kernel or raises. chip_smoke.py holds every kernel to its plain version
on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native

TILE_H = 16
TILE_W = 128
PX_PER_TILE = TILE_H * TILE_W  # 2048
GROUP = 128  # segment alignment unit: vis slots count from start // GROUP
SLOT_BITS = 11  # pair-slot bits packed into the depth mantissa
SLOT_MASK = (1 << SLOT_BITS) - 1
MAX_PAIRS_PER_TILE = 1 << SLOT_BITS
NATTR = 30  # attribute-plane rows per triangle (10 planes x 3 coeffs)
NATTR_PREV = NATTR + 9  # + previous-frame clip planes (dynamic scenes)

# G-buffer channels: uv 0-1, uv screen derivatives 2-5, normal 6-8,
# tangent 9-11, packed material * 2 + (handedness < 0) 12; dynamic scenes
# (NATTR_PREV attribute rows) add the previous-frame NDC xy 13-14
GBUF_CHANNELS = 13
_CH_U = 0  # 0-1 uv
_CH_DUDX = 2  # 2-5 dudx, dvdx, dudy, dvdy
_CH_N = 6  # 6-8 normal
_CH_T = 9  # 9-11 tangent
_CH_MAT = 12  # packed material * 2 + (handedness < 0)
_CH_PREV = 13  # 13-14 previous-frame NDC xy (dynamic scenes)


def pad_resolution(width: int, height: int) -> tuple[int, int]:
    """Framebuffer padded so tiles divide it exactly."""
    w = (width + TILE_W - 1) // TILE_W * TILE_W
    h = (height + TILE_H - 1) // TILE_H * TILE_H
    return w, h


@dataclasses.dataclass
class TriangleSetup:
    """Per-triangle raster state (all dense, (T,)-leading)."""

    edges: torch.Tensor  # (3, 4, T) f32: [coeff a/b/c][plane e0 e1 e2 z][tri]
    attrs: torch.Tensor  # (NATTR, T) f32 attr-plane rows
    tile_bbox: torch.Tensor  # (T, 4) i32: ty0, tx0, ty1, tx1 (inclusive)
    valid: torch.Tensor  # (T,) bool
    fine_y: torch.Tensor  # (T, 2) i32 fine (16px) row bbox; (1, 0) invalid


@dataclasses.dataclass
class PairLists:
    """Sorted (bin, triangle) pair stream + per-bin ranges."""

    pair_tri: torch.Tensor  # (P,) i32 triangle per pair (T == dummy)
    tile_start: torch.Tensor  # (n_tiles,) i32 raw offset into the stream
    tile_count: torch.Tensor  # (n_tiles,) i32 pairs per bin (capped)
    overflow: torch.Tensor  # () i32 dropped pairs


def _kernel_device(t: torch.Tensor) -> bool:
    """True when a wrapper must launch its kernel (CUDA tensor), False for
    the plain version (CPU tensor); raises on any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} with {ndim} dims on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


# --------------------------------------------------------------------------
# geometry stage
# --------------------------------------------------------------------------

def geometry_setup(corners, corner_uvs, corner_normals, corner_tangents,
                   corner_bitangents, tri_material, tri_visible, view_proj,
                   width: int, height: int, cull: str = "back",
                   near_w: float = 0.0, bin_rows: int = 1,
                   with_attrs: bool = True, tri_alpha_slot=None,
                   prev_view_proj=None, prev_corners=None) -> TriangleSetup:
    """Dense per-triangle setup (raster.py:104 geometry_setup).

    Edge and attribute planes are built in 2D homogeneous viewport space
    (cross products of (X, Y, W) vertex rows, never dividing by w), so
    near-plane-crossing triangles rasterize their visible region exactly;
    the bbox covers the vertices in front of the near plane plus the
    edge/near-plane intersections. Every expression keeps the JAX
    package's operand order.

    view_proj (B, 4, 4) with tri_visible (B, T) sets up B views at once
    (the shadow cascades, with_attrs=False): every per-triangle field
    gains a leading B, and edges come out (3, 4, B, T), so flattening the
    views into one atlas stream is a free reshape (frame.py:189-204).
    with_attrs=False leaves attrs empty (the depth-only passes).
    tri_alpha_slot (T,) i32 (0 = opaque) turns on the 8-plane alpha-test
    table (raster.py:225-245): planes 4-7 are u/w, v/w, 1/w and the mask
    slot as a constant plane (0, 0, slot), each zeroed where the triangle
    is invalid, so the atlas's c - b * y_off shift leaves the slot alone.
    prev_corners (T, 3, 3), a dynamic scene's previous-frame world corners,
    with prev_view_proj (4, 4) adds attribute rows 30-38: the planes of
    the previous-frame clip x, y and w of prev_view_proj @ prev_corners
    (raster.py:361-380)."""
    if view_proj.dim() == 3 and with_attrs:
        raise ValueError("a batch of views is set up without attributes")
    cx = [corners[:, v, 0] for v in range(3)]
    cy = [corners[:, v, 1] for v in range(3)]
    cz = [corners[:, v, 2] for v in range(3)]
    # (..., 4, 4, 1): an entry broadcasts over the triangle axis
    m = view_proj.unsqueeze(-1)

    def project(v):
        def row(r):
            return (m[..., r, 0, :] * cx[v] + m[..., r, 1, :] * cy[v]
                    + m[..., r, 2, :] * cz[v] + m[..., r, 3, :])

        xc, yc, zc, wc = row(0), row(1), row(2), row(3)
        return ((xc * 0.5 + 0.5 * wc) * width,  # Vulkan y-down == screen
                (yc * 0.5 + 0.5 * wc) * height, zc, wc)

    proj = [project(v) for v in range(3)]
    sx_h = [p[0] for p in proj]
    sy_h = [p[1] for p in proj]
    z_h = [p[2] for p in proj]
    w = [p[3] for p in proj]

    def cross3(i, j):
        a = sy_h[i] * w[j] - sy_h[j] * w[i]
        b = w[i] * sx_h[j] - sx_h[i] * w[j]
        c = sx_h[i] * sy_h[j] - sy_h[i] * sx_h[j]
        return a, b, c

    e0 = cross3(1, 2)
    e1 = cross3(2, 0)
    e2 = cross3(0, 1)
    # det = 2 * signed screen area * w0*w1*w2: the clip-space facing test
    det = e0[0] * sx_h[0] + e0[1] * sy_h[0] + e0[2] * w[0]

    if cull == "back":
        face_ok = det > 0
    elif cull == "front":
        face_ok = det < 0
    else:
        face_ok = torch.abs(det) > 0

    near_lim = max(near_w, 1e-9)
    any_front = ((w[0] >= near_lim) | (w[1] >= near_lim)
                 | (w[2] >= near_lim))
    valid = face_ok & tri_visible & any_front & (torch.abs(det) > 1e-12)

    # orient edges so inside == all(E >= 0) for either winding
    flip = torch.where(det < 0, -1.0, 1.0)
    inv_absdet = 1.0 / torch.where(valid, torch.abs(det), 1.0)
    e0 = tuple(c * flip for c in e0)
    e1 = tuple(c * flip for c in e1)
    e2 = tuple(c * flip for c in e2)

    def plane(q0, q1, q2):
        """Screen-affine plane of q/w from raw per-vertex q."""
        qa = (q0 * e0[0] + q1 * e1[0] + q2 * e2[0]) * inv_absdet
        qb = (q0 * e0[1] + q1 * e1[1] + q2 * e2[1]) * inv_absdet
        qc = (q0 * e0[2] + q1 * e1[2] + q2 * e2[2]) * inv_absdet
        return qa, qb, qc

    zp = plane(z_h[0], z_h[1], z_h[2])
    never = (0.0, 0.0, -1.0)
    e0 = tuple(torch.where(valid, c, n) for c, n in zip(e0, never))
    e1 = tuple(torch.where(valid, c, n) for c, n in zip(e1, never))
    e2 = tuple(torch.where(valid, c, n) for c, n in zip(e2, never))
    zp = tuple(torch.where(valid, c, 0.0) for c in zp)
    plane_sets = [e0, e1, e2, zp]
    if tri_alpha_slot is not None:
        def guarded(p):
            return tuple(torch.where(valid, c, 0.0) for c in p)

        ones = torch.ones_like(det)
        zero = torch.zeros_like(det)
        plane_sets.append(guarded(plane(
            corner_uvs[:, 0, 0], corner_uvs[:, 1, 0], corner_uvs[:, 2, 0])))
        plane_sets.append(guarded(plane(
            corner_uvs[:, 0, 1], corner_uvs[:, 1, 1], corner_uvs[:, 2, 1])))
        plane_sets.append(guarded(plane(ones, ones, ones)))
        slot_f = tri_alpha_slot.to(torch.float32)
        plane_sets.append((zero, zero, torch.where(valid, slot_f, 0.0)))
    edges = torch.stack(
        [torch.stack([p[coeff] for p in plane_sets], dim=0)
         for coeff in range(3)], dim=0).to(torch.float32)

    bin_h = TILE_H * bin_rows
    ntx = width // TILE_W
    nty = height // bin_h
    if near_w <= 0.0:
        wd = [torch.clamp_min(wv, 1e-9) for wv in w]
        xs = [sx_h[v] / wd[v] for v in range(3)]
        ys = [sy_h[v] / wd[v] for v in range(3)]
        xmin = torch.minimum(torch.minimum(xs[0], xs[1]), xs[2])
        xmax = torch.maximum(torch.maximum(xs[0], xs[1]), xs[2])
        ymin = torch.minimum(torch.minimum(ys[0], ys[1]), ys[2])
        ymax = torch.maximum(torch.maximum(ys[0], ys[1]), ys[2])
    else:
        big = 1e9
        xmin = torch.full_like(det, big)
        xmax = torch.full_like(det, -big)
        ymin = torch.full_like(det, big)
        ymax = torch.full_like(det, -big)

        def fold(ok, px, py):
            nonlocal xmin, xmax, ymin, ymax
            xmin = torch.minimum(xmin, torch.where(ok, px, big))
            xmax = torch.maximum(xmax, torch.where(ok, px, -big))
            ymin = torch.minimum(ymin, torch.where(ok, py, big))
            ymax = torch.maximum(ymax, torch.where(ok, py, -big))

        for v in range(3):
            wd = torch.clamp_min(w[v], near_lim)
            fold(w[v] >= near_lim, sx_h[v] / wd, sy_h[v] / wd)
        inv_near = 1.0 / near_lim
        for i, j in ((0, 1), (1, 2), (2, 0)):
            denom = w[j] - w[i]
            t = (near_lim - w[i]) / torch.where(
                torch.abs(denom) > 1e-12, denom, 1.0)
            crossing = (((w[i] - near_lim) * (w[j] - near_lim) < 0.0)
                        & (torch.abs(denom) > 1e-12))
            fold(crossing,
                 (sx_h[i] + t * (sx_h[j] - sx_h[i])) * inv_near,
                 (sy_h[i] + t * (sy_h[j] - sy_h[i])) * inv_near)

    def to_cell(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)

    tx0, tx1 = to_cell(xmin, TILE_W, ntx), to_cell(xmax, TILE_W, ntx)
    ty0, ty1 = to_cell(ymin, bin_h, nty), to_cell(ymax, bin_h, nty)
    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    valid = valid & ~offscreen
    tile_bbox = torch.stack([
        torch.where(valid, ty0, 1), torch.where(valid, tx0, 1),
        torch.where(valid, ty1, 0), torch.where(valid, tx1, 0)], dim=-1)
    n_fy = height // TILE_H
    fy0, fy1 = to_cell(ymin, TILE_H, n_fy), to_cell(ymax, TILE_H, n_fy)
    fine_y = torch.stack([torch.where(valid, fy0, 1),
                          torch.where(valid, fy1, 0)], dim=-1)
    if not with_attrs:
        attrs = torch.zeros((NATTR, 0), dtype=torch.float32,
                            device=edges.device)
        return TriangleSetup(edges=edges, attrs=attrs, tile_bbox=tile_bbox,
                             valid=valid, fine_y=fine_y)

    rows = []

    def add_plane(q0, q1, q2):
        rows.extend(plane(q0, q1, q2))

    ones = torch.ones_like(det)
    add_plane(ones, ones, ones)  # rows 0-2: 1/w
    add_plane(corner_uvs[:, 0, 0], corner_uvs[:, 1, 0],
              corner_uvs[:, 2, 0])  # 3-5: u/w
    add_plane(corner_uvs[:, 0, 1], corner_uvs[:, 1, 1],
              corner_uvs[:, 2, 1])  # 6-8: v/w
    for comp in range(3):  # 9-17: normal/w
        add_plane(corner_normals[:, 0, comp], corner_normals[:, 1, comp],
                  corner_normals[:, 2, comp])
    for comp in range(3):  # 18-26: tangent/w
        add_plane(corner_tangents[:, 0, comp], corner_tangents[:, 1, comp],
                  corner_tangents[:, 2, comp])
    # 27-29: material id + tangent-frame handedness as a constant plane
    n0 = [corner_normals[:, 0, c] for c in range(3)]
    t0 = [corner_tangents[:, 0, c] for c in range(3)]
    b0 = [corner_bitangents[:, 0, c] for c in range(3)]
    hand_neg = (
        (n0[1] * t0[2] - n0[2] * t0[1]) * b0[0]
        + (n0[2] * t0[0] - n0[0] * t0[2]) * b0[1]
        + (n0[0] * t0[1] - n0[1] * t0[0]) * b0[2]) < 0.0
    rows.append(torch.zeros_like(det))
    rows.append(torch.zeros_like(det))
    rows.append(tri_material.to(torch.float32) * 2.0
                + hand_neg.to(torch.float32))
    if prev_corners is not None:
        # 30-38: previous-frame clip planes (dynamic scenes only; static
        # motion reprojects the depth-derived world position instead)
        pm = prev_view_proj
        px = [prev_corners[:, v, 0] for v in range(3)]
        py = [prev_corners[:, v, 1] for v in range(3)]
        pz = [prev_corners[:, v, 2] for v in range(3)]

        def prev_row(r):
            return [pm[r, 0] * px[v] + pm[r, 1] * py[v] + pm[r, 2] * pz[v]
                    + pm[r, 3] for v in range(3)]

        for r in (0, 1, 3):
            add_plane(*prev_row(r))
    attrs = torch.stack(rows, dim=0).to(torch.float32)
    return TriangleSetup(edges=edges, attrs=attrs, tile_bbox=tile_bbox,
                         valid=valid, fine_y=fine_y)


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KeyInputs:
    """What kernel A reads: the per-triangle run tables and the key
    packing constants (static ints)."""

    cum: torch.Tensor  # (T,) i32 inclusive prefix sum of spans
    cum_ex: torch.Tensor  # (T,) i32 run start per triangle
    geom_packed: torch.Tensor  # (T,) i32 ty0 | tx0 | span_x | rel_fy0
    budget: int  # pair-stream slots
    n_tiles_x: int
    bin_rows: int
    order_rows: bool
    order_alpha: bool  # geom_packed's low bit: the pair is alpha-tested
    tpv: int  # triangles per view (T / n_views)
    key_rows: int  # sub-row factor in the key
    key_alpha: int  # 2 with order_alpha (an extra key bit), else 1
    sentinel: int  # key of dead slots


def pair_key_inputs(setup: TriangleSetup, n_tiles_y: int, n_tiles_x: int,
                    pair_budget: int | None = None, bin_rows: int = 1,
                    order_rows: bool = False, n_views: int = 1,
                    tri_alpha=None) -> KeyInputs:
    """Spans, their int32 prefix sum and the packed per-triangle geometry
    word (raster.py:829-867); n_views > 1 for a vertical atlas of views
    with T / n_views triangles each; tri_alpha (T,) bool adds a key bit
    that sorts alpha-tested pairs to the end of each bin (raster.py:821,
    :865-866, :897)."""
    t_count = setup.valid.shape[0]
    n_tiles = n_tiles_y * n_tiles_x
    if t_count % n_views or n_tiles % n_views:
        raise ValueError("triangles and tiles must split evenly into views")
    tpv = t_count // n_views
    key_rows = bin_rows if order_rows else 1
    key_alpha = 1 if tri_alpha is None else 2
    if (n_tiles * key_rows * key_alpha + 1) * (tpv + 1) >= 2 ** 31:
        raise ValueError("packed key overflow")
    if n_tiles_y > 512 or n_tiles_x > 128:
        raise ValueError("bbox packing overflow")
    if order_rows and bin_rows > 8:
        raise ValueError("rel_fy0 packs in 3 bits")
    ty0, tx0, ty1, tx1 = (setup.tile_bbox[:, i] for i in range(4))
    span_y = torch.where(setup.valid, ty1 - ty0 + 1, 0)
    span_x = torch.where(setup.valid, tx1 - tx0 + 1, 0)
    span = span_y * span_x
    if pair_budget is None:
        pair_budget = t_count + 8 * n_tiles * bin_rows
    budget = max(GROUP, (pair_budget + GROUP - 1) // GROUP * GROUP)
    # exclusive run starts: triangle t owns slots [cum_ex[t], cum[t]);
    # int32 like the JAX package (torch.cumsum widens unless told)
    cum = torch.cumsum(span, 0, dtype=torch.int32)
    cum_ex = cum - span
    if order_rows:
        rel_fy0 = torch.clamp(setup.fine_y[:, 0] - ty0 * bin_rows,
                              0, bin_rows - 1)
    else:
        rel_fy0 = 0
    geom_packed = ((ty0 * 128 + tx0) * 128 + span_x) * 8 + rel_fy0
    if tri_alpha is not None:
        geom_packed = geom_packed * 2 + tri_alpha.to(torch.int32)
    return KeyInputs(
        cum=cum.contiguous(), cum_ex=cum_ex.contiguous(),
        geom_packed=geom_packed.to(torch.int32).contiguous(), budget=budget,
        n_tiles_x=n_tiles_x, bin_rows=bin_rows, order_rows=order_rows,
        order_alpha=tri_alpha is not None, tpv=tpv, key_rows=key_rows,
        key_alpha=key_alpha,
        sentinel=n_tiles * key_rows * key_alpha * (tpv + 1))


def expand_keys_plain(ki: KeyInputs):
    """Plain version of kernel A: ((budget,) i32 keys, (budget,) i32
    owners), owner(j) = the first t with cum[t] > j, keyed by its
    view-local index owner % tpv (the tile doubled plus the pair's alpha
    bit with order_alpha); dead slots (j >= total) get the sentinel key and
    owner 0."""
    t_count = ki.cum.shape[0]
    j = torch.arange(ki.budget, dtype=torch.int32, device=ki.cum.device)
    live = j < ki.cum[-1]
    owner = torch.searchsorted(ki.cum, j, right=True).to(torch.int32)
    owner = torch.clamp(owner, max=t_count - 1)
    k = j - ki.cum_ex[owner.long()]
    g = ki.geom_packed[owner.long()]
    if ki.order_alpha:
        ia = g & 1
        g = g >> 1
    rel0 = g & 7
    sx = torch.clamp((g >> 3) & 127, min=1)
    x0 = (g >> 10) & 127
    y0 = g >> 17
    kc = torch.clamp(k, 0, (1 << 23) - 1)
    dy = torch.div(kc, sx, rounding_mode="trunc")
    dx = kc - dy * sx
    tile = (y0 + dy) * ki.n_tiles_x + x0 + dx
    tri_local = torch.remainder(owner, ki.tpv)
    if ki.order_alpha:
        tile = tile * 2 + ia
    if ki.order_rows:
        kymin = torch.clamp(rel0 - dy * ki.bin_rows, min=0)
        key = (tile * ki.bin_rows + kymin) * (ki.tpv + 1) + tri_local
    else:
        key = tile * (ki.tpv + 1) + tri_local
    keys = torch.where(live, key, ki.sentinel).to(torch.int32)
    owners = torch.where(live, owner, 0).to(torch.int32)
    return keys, owners


def expand_keys(ki: KeyInputs):
    """Kernel A (csrc/expand_keys.cu, replaces raster.py:406
    _expand_keys_kernel): slot -> (sort key, owning triangle)."""
    dev = ki.cum.device
    for name in ("cum", "cum_ex", "geom_packed"):
        _require(getattr(ki, name), name, torch.int32, 1, dev)
    t_count = ki.cum.shape[0]
    if t_count < 1 or ki.cum_ex.shape[0] != t_count \
            or ki.geom_packed.shape[0] != t_count:
        raise ValueError("cum, cum_ex and geom_packed need one equal, "
                         "non-zero length")
    if not _kernel_device(ki.cum):
        return expand_keys_plain(ki)
    keys = torch.empty((ki.budget,), dtype=torch.int32, device=dev)
    owners = torch.empty((ki.budget,), dtype=torch.int32, device=dev)
    native.launch("expand_keys_launch", ki.cum, ki.cum_ex, ki.geom_packed,
                  keys, owners, t_count, ki.budget, ki.n_tiles_x,
                  ki.bin_rows, int(ki.order_rows), int(ki.order_alpha),
                  ki.tpv, ki.sentinel)
    return keys, owners


def expand_rows_plain(owners, table, total, budget: int):
    """Plain version of kernel M: (rows, budget) f32, column j the table
    column of slot j's owner for live slots (j < total), 0 for dead ones
    (raster.py:950-953, the expand_impl="xla" branch)."""
    live = torch.arange(budget, device=owners.device) < total
    return torch.where(live[None], table.index_select(1, owners.long()), 0.0)


def expand_rows(owners, table, total, budget: int):
    """Kernel M (csrc/expand_rows.cu, replaces raster.py:606
    _expand_rows_kernel): the presort row expansion out[:, j] =
    table[:, owner(j)] of build_pairs(carry_table=...). owners (budget,)
    i32 from kernel A, table (rows, T+1) f32, total a (1,) i32 tensor
    (the stream's live slots, cum[-1])."""
    dev = owners.device
    _require(owners, "owners", torch.int32, 1, dev)
    _require(table, "table", torch.float32, 2, dev)
    _require(total, "total", torch.int32, 1, dev)
    if owners.shape[0] != budget or total.shape[0] != 1:
        raise ValueError("owners needs one entry per slot, total one value")
    if not _kernel_device(owners):
        return expand_rows_plain(owners, table, total, budget)
    out = torch.empty((table.shape[0], budget), dtype=torch.float32,
                      device=dev)
    native.launch("expand_rows_launch", owners, table, total, out,
                  table.shape[0], table.shape[1], budget)
    return out


def build_pairs(setup: TriangleSetup, n_tiles_y: int, n_tiles_x: int,
                pair_budget: int | None = None, bin_rows: int = 1,
                order_rows: bool = False, n_views: int = 1,
                tile_cap: int | None = None, tri_alpha=None,
                carry_table=None):
    """Expand triangles into sorted per-bin pair lists (raster.py:737).

    Exact prefix-sum emission into one `pair_budget`-slot stream; pairs
    past the budget are dropped from the end of the triangle array and
    counted in `overflow`, as are pairs past a bin's cap of
    MAX_PAIRS_PER_TILE - GROUP (the slot must fit SLOT_BITS with the
    group-aligned lead-in). order_rows packs each pair's first covered
    16px sub-row into the key, so a bin's segment comes out y-sorted.

    n_views > 1: the setup is a vertical atlas of n_views views (the shadow
    cascades), T / n_views triangles each, bboxes offset into each view's
    band of bin rows; the key packs the view-local triangle and the decode
    recovers the view from the bin (raster.py:780-786, :967-981).
    tile_cap replaces the winner-slot cap for depth-only consumers, which
    have no slot to pack (raster.py:994-1001). tri_alpha (T,) bool sorts
    each bin's alpha-tested pairs to its end (raster.py:821-830).

    carry_table (rows, T+1) f32, a setup_row_table: kernel M expands its
    columns into presort slot order and the sort's permutation moves them
    with the keys (raster.py:938-960); returns (pairs, pair_rows), the
    (rows, budget + GROUP) pair-order rows, zero past the live slots. The
    frame does not use this path (raster.py:628-634)."""
    ki = pair_key_inputs(setup, n_tiles_y, n_tiles_x, pair_budget,
                         bin_rows, order_rows, n_views, tri_alpha)
    t_count = setup.valid.shape[0]
    n_tiles = n_tiles_y * n_tiles_x
    keys, owners = expand_keys(ki)
    if carry_table is None:
        keys_sorted = torch.sort(keys).values
    else:
        rows_pre = expand_rows(owners, carry_table, ki.cum[-1:], ki.budget)
        keys_sorted, perm = torch.sort(keys, stable=True)
        # one GROUP of zero tail columns, as pair_tri's padding
        pair_rows = torch.nn.functional.pad(rows_pre.index_select(1, perm),
                                            (0, GROUP))
    key_span = ki.key_rows * ki.key_alpha * (ki.tpv + 1)
    # sentinel keys decode to tile == n_tiles -> view n_views -> index
    # t_count, the degenerate padding row
    view = (keys_sorted // key_span) // (n_tiles // n_views)
    tri_glob = view * ki.tpv + keys_sorted % (ki.tpv + 1)
    pair_tri = torch.cat([
        torch.clamp(tri_glob, max=t_count).to(torch.int32),
        torch.full((GROUP,), t_count, dtype=torch.int32,
                   device=keys.device)])
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=keys.device)
    raw_start = torch.searchsorted(keys_sorted, tile_ids * key_span)
    raw_end = torch.searchsorted(keys_sorted, (tile_ids + 1) * key_span)
    n_real = (raw_end - raw_start).to(torch.int32)
    cap = MAX_PAIRS_PER_TILE - GROUP if tile_cap is None else tile_cap
    capped = torch.clamp(n_real, max=cap)
    overflow = (torch.clamp(ki.cum[-1] - ki.budget, min=0)
                + torch.sum(n_real - capped, dtype=torch.int32))
    pairs = PairLists(pair_tri=pair_tri,
                      tile_start=raw_start.to(torch.int32),
                      tile_count=capped, overflow=overflow.to(torch.int32))
    if carry_table is None:
        return pairs
    return pairs, pair_rows


def setup_row_table(setup: TriangleSetup, row_extents: bool = False):
    """The (rows, T+1) per-triangle row table (raster.py:1053): 16 edge
    rows, plane-major [a, b, c, pad] x 4 planes (rows 3 and 7 carry the
    fine-row bbox [fy0, fy1] with row_extents), then the attribute rows
    padded to a multiple of 8. Column T is a degenerate never-covering
    triangle. Returns (table, n_edge_rows)."""
    t_count = setup.valid.shape[0]
    n_planes = setup.edges.shape[1]
    n_rows = 4 * n_planes
    dev = setup.edges.device
    never = torch.zeros((3, n_planes, 1), dtype=torch.float32, device=dev)
    never[2, :, 0] = -1.0
    e = torch.cat([setup.edges, never], dim=2)  # (3, p, T+1)
    pad_rows = torch.zeros((1, n_planes, t_count + 1), dtype=torch.float32,
                           device=dev)
    if row_extents:
        pad_rows[0, 0, :t_count] = setup.fine_y[:, 0]
        pad_rows[0, 1, :t_count] = setup.fine_y[:, 1]
        # empty range for the padding row; a slice fill, because a
        # single-element assignment copies a host scalar and waits
        pad_rows[0, 0, t_count:] = 1.0
    edges_rows = torch.cat([e, pad_rows], dim=0).permute(1, 0, 2).reshape(
        n_rows, t_count + 1)
    if setup.attrs.shape[1] == 0:  # a depth-only setup
        return edges_rows, n_rows
    n_attr = setup.attrs.shape[0]
    attrs_pad = torch.zeros((n_attr + (-n_attr) % 8, t_count + 1),
                            dtype=torch.float32, device=dev)
    attrs_pad[:n_attr, :t_count] = setup.attrs
    return torch.cat([edges_rows, attrs_pad], dim=0), n_rows


def gather_pair_setups(setup: TriangleSetup, pairs: PairLists,
                       row_extents: bool = False, with_attrs: bool = True):
    """Duplicate per-triangle setups into pair order (raster.py:1021):
    (pair_edges (16, P) f32, pair_attrs (32, P) f32 (40 with a dynamic
    scene's prev-clip rows), or None without attributes)."""
    rows, n_rows = setup_row_table(setup, row_extents)
    if not with_attrs:
        return rows[:n_rows].index_select(1, pairs.pair_tri.long()), None
    pair_rows = rows.index_select(1, pairs.pair_tri.long())
    return pair_rows[:n_rows].contiguous(), pair_rows[n_rows:].contiguous()


# --------------------------------------------------------------------------
# G-buffer raster (kernel B) and its plain version
# --------------------------------------------------------------------------

def _split_round(a: torch.Tensor) -> torch.Tensor:
    """The TPU's two-pass bf16 one-hot product (raster.py:1650-1670):
    hi = bf16(a), lo = bf16(a - hi), coeff = hi + lo."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    lo = (a - hi).to(torch.bfloat16).to(torch.float32)
    return hi + lo


def _kernel_recip(x: torch.Tensor) -> torch.Tensor:
    """raster.py:1148 — 1/x for x > 0 as rsqrt(x)^2 + one Newton step."""
    r = torch.rsqrt(x)
    r = r * r
    return r * (2.0 - x * r)


def _gbuffer_channels(coeff: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Evaluate the winner's 30 attribute rows (zeros where invalid) at
    pixel centres x, y (raster.py:1680-1726): (13, ...) channels. With a
    dynamic scene's NATTR_PREV rows, also the previous-frame NDC xy
    (raster.py:1728-1740): (15, ...)."""

    def ev(b):
        return coeff[b] * x + coeff[b + 1] * y + coeff[b + 2]

    w = torch.where(valid, _kernel_recip(torch.clamp_min(ev(0), 1e-12)),
                    0.0)
    u = ev(3) * w
    v = ev(6) * w
    ua, ub = coeff[3], coeff[4]
    va, vb = coeff[6], coeff[7]
    wa, wb = coeff[0], coeff[1]
    out = [u, v, (ua - u * wa) * w, (va - v * wa) * w,
           (ub - u * wb) * w, (vb - v * wb) * w]
    for base_row in (9, 18):  # normal, tangent: normalised, masked
        cx = ev(base_row) * w
        cy = ev(base_row + 3) * w
        cz = ev(base_row + 6) * w
        inv_len = torch.rsqrt(torch.clamp_min(cx * cx + cy * cy + cz * cz,
                                              1e-20))
        out += [torch.where(valid, c * inv_len, 0.0) for c in (cx, cy, cz)]
    out.append(coeff[29])
    if coeff.shape[0] >= NATTR_PREV:
        prev_x = ev(30) * w
        prev_y = ev(33) * w
        prev_w = ev(36) * w
        # signed reciprocal: _kernel_recip needs x > 0, so factor the sign
        ok_w = torch.abs(prev_w) > 1e-9
        inv_pw = torch.where(ok_w, torch.sign(prev_w) * _kernel_recip(
            torch.where(ok_w, torch.abs(prev_w), 1.0)), 1.0)
        out += [torch.where(valid, prev_x * inv_pw, 0.0),
                torch.where(valid, prev_y * inv_pw, 0.0)]
    return torch.stack(out)


# largest (bins x pairs x pixels) block the plain G-buffer evaluates at
# once: 64 MB per float32 intermediate, so 1080p fits on the card
_PLAIN_CHUNK_ELEMS = 1 << 24


# depth-only passes clamp z into [1/16384, 1] (raster.py:1368-1374)
DEPTH_CLAMP_MIN = 1.0 / 16384.0
MAX_ALPHA_MASKS = 8  # mask rows the alpha kernels stage (textures.py:49)
ALPHA_MASK_WORDS = 128  # 64 x 64 bits per mask
SLOT_ROW = 30  # pair-edge row of plane 7's c: the pair's mask slot


def _alpha_passes(plane, slot, masks: torch.Tensor) -> torch.Tensor:
    """The alpha test of kernels J and K (raster.py:1393-1416): the
    perspective-correct uv of planes 4-6 (u/w, v/w, 1/w), wrapped into a
    64x64 grid, selects one bit of mask slot - 1; a pair passes where its
    slot is below 0.5 (opaque) or the bit is 1. A slot that names no mask
    reads all ones, as the TPU kernel's table default (-1) does."""
    uw, vw, iw = plane(4), plane(5), plane(6)
    inv = _kernel_recip(torch.where(iw > 1e-12, iw, 1.0))
    u = uw * inv
    v = vw * inv
    ix = torch.clamp((u - torch.floor(u)) * 64.0, 0.0, 63.0).to(torch.int32)
    iy = torch.clamp((v - torch.floor(v)) * 64.0, 0.0, 63.0).to(torch.int32)
    n_masks = masks.shape[0]
    rs = torch.round(slot)
    hit = (rs >= 1.0) & (rs <= n_masks) & (torch.abs(slot - rs) < 0.5)
    row = torch.where(hit, rs - 1.0, float(n_masks)).long()
    table = torch.cat([masks, torch.full_like(masks[:1], -1)]).reshape(-1)
    word = table[row * ALPHA_MASK_WORDS + (iy * 2 + (ix >= 32)).long()]
    bit = (word >> (ix & 31)) & 1
    return (slot < 0.5) | (bit == 1)


def _plain_visibility(pair_edges, tile_start, tile_count, n_tiles_y: int,
                      n_tiles_x: int, sub: int, row_skip: bool,
                      depth_only: bool, masks=None,
                      init=None) -> torch.Tensor:
    """The visibility max of kernels B, E, J and K, (H, W) i32.

    Winner (depth_only=False): the max of (bits(z) & ~SLOT_MASK) | slot
    over pairs covering a pixel with 0 < z <= 1. Depth only: the max of
    bits(clamp(z, 1/16384, 1)) over pairs whose edges cover the pixel,
    starting from init's bits (init (H, W) f32, else 0). masks (n, 128)
    i32 with the 32-row alpha table adds _alpha_passes to coverage.
    Loops over chunks of bins and of each chunk's pairs, at most
    _PLAIN_CHUNK_ELEMS (bin, pair, pixel) evaluations at a time."""
    dev = pair_edges.device
    n_pairs = pair_edges.shape[1]
    rows_px = sub * TILE_H
    n_bins = n_tiles_y * n_tiles_x
    h, w = n_tiles_y * rows_px, n_tiles_x * TILE_W
    bins = torch.arange(n_bins, device=dev)
    bin_y, bin_x = bins // n_tiles_x, bins % n_tiles_x
    ly = torch.arange(rows_px, device=dev)
    lx = torch.arange(TILE_W, device=dev)
    xs = (bin_x[:, None] * TILE_W + lx[None]).to(torch.float32) + 0.5
    ys = (bin_y[:, None] * rows_px + ly[None]).to(torch.float32) + 0.5
    fine_row = (bin_y[:, None] * sub + ly[None] // TILE_H).to(torch.float32)
    starts = tile_start.long()
    counts = tile_count.long()
    lead = starts - starts // GROUP * GROUP
    if init is None:
        acc = torch.zeros((n_bins, rows_px, TILE_W), dtype=torch.int32,
                          device=dev)
    else:  # positive f32 bits order as i32; 0 is the identity
        acc = init.view(torch.int32).reshape(
            n_tiles_y, rows_px, n_tiles_x, TILE_W).permute(0, 2, 1, 3) \
            .reshape(n_bins, rows_px, TILE_W).clone()
    bin_chunk = max(1, _PLAIN_CHUNK_ELEMS // (64 * rows_px * TILE_W))
    for b0 in range(0, n_bins, bin_chunk):
        b1 = min(b0 + bin_chunk, n_bins)
        nb = b1 - b0
        maxc = int(counts[b0:b1].max()) if nb else 0
        pc = max(1, min(maxc,
                        _PLAIN_CHUNK_ELEMS // (nb * rows_px * TILE_W)))
        for c0 in range(0, maxc, pc):
            i = torch.arange(c0, min(c0 + pc, maxc), device=dev)
            live = i[None] < counts[b0:b1, None]  # (nb, pc)
            idx = torch.clamp(starts[b0:b1, None] + i[None], max=n_pairs - 1)
            cf = pair_edges[:, idx]  # (rows, nb, pc)
            x = xs[b0:b1, None, None, :]
            y = ys[b0:b1, None, :, None]

            def plane(p):
                a, b, c = (cf[4 * p + k][..., None, None] for k in range(3))
                return a * x + (b * y + c)

            e0, e1, e2, z = plane(0), plane(1), plane(2), plane(3)
            cov = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                   & live[..., None, None])
            if row_skip:
                fr = fine_row[b0:b1, None, :, None]
                cov = cov & ((cf[3][..., None, None] <= fr)
                             & (fr <= cf[7][..., None, None]))
            if masks is not None:
                cov = cov & _alpha_passes(
                    plane, cf[SLOT_ROW][..., None, None], masks)
            if depth_only:
                zc = torch.clamp(z, DEPTH_CLAMP_MIN, 1.0)
                cand = torch.where(cov, zc.view(torch.int32), 0)
            else:
                slot = (lead[b0:b1, None] + i[None]).to(torch.int32)
                cand = torch.where(
                    cov & (z > 0.0) & (z <= 1.0),
                    (z.view(torch.int32) & ~SLOT_MASK)
                    | slot[..., None, None], 0)
            acc[b0:b1] = torch.maximum(acc[b0:b1], cand.amax(dim=1))

    return acc.reshape(n_tiles_y, n_tiles_x, rows_px, TILE_W).permute(
        0, 2, 1, 3).reshape(h, w)


def _vis_encode(acc2d: torch.Tensor):
    """The vis-buffer contract (raster.py:1129-1145) of the packed winner
    max: (depth with the slot bits cleared, vis = the slot counted from
    the bin segment's group-aligned base, -1 where uncovered)."""
    depth = (acc2d & ~SLOT_MASK).view(torch.float32)
    vis = torch.where(acc2d != 0, acc2d & SLOT_MASK, -1).to(torch.int32)
    return depth, vis


def _winner_channels(coeff_of, n_pairs: int, tile_start, vis,
                     n_tiles_y: int, n_tiles_x: int,
                     sub: int) -> torch.Tensor:
    """The channels of each pixel's winner, read from vis (the _vis_decode
    side of the contract, raster.py:1137-1145): coeff_of(idx) gives the
    rounded (n_attr, N) coefficients of the pair columns idx (N,)."""
    rows_px = sub * TILE_H
    h, w = n_tiles_y * rows_px, n_tiles_x * TILE_W
    valid = vis >= 0
    starts = tile_start.long()
    base = (starts // GROUP * GROUP).reshape(n_tiles_y, 1, n_tiles_x, 1)
    base = base.expand(n_tiles_y, rows_px, n_tiles_x, TILE_W).reshape(h, w)
    idx = torch.where(valid, base + vis, 0).clamp(max=n_pairs - 1)
    coeff = torch.where(valid, coeff_of(idx.reshape(-1)).reshape(-1, h, w),
                        0.0)
    px = torch.arange(w, device=vis.device).to(torch.float32) + 0.5
    py = torch.arange(h, device=vis.device).to(torch.float32) + 0.5
    return _gbuffer_channels(coeff, px[None, :], py[:, None], valid)


def attr_resolve_plain(pair_attrs, tile_start, vis, n_tiles_y: int,
                       n_tiles_x: int, sub: int) -> torch.Tensor:
    """Plain version of kernel L and of kernel B's attribute half: the
    (13, H, W) channels of each pixel's winner, with the coefficients
    split-rounded as the TPU's bf16 one-hot product; (15, H, W) from a
    dynamic scene's 40-row pair_attrs."""
    n_attr = NATTR_PREV if pair_attrs.shape[0] >= NATTR_PREV else NATTR
    return _winner_channels(
        lambda idx: _split_round(pair_attrs[:n_attr, idx]),
        pair_attrs.shape[1], tile_start, vis, n_tiles_y, n_tiles_x, sub)


def gbuffer_plain(pair_edges, pair_attrs, tile_start, tile_count,
                  n_tiles_y: int, n_tiles_x: int, sub: int,
                  row_skip: bool):
    """Plain version of kernel B: (depth (H, W) f32, vis (H, W) i32,
    gbuf (13 or 15, H, W) f32), same arithmetic as csrc/gbuffer.cu."""
    depth, vis = _vis_encode(_plain_visibility(
        pair_edges, tile_start, tile_count, n_tiles_y, n_tiles_x, sub,
        row_skip, depth_only=False))
    return depth, vis, attr_resolve_plain(pair_attrs, tile_start, vis,
                                          n_tiles_y, n_tiles_x, sub)


def winner_alpha_plain(pair_edges, tile_start, tile_count, masks,
                       n_tiles_y: int, n_tiles_x: int, sub: int,
                       row_skip: bool):
    """Plain version of kernel K: (depth (H, W) f32, vis (H, W) i32), the
    alpha-tested winner max of the 32-row table."""
    return _vis_encode(_plain_visibility(
        pair_edges, tile_start, tile_count, n_tiles_y, n_tiles_x, sub,
        row_skip, depth_only=False, masks=masks))


def _check_bins(pairs: PairLists, n_tiles_y: int, n_tiles_x: int,
                dev) -> None:
    _require(pairs.tile_start, "tile_start", torch.int32, 1, dev)
    _require(pairs.tile_count, "tile_count", torch.int32, 1, dev)
    n_bins = n_tiles_y * n_tiles_x
    if pairs.tile_start.shape[0] != n_bins \
            or pairs.tile_count.shape[0] != n_bins:
        raise ValueError("tile_start/tile_count need one entry per bin")


def _gbuffer_channel_count(pair_attrs: torch.Tensor) -> int:
    """13 channels from a static scene's 32-row pair_attrs, 15 from a
    dynamic scene's 40 rows (NATTR_PREV padded to 8); raises otherwise."""
    rows = pair_attrs.shape[0]
    if rows not in (32, 40):
        raise ValueError(f"pair_attrs needs 32 (static) or 40 (dynamic) "
                         f"rows, got {tuple(pair_attrs.shape)}")
    return GBUF_CHANNELS + (2 if rows >= NATTR_PREV else 0)


def _check_masks(alpha_masks, dev) -> None:
    _require(alpha_masks, "alpha_masks", torch.int32, 2, dev)
    if alpha_masks.shape[1] != ALPHA_MASK_WORDS \
            or not 1 <= alpha_masks.shape[0] <= MAX_ALPHA_MASKS:
        raise ValueError(f"alpha_masks needs (1-{MAX_ALPHA_MASKS}, "
                         f"{ALPHA_MASK_WORDS}), got "
                         f"{tuple(alpha_masks.shape)}")


def rasterize_winner_alpha(pair_edges, pairs: PairLists, alpha_masks,
                           n_tiles_y: int, n_tiles_x: int, sub: int = 1,
                           row_skip: bool = False):
    """Alpha-tested visibility with winner tracking (kernel K,
    csrc/gbuffer_alpha.cu, replaces raster.py:1743 _winner_alpha_kernel):
    (depth (H, W) f32 with the slot bits cleared, vis (H, W) i32), from
    the 32-row pair table (gather_pair_setups of an 8-plane setup)."""
    dev = pair_edges.device
    _require(pair_edges, "pair_edges", torch.float32, 2, dev)
    _check_bins(pairs, n_tiles_y, n_tiles_x, dev)
    _check_masks(alpha_masks, dev)
    if pair_edges.shape[0] != 32:
        raise ValueError(f"pair_edges needs the 32-row alpha table, got "
                         f"{tuple(pair_edges.shape)}")
    if not 1 <= sub <= 4:  # the bin heights kernel K was checked at
        raise ValueError(f"sub must be in [1, 4], got {sub}")
    if not _kernel_device(pair_edges):
        return winner_alpha_plain(pair_edges, pairs.tile_start,
                                  pairs.tile_count, alpha_masks, n_tiles_y,
                                  n_tiles_x, sub, row_skip)
    n_bins = n_tiles_y * n_tiles_x
    h, w = n_tiles_y * sub * TILE_H, n_tiles_x * TILE_W
    # warps take (16 x 16 block, pair slice) items, the first by their
    # index in the grid, then from aux[0]; aux[1:] holds each block's
    # merge counters and flag, then the bins' order where it does not fit
    # shared memory (ORDER_INTS)
    aux = torch.zeros((1 + 3 * 8 * n_bins * sub + ORDER_INTS * n_bins,),
                      dtype=torch.int32, device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    vis = torch.empty((h, w), dtype=torch.int32, device=dev)
    native.launch("winner_alpha_launch", pair_edges, alpha_masks,
                  pairs.tile_start, pairs.tile_count, aux, depth, vis,
                  pair_edges.shape[1], alpha_masks.shape[0], n_tiles_y,
                  n_tiles_x, sub, int(row_skip))
    return depth, vis


def attr_table_plain(pair_attrs) -> torch.Tensor:
    """Plain version of kernel L's first launch: each pair column's
    attribute rows split-rounded once into a pair-major record, (P, 32)
    f32 (30 rows, 2 zeros), (P, 40) from a dynamic scene's 40 rows (39, 1
    zero)."""
    n_attr = NATTR_PREV if pair_attrs.shape[0] >= NATTR_PREV else NATTR
    rec = 40 if n_attr == NATTR_PREV else 32
    table = torch.zeros((pair_attrs.shape[1], rec), dtype=torch.float32,
                        device=pair_attrs.device)
    table[:, :n_attr] = _split_round(pair_attrs[:n_attr]).T
    return table


def attr_resolve_table_plain(table, tile_start, vis, n_tiles_y: int,
                             n_tiles_x: int, sub: int) -> torch.Tensor:
    """Plain version of kernel L's second launch: attr_resolve_plain's
    channels with each winner's coefficients read from its record in
    attr_table_plain's table (equal bits: the rounding is per value)."""
    n_attr = NATTR_PREV if table.shape[1] >= NATTR_PREV else NATTR
    return _winner_channels(lambda idx: table[idx, :n_attr].T,
                            table.shape[0], tile_start, vis, n_tiles_y,
                            n_tiles_x, sub)


def resolve_attributes(pair_attrs, tile_start, vis, n_tiles_y: int,
                       n_tiles_x: int, sub: int = 1) -> torch.Tensor:
    """The winners' attribute planes -> (13, H, W) G-buffer channels, 15
    with a dynamic scene's 40-row pair_attrs (kernel L,
    csrc/gbuffer_alpha.cu, replaces raster.py:1755 _attr_resolve_kernel):
    vis from rasterize_winner_alpha, the same arithmetic as kernel B's
    attribute phase. One launch of two grids: every pair's rows rounded
    once into a pair-major table (attr_table_plain), then the pixels
    (attr_resolve_table_plain)."""
    dev = pair_attrs.device
    _require(pair_attrs, "pair_attrs", torch.float32, 2, dev)
    _require(tile_start, "tile_start", torch.int32, 1, dev)
    _require(vis, "vis", torch.int32, 2, dev)
    h, w = n_tiles_y * sub * TILE_H, n_tiles_x * TILE_W
    n_chan = _gbuffer_channel_count(pair_attrs)
    if tuple(vis.shape) != (h, w) \
            or tile_start.shape[0] != n_tiles_y * n_tiles_x:
        raise ValueError(f"want ({h}, {w}) vis and one start per bin")
    if not _kernel_device(pair_attrs):
        return attr_resolve_table_plain(attr_table_plain(pair_attrs),
                                        tile_start, vis, n_tiles_y,
                                        n_tiles_x, sub)
    if vis.data_ptr() % 16:
        raise ValueError("vis must be 16-byte aligned (kernel L reads 4 "
                         "pixels at once)")
    n_pairs = pair_attrs.shape[1]
    prev = int(n_chan > GBUF_CHANNELS)
    table = torch.empty((n_pairs, 40 if prev else 32), dtype=torch.float32,
                        device=dev)
    gbuf = torch.empty((n_chan, h, w), dtype=torch.float32, device=dev)
    native.launch("attr_resolve_launch", pair_attrs, table, tile_start, vis,
                  gbuf, n_pairs, n_tiles_y, n_tiles_x, sub, prev)
    return gbuf


def rasterize_gbuffer(pair_edges, pair_attrs, pairs: PairLists,
                      n_tiles_y: int, n_tiles_x: int, sub: int = 1,
                      row_skip: bool = False, alpha_masks=None):
    """Main-view rasterization producing depth + visibility + G-buffer
    (raster.py:1857).

    Channels: uv (0-1), uv screen derivatives (2-5), normal (6-8), tangent
    (9-11), packed material*2+handedness (12), and with a dynamic scene's
    40-row pair_attrs the previous-frame NDC xy (13-14). vis holds each covered
    pixel's slot relative to start // GROUP * GROUP of its bin's segment,
    -1 where uncovered; depth keeps the slot bits cleared. row_skip needs
    pair_edges rows 3/7 from gather_pair_setups(row_extents=True).
    Opaque (16-row pair_edges): kernel B, csrc/gbuffer.cu. With
    alpha_masks (32-row pair_edges): the split of raster.py:1784, kernel
    K (visibility) then kernel L (attributes)."""
    if alpha_masks is not None:
        depth, vis = rasterize_winner_alpha(pair_edges, pairs, alpha_masks,
                                            n_tiles_y, n_tiles_x, sub,
                                            row_skip)
        return depth, vis, resolve_attributes(pair_attrs, pairs.tile_start,
                                              vis, n_tiles_y, n_tiles_x, sub)
    dev = pair_edges.device
    _require(pair_edges, "pair_edges", torch.float32, 2, dev)
    _require(pair_attrs, "pair_attrs", torch.float32, 2, dev)
    _check_bins(pairs, n_tiles_y, n_tiles_x, dev)
    n_pairs = pair_edges.shape[1]
    if pair_edges.shape[0] != 16:
        raise ValueError(f"pair_edges needs 16 rows, got {pair_edges.shape}")
    n_chan = _gbuffer_channel_count(pair_attrs)
    if pair_attrs.shape[1] != n_pairs:
        raise ValueError(f"pair_attrs needs {n_pairs} columns, got "
                         f"{tuple(pair_attrs.shape)}")
    if not 1 <= sub <= 4:  # the bin heights kernel B was checked at
        raise ValueError(f"sub must be in [1, 4], got {sub}")
    if not _kernel_device(pair_edges):
        return gbuffer_plain(pair_edges, pair_attrs, pairs.tile_start,
                             pairs.tile_count, n_tiles_y, n_tiles_x, sub,
                             row_skip)
    h, w = n_tiles_y * sub * TILE_H, n_tiles_x * TILE_W
    n_bins = n_tiles_y * n_tiles_x
    # warps take (16-row strip, pair slice) items from aux[0], then
    # resolve items from aux[1]; aux[2:] holds each strip's merge counters
    # and flags, then the bins' order where it does not fit shared memory
    # (ORDER_INTS). rounded: the live pairs' split-rounded attribute rows
    aux = torch.zeros((2 + 4 * n_bins * sub + ORDER_INTS * n_bins,),
                      dtype=torch.int32, device=dev)
    rounded = torch.empty_like(pair_attrs)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    vis = torch.empty((h, w), dtype=torch.int32, device=dev)
    gbuf = torch.empty((n_chan, h, w), dtype=torch.float32, device=dev)
    native.launch("gbuffer_launch", pair_edges, pair_attrs, rounded,
                  pairs.tile_start, pairs.tile_count, aux, depth, vis, gbuf,
                  n_pairs, n_tiles_y, n_tiles_x, sub, int(row_skip),
                  int(n_chan > GBUF_CHANNELS))
    return depth, vis, gbuf


# --------------------------------------------------------------------------
# depth-only raster (kernels E and J) and its plain version
# --------------------------------------------------------------------------

DEPTH_CHUNK = 128  # pairs per slice of kernel E (csrc/depth.cu, E_CHUNK)
J_CHUNK = 32  # pairs per slice of kernel J (csrc/depth_alpha.cu, J_CHUNK)
K_CHUNK = 16  # pairs per slice of kernel K (csrc/gbuffer_alpha.cu, K_CHUNK)
# The strip kernels E, B, J and K order the bins (2 ints per bin) in
# shared memory while they fit (opting in above 48 KB), else in a scratch
# at the end of their aux (csrc/common.cuh, plain_strip_launch): they take
# any bin count that build_pairs makes.
ORDER_INTS = 2


def depth_plain(pair_edges, tile_start, tile_count, n_tiles_y: int,
                n_tiles_x: int, sub: int, row_skip: bool, masks=None,
                init=None) -> torch.Tensor:
    """Plain version of kernels E and J: (H, W) f32 reverse-Z depth, the
    max of clamp(z, 1/16384, 1) over pairs whose edges cover the pixel
    (and, with masks, pass the alpha test), starting from init (else 0)."""
    return _plain_visibility(pair_edges, tile_start, tile_count, n_tiles_y,
                             n_tiles_x, sub, row_skip, depth_only=True,
                             masks=masks, init=init).view(torch.float32)


def block_may_cover(edges, x0, y0, bw: int, bh: int,
                    z=None) -> torch.Tensor:
    """The block test of kernels E and B, exact: False only where no pixel
    centre of the bw x bh block whose first column / row is x0 / y0 can
    have all three edge planes >= 0 under the rounded a*x + (b*y + c) of
    the plain versions (and, given the z plane's (a, b, c) as z, 0 < z <=
    1). edges (3, 3, ...) f32 holds (a, b, c) of planes e0-e2,
    broadcastable with the integer tensors x0, y0. Round-to-nearest is
    monotone, so fl(a*x) is monotone in x, fl(fl(b*y) + c) in y and the
    sum in both: each plane is largest at the corner the signs of a and b
    pick and smallest at the opposite one. An edge rejects the block when
    its largest value is < 0 or NaN (a NaN corner leaves every pixel < 0
    or NaN: see tests/test_torch_block_reject.py); z when its largest is
    not > 0 or its smallest not <= 1 (csrc/common.cuh,
    plain_plane_may_pass and plain_depth_may_pass)."""
    def corner(p, high):
        a, b, c = p[0], p[1], p[2]
        x = torch.where((a > 0) == high, x0 + (bw - 1), x0)
        y = torch.where((b > 0) == high, y0 + (bh - 1), y0)
        return a * (x.to(torch.float32) + 0.5) + (
            b * (y.to(torch.float32) + 0.5) + c)

    may = (corner(edges[0], True) >= 0.0) & (corner(edges[1], True) >= 0.0) \
        & (corner(edges[2], True) >= 0.0)
    if z is not None:
        may = may & (corner(z, True) > 0.0) & (corner(z, False) <= 1.0)
    return may


def rasterize_depth(pair_edges, pairs: PairLists, n_tiles_y: int,
                    n_tiles_x: int, sub: int = 1, row_skip: bool = False,
                    alpha_masks=None, init_depth=None) -> torch.Tensor:
    """Depth-only rasterization (raster.py:1494, the sun-shadow atlas).
    n_tiles_y counts bins of sub * 16 rows, as the build_pairs run that
    made `pairs`. Coverage is the three edge planes alone, and z is
    clamped into [1/16384, 1]: the reference renders cascades with depth
    clamping, so casters outside the fitted z range still write
    (raster.py:1368-1374). row_skip needs pair_edges rows 3/7 from
    gather_pair_setups(row_extents=True). Returns (H, W) f32, 0 where
    nothing covers.

    Opaque casters (16-row pair_edges): kernel E, csrc/depth.cu, replaces
    raster.py:1465 _depth_kernel. With alpha_masks (32-row pair_edges):
    kernel J, csrc/depth_alpha.cu, replaces _depth_kernel_alpha (:1474)
    and, with init_depth (the opaque pass's (H, W) depth),
    _depth_kernel_alpha_acc (:1483): the alpha casters are max-merged bit
    for bit into init_depth in place, which is returned (the opaque atlas
    is not kept, so the merge copies nothing)."""
    dev = pair_edges.device
    alpha = alpha_masks is not None
    _require(pair_edges, "pair_edges", torch.float32, 2, dev)
    _check_bins(pairs, n_tiles_y, n_tiles_x, dev)
    if init_depth is not None and not alpha:
        raise ValueError("init_depth merges the alpha pass onto the opaque "
                         "one: it needs alpha_masks")
    if pair_edges.shape[0] != (32 if alpha else 16):
        raise ValueError(
            f"pair_edges needs {32 if alpha else 16} rows "
            f"({'alpha' if alpha else 'opaque'} table), got "
            f"{tuple(pair_edges.shape)}")
    if alpha:
        _check_masks(alpha_masks, dev)
    h, w = n_tiles_y * sub * TILE_H, n_tiles_x * TILE_W
    if init_depth is not None:
        _require(init_depth, "init_depth", torch.float32, 2, dev)
        if tuple(init_depth.shape) != (h, w):
            raise ValueError(f"init_depth needs ({h}, {w})")
    if not 1 <= sub <= 8:  # the bin heights kernels E and J are tested at
        raise ValueError(f"sub must be in [1, 8], got {sub}")
    if not _kernel_device(pair_edges):
        depth = depth_plain(pair_edges, pairs.tile_start, pairs.tile_count,
                            n_tiles_y, n_tiles_x, sub, row_skip,
                            masks=alpha_masks, init=init_depth)
        return depth if init_depth is None else init_depth.copy_(depth)
    n_bins = n_tiles_y * n_tiles_x
    if not alpha:
        # kernel E: warps take (half strip, pair slice) items from
        # aux[0]; aux[1:] holds each half strip's merge counter and flag,
        # then the bins' order where it does not fit shared memory. It
        # writes every texel, so the atlas needs no zero fill.
        aux = torch.zeros((1 + 4 * n_bins * sub + ORDER_INTS * n_bins,),
                          dtype=torch.int32, device=dev)
        depth = torch.empty((h, w), dtype=torch.float32, device=dev)
        native.launch("depth_launch", pair_edges, pairs.tile_start,
                      pairs.tile_count, aux, depth, pair_edges.shape[1],
                      n_tiles_y, n_tiles_x, sub, int(row_skip))
        return depth
    # kernel J: warps take (16 x 16 block, pair slice) items of the bins
    # with pairs, the first by their index in the grid, then from aux[0],
    # and atomicMax their covered texels onto depth; aux[1:]: the bins'
    # order where it does not fit shared memory
    aux = torch.zeros((1 + ORDER_INTS * n_bins,), dtype=torch.int32,
                      device=dev)
    depth = init_depth
    if depth is None:
        depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
    native.launch("depth_alpha_launch", pair_edges, alpha_masks,
                  pairs.tile_start, pairs.tile_count, aux, depth,
                  pair_edges.shape[1], alpha_masks.shape[0], n_tiles_y,
                  n_tiles_x, sub, int(row_skip))
    return depth


def winner_triangle_ids(vis: torch.Tensor, pairs: PairLists, n_tiles_x: int,
                        sub: int = 1) -> torch.Tensor:
    """Map per-pixel slots back to global triangle ids (-1 uncovered)."""
    h, w = vis.shape
    dev = vis.device
    ty = torch.arange(h, device=dev) // (TILE_H * sub)
    tx = torch.arange(w, device=dev) // TILE_W
    tile = ty[:, None] * n_tiles_x + tx[None, :]
    # vis slots are relative to the group-aligned floor of the segment start
    base = pairs.tile_start[tile] // GROUP * GROUP
    idx = torch.clamp(base + torch.clamp_min(vis, 0), 0,
                      pairs.pair_tri.shape[0] - 1)
    return torch.where(vis >= 0, pairs.pair_tri[idx.long()], -1)


def reference_rasterize(setup_edges: np.ndarray, valid: np.ndarray,
                        width: int, height: int,
                        alpha_masks: np.ndarray | None = None):
    """Brute-force numpy rasterizer with the same rules (reverse-Z max,
    inside = all edges >= 0 at pixel centres; later triangles win ties).
    setup_edges is (3, 4|8, T); with 8 planes and alpha_masks the same
    64x64 nearest-with-wrap alpha test as the kernels is applied
    (raster.py:1948-1985)."""
    xs = np.arange(width) + 0.5
    ys = np.arange(height) + 0.5
    depth = np.zeros((height, width), np.float32)
    winner = np.full((height, width), -1, np.int32)
    a, b, c = setup_edges[0], setup_edges[1], setup_edges[2]
    n_planes = setup_edges.shape[1]
    for t in range(setup_edges.shape[2]):
        if not valid[t]:
            continue
        ex = a[:, t][:, None, None] * xs[None, None, :] + \
            b[:, t][:, None, None] * ys[None, :, None] + c[:, t][:, None, None]
        cov = (ex[0] >= 0) & (ex[1] >= 0) & (ex[2] >= 0)
        cov = cov & (ex[3] > 0) & (ex[3] <= 1.0)
        if n_planes == 8 and alpha_masks is not None:
            slot = int(round(c[7, t]))
            if slot > 0:
                inv = 1.0 / np.where(ex[6] > 1e-12, ex[6], 1.0)
                u = ex[4] * inv
                v = ex[5] * inv
                ix = np.clip((u - np.floor(u)) * 64.0, 0.0, 63.0) \
                    .astype(np.int32)
                iy = np.clip((v - np.floor(v)) * 64.0, 0.0, 63.0) \
                    .astype(np.int32)
                word = alpha_masks[slot - 1][iy * 2 + (ix >= 32)]
                bit = (word >> (ix & 31)) & 1
                cov = cov & (bit == 1)
        z = np.clip(ex[3], 0.0, 1.0)
        upd = cov & (z >= depth)
        depth[upd] = z[upd]
        winner[upd] = t
    return depth, winner
