"""Global scene SDF: compositing per-mesh SDF volumes into one world volume
(plainrenderer_tpu/ops/sdf_scene.py).

The reference traces per-instance 3D SDF textures through a bindless
texture array (SDF.inc:103-185). The JAX package composites every
instance's baked SDF into ONE world-space volume plus a mean-albedo volume
at scene registration, at the reference's 0.25 m texel density; the trace
kernel (ops/sdfgi.py) then marches that single volume. The static
composite is host numpy + scipy, copied so that it gives the JAX package's
arrays bit for bit. Dynamic objects are left out of it and recomposited
into a fresh copy of the brick-packed volume every frame, on the device
(recomposite_dynamic, plain PyTorch: the JAX package computes it outside
any Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.aabb import pad_sdf_bounding_box
from ..utils.mathutils import fma_matmul, lu_inverse

VOXEL_SIZE = 0.25  # m/texel, SceneSDF.cpp:122 targetTexelPerMeter


@dataclasses.dataclass
class GlobalSDF:
    volume: np.ndarray  # (D, H, W) f32 signed distance (world units)
    albedo: np.ndarray  # (D, H, W, 3) f32 mean albedo of nearest instance
    origin: np.ndarray  # (3,) world position of voxel (0,0,0) corner
    voxel_size: float


def composite_global_sdf(
    instance_volumes: list,  # per-object (D,H,W) f32 local SDFs (or None)
    instance_bb_min: np.ndarray,  # (O, 3) UNPADDED local AABB min
    instance_bb_max: np.ndarray,  # (O, 3)
    instance_matrices: np.ndarray,  # (O, 4, 4) local->world
    instance_albedo: np.ndarray,  # (O, 3)
    voxel_size: float = VOXEL_SIZE,
    max_dim: int = 320,
    margin: float = 1.0,
) -> GlobalSDF:
    """Min-composite instance SDFs onto a world-aligned grid.

    Each instance's volume is sampled trilinearly at the global voxel
    centers transformed into its local space; voxels outside an
    instance's padded box get a conservative bound (distance to the box
    plus the border sample)."""
    from scipy.ndimage import map_coordinates

    world_mins, world_maxs = [], []
    for o in range(len(instance_volumes)):
        corners = np.stack(np.meshgrid(
            *[(instance_bb_min[o][i], instance_bb_max[o][i])
              for i in range(3)], indexing="ij"), -1).reshape(-1, 3)
        m = instance_matrices[o]
        wc = corners @ m[:3, :3].T + m[:3, 3]
        world_mins.append(wc.min(0))
        world_maxs.append(wc.max(0))
    scene_min = np.min(world_mins, axis=0) - margin
    scene_max = np.max(world_maxs, axis=0) + margin

    size = scene_max - scene_min
    res = np.ceil(size / voxel_size).astype(int)
    res = np.minimum(res, max_dim)
    # grid is (D=z, H=y, W=x)
    w, h, d = int(res[0]), int(res[1]), int(res[2])
    actual_voxel = float(np.max(size / np.asarray([w, h, d], np.float64)))
    voxel_size = max(voxel_size, actual_voxel)

    xs = scene_min[0] + (np.arange(w) + 0.5) * voxel_size
    ys = scene_min[1] + (np.arange(h) + 0.5) * voxel_size
    zs = scene_min[2] + (np.arange(d) + 0.5) * voxel_size

    global_sdf = np.full((d, h, w), 1e4, np.float32)
    global_albedo = np.full((d, h, w, 3), 0.5, np.float32)

    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    world_pts = np.stack([xx, yy, zz], -1)  # (d, h, w, 3)

    for o, vol in enumerate(instance_volumes):
        if vol is None:
            continue
        m = np.asarray(instance_matrices[o], np.float32)
        inv = np.linalg.inv(m)
        scale = float(np.cbrt(abs(np.linalg.det(m[:3, :3]))))
        pad_min, pad_max = pad_sdf_bounding_box(instance_bb_min[o],
                                                instance_bb_max[o])

        # the instance's world region plus a ring that receives the
        # conservative distance-to-box bound, so sphere tracing near (but
        # outside) the instance cannot overstep
        corners = np.stack(np.meshgrid(
            *[(pad_min[i], pad_max[i]) for i in range(3)], indexing="ij"),
            -1).reshape(-1, 3)
        wc = corners @ m[:3, :3].T + m[:3, 3]
        safety = 2.0  # meters of conservative-bound ring
        lo = np.floor((wc.min(0) - safety - scene_min)
                      / voxel_size).astype(int)
        hi = np.ceil((wc.max(0) + safety - scene_min)
                     / voxel_size).astype(int) + 1
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, [w, h, d])
        if (hi <= lo).any():
            continue
        sub = world_pts[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]]
        local = sub @ inv[:3, :3].T + inv[:3, 3]  # (sd, sh, sw, 3)

        vd, vh, vw = vol.shape
        ext = pad_max - pad_min
        # voxel-center grid coords of the instance volume
        cx = (local[..., 0] - pad_min[0]) / ext[0] * vw - 0.5
        cy = (local[..., 1] - pad_min[1]) / ext[1] * vh - 0.5
        cz = (local[..., 2] - pad_min[2]) / ext[2] * vd - 0.5
        coords = np.stack([cz, cy, cx], 0)
        sampled = map_coordinates(vol, coords.reshape(3, -1), order=1,
                                  mode="nearest").reshape(local.shape[:-1])
        sampled = sampled * scale  # local distances -> world (uniform scale)

        # conservative bound outside the padded box
        q = np.maximum(np.maximum(pad_min - local, local - pad_max), 0.0)
        outside = np.linalg.norm(q, axis=-1) * scale
        candidate = (sampled + outside).astype(np.float32)

        region = global_sdf[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]]
        closer = candidate < region
        region[closer] = candidate[closer]
        global_sdf[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] = region
        alb = global_albedo[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]]
        alb[closer] = instance_albedo[o]
        global_albedo[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] = alb

    global_sdf = np.clip(global_sdf, -32.0, 1e4)
    return GlobalSDF(volume=global_sdf, albedo=global_albedo,
                     origin=scene_min.astype(np.float32),
                     voxel_size=voxel_size)


@dataclasses.dataclass
class DynamicSDFSet:
    """Per-dynamic-instance data for the on-device recomposite."""

    volumes: list  # K x (vd, vh, vw) f32 local SDFs (padded-box extent)
    pad_min: np.ndarray  # (K, 3) padded local AABB min
    pad_max: np.ndarray  # (K, 3)
    albedo: np.ndarray  # (K, 3) mean albedo
    object_index: np.ndarray  # (K,) index into the objects / transforms
    window_vox: list  # K x (wd, wh, ww) static window size in voxels


def _trilinear3d(vol, cz, cy, cx):
    """Clamped trilinear sample of volumes (G, vd, vh, vw) f32 at
    fractional voxel coords (G, ...) (map_coordinates order=1
    mode='nearest', sdf_scene.py:172), each of the G volumes at its own
    coords."""
    g, vd, vh, vw = vol.shape
    cz = torch.clamp(cz, 0.0, vd - 1.0)
    cy = torch.clamp(cy, 0.0, vh - 1.0)
    cx = torch.clamp(cx, 0.0, vw - 1.0)
    z0, y0, x0 = (torch.floor(c).long() for c in (cz, cy, cx))
    z1 = torch.clamp(z0 + 1, max=vd - 1)
    y1 = torch.clamp(y0 + 1, max=vh - 1)
    x1 = torch.clamp(x0 + 1, max=vw - 1)
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    flat = vol.reshape(g, -1)

    def at(z, y, x):
        idx = ((z * vh + y) * vw + x).reshape(g, -1)
        return torch.gather(flat, 1, idx).reshape(z.shape)

    c00 = at(z0, y0, x0) + (at(z0, y0, x1) - at(z0, y0, x0)) * fx
    c01 = at(z0, y1, x0) + (at(z0, y1, x1) - at(z0, y1, x0)) * fx
    c10 = at(z1, y0, x0) + (at(z1, y0, x1) - at(z1, y0, x0)) * fx
    c11 = at(z1, y1, x0) + (at(z1, y1, x1) - at(z1, y1, x0)) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def _det3(a):
    """jnp.linalg.det's closed form for a 3x3 matrix (3, 3, ...)."""
    return (a[0, 0] * a[1, 1] * a[2, 2] + a[0, 1] * a[1, 2] * a[2, 0]
            + a[0, 2] * a[1, 0] * a[2, 1] - a[0, 2] * a[1, 1] * a[2, 0]
            - a[0, 0] * a[1, 2] * a[2, 1] - a[0, 1] * a[1, 0] * a[2, 2])


def _window_candidates(vols, windows, grid_bricks, origin, voxel_size,
                       invs, scales, rels, pad_min, pad_max):
    """The instances' candidate distances over their windows, for G
    instances whose volumes (G, vd, vh, vw) and windows (wd, wh, ww) have
    one shape: (brick ids (G, window bricks), world distances (G, wd, wh,
    ww)). The window starts at the brick-aligned corner around the
    instance's centre (rels, in voxels), clipped inside the grid; its
    voxel centres go through the instance's inverse model matrix into the
    local volume, sampled trilinearly, plus the distance outside the
    padded box, scaled to world units (sdf_scene.py:238-269)."""
    from .sdfgi import BRICK as bk

    g, vd, vh, vw = vols.shape
    wd, wh, ww = windows
    nbz, nby, nbx = grid_bricks
    nwz, nwy, nwx = wd // bk, wh // bk, ww // bk
    dev = vols.device

    def b(x):  # (G,) -> (G, 1, 1, 1)
        return x.reshape(g, 1, 1, 1)

    # per axis, as a host-made (3,) tensor would be a copy that waits
    sb = torch.stack([
        torch.clamp(torch.floor((rels[:, i] - n * 0.5) / bk), 0, hi)
        for i, (n, hi) in enumerate(((ww, nbx - nwx), (wh, nby - nwy),
                                     (wd, nbz - nwz)))], dim=1).to(
        torch.int64)  # (G, 3) xyz bricks
    sv = (sb * bk).to(torch.float32)
    iz = torch.arange(wd, dtype=torch.float32, device=dev)[:, None, None]
    iy = torch.arange(wh, dtype=torch.float32, device=dev)[None, :, None]
    ix = torch.arange(ww, dtype=torch.float32, device=dev)[None, None, :]
    wx = origin[0] + (b(sv[:, 0]) + ix + 0.5) * voxel_size
    wy = origin[1] + (b(sv[:, 1]) + iy + 0.5) * voxel_size
    wz = origin[2] + (b(sv[:, 2]) + iz + 0.5) * voxel_size

    def local(r):
        return (b(invs[:, r, 0]) * wx + b(invs[:, r, 1]) * wy
                + b(invs[:, r, 2]) * wz + b(invs[:, r, 3]))

    lx, ly, lz = local(0), local(1), local(2)
    pmin = [b(pad_min[:, i]) for i in range(3)]
    pmax = [b(pad_max[:, i]) for i in range(3)]
    ext = [b((pad_max - pad_min)[:, i]) for i in range(3)]
    sampled = _trilinear3d(
        vols, (lz - pmin[2]) / ext[2] * vd - 0.5,
        (ly - pmin[1]) / ext[1] * vh - 0.5,
        (lx - pmin[0]) / ext[0] * vw - 0.5)
    q = [torch.clamp(torch.maximum(pmin[i] - c, c - pmax[i]), min=0.0)
         for i, c in enumerate((lx, ly, lz))]
    outside = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2])
    cand = (sampled + outside) * b(scales)
    bz = torch.arange(nwz, device=dev)[:, None, None]
    by = torch.arange(nwy, device=dev)[None, :, None]
    bx = torch.arange(nwx, device=dev)[None, None, :]
    bid = (((b(sb[:, 2]) + bz) * nby + b(sb[:, 1]) + by) * nbx
           + b(sb[:, 0]) + bx).reshape(g, -1)
    return bid, cand


def recomposite_dynamic(packed_vol, packed_alb, origin, voxel_size: float,
                        dims_zyx: tuple, dyn_vols: list, dyn_windows,
                        pad_min, pad_max, dyn_albedo, dyn_obj, transforms):
    """Per-frame dynamic-instance update of the brick-packed global SDF
    (sdf_scene.py:206 recomposite_dynamic), on the device.

    packed_vol (NB, 8, 128) i32 / packed_alb (NB, 32, 128) i32 are the
    PRISTINE static composite in ops/sdfgi's brick format and are never
    written: the instances composite into fresh copies, which are
    returned. For each dynamic instance k, a brick-aligned window of
    dyn_windows[k] = (wd, wh, ww) voxels around the instance's centre is
    gathered, unpacked to world distances, min-composited with the
    instance's local SDF dyn_vols[k] sampled through its model matrix
    transforms[dyn_obj[k]], requantized (round half to even, as jnp.round)
    and scattered back; the albedo takes the instance's where it is
    closer. The window start stays on the device (no host sync).
    jnp.cbrt has no torch counterpart: the uniform scale is |det|^(1/3)
    taken in f64 and rounded, within 1 f32 ulp of cbrt.

    The same arithmetic as the JAX function, batched where it does not
    change a bit: the instances' matrix work, and their candidate
    distances for instances of one volume and window shape
    (_window_candidates); the composite itself stays instance by
    instance, in order, since windows overlap."""
    from .sdfgi import _SDF_SCALE, BRICK, _const

    d, h, w = dims_zyx
    bk = BRICK
    dev = packed_vol.device
    vol_out, alb_out = packed_vol.clone(), packed_alb.clone()
    mats = transforms.index_select(0, dyn_obj.long())  # (K, 4, 4)
    invs = lu_inverse(mats)
    m3 = mats[:, :3, :3]
    scales = torch.abs(_det3(m3.permute(1, 2, 0))).double().pow(
        1.0 / 3.0).float()
    ctrs = (pad_min + pad_max) * 0.5
    rels = (fma_matmul(m3, ctrs[:, :, None])[..., 0] + mats[:, :3, 3]
            - origin) / voxel_size
    groups = {}
    for k, vol_l in enumerate(dyn_vols):
        groups.setdefault((tuple(vol_l.shape), tuple(dyn_windows[k])),
                          []).append(k)
    cands = {}
    for (_, window), ks in groups.items():
        def pick(x):
            return torch.stack([x[k] for k in ks])
        bid, cand = _window_candidates(
            torch.stack([dyn_vols[k] for k in ks]), window,
            (d // bk, h // bk, w // bk), origin, voxel_size, pick(invs),
            pick(scales), pick(rels), pick(pad_min), pick(pad_max))
        cands.update({k: (bid[j], cand[j]) for j, k in enumerate(ks)})
    vs = _const(voxel_size, dev)
    aq = torch.clamp(torch.round(dyn_albedo * 255.0), 0, 255).to(torch.int32)
    awords = aq[:, 0] | (aq[:, 1] << 8) | (aq[:, 2] << 16)
    for k in range(len(dyn_vols)):
        bid, cand = cands[k]
        wd, wh, ww = dyn_windows[k]
        nwz, nwy, nwx = wd // bk, wh // bk, ww // bk

        # distance volume
        wspl = vol_out.index_select(0, bid).reshape(-1, bk, bk, bk // 4)
        vox8 = torch.stack([(wspl >> (8 * b)) & 0xFF for b in range(4)],
                           dim=-1).reshape(-1, bk, bk, bk)
        sgn = torch.where(vox8 > 127, vox8 - 256, vox8).to(torch.float32)
        bg = (sgn / _SDF_SCALE * voxel_size).reshape(nwz, nwy, nwx, bk, bk,
                                                     bk)
        bg = bg.permute(0, 3, 1, 4, 2, 5).reshape(wd, wh, ww)
        closer = cand < bg
        new = torch.minimum(bg, cand)
        q = torch.clamp(torch.round(new / vs * _SDF_SCALE),
                        -127, 127).to(torch.int32) & 0xFF
        qb = q.reshape(nwz, bk, nwy, bk, nwx, bk // 4, 4).permute(
            0, 2, 4, 1, 3, 5, 6)
        nwords = (qb[..., 0] | (qb[..., 1] << 8) | (qb[..., 2] << 16)
                  | (qb[..., 3] << 24))
        vol_out.index_copy_(0, bid, nwords.reshape(-1, 8, 128))

        # albedo volume (winner-takes on `closer`)
        av = alb_out.index_select(0, bid).reshape(nwz, nwy, nwx, bk, bk, bk)
        av = av.permute(0, 3, 1, 4, 2, 5).reshape(wd, wh, ww)
        anew = torch.where(closer, awords[k], av)
        ab = anew.reshape(nwz, bk, nwy, bk, nwx, bk).permute(0, 2, 4, 1, 3, 5)
        alb_out.index_copy_(0, bid, ab.reshape(-1, 32, 128))
    return vol_out, alb_out


def build_scene_sdf(render_scene, scene, voxel_size: float = VOXEL_SIZE,
                    bake_resolution_cap: int | None = None,
                    device="cuda", dynamic_objects: tuple = ()):
    """Bake per-object SDFs (assets.sdf_bake, on `device`) and composite
    them on the host.

    render_scene: scenebuild.RenderScene; scene: the source Scene (for
    mesh geometry). Objects whose mesh has an empty SDF path are skipped
    (the noSDF tag, ModelImport.cpp:237-253). Each mesh is baked once
    however many objects use it.

    dynamic_objects: object indices left out of the static composite;
    when non-empty, returns (GlobalSDF, DynamicSDFSet) (sdf_scene.py:318):
    attach the set with render/frame.attach_dynamic_sdf and pass per-frame
    model matrices as scene["object_transforms"]."""
    from ..assets.sdf_bake import bake_mesh_sdf, sdf_resolution_for_aabb
    from ..render.scenebuild import _mesh_arrays

    volumes = []
    bb_mins, bb_maxs, mats, albedos = [], [], [], []
    mesh_cache = {}
    for obj in scene.objects:
        mesh = scene.meshes[obj.mesh_index]
        paths = getattr(mesh, "texture_paths", None)
        skip = paths is not None and not paths.sdf
        if obj.mesh_index not in mesh_cache and not skip:
            arrays = _mesh_arrays(mesh)
            bb_min = arrays["positions"].min(0)
            bb_max = arrays["positions"].max(0)
            res = sdf_resolution_for_aabb(bb_min, bb_max)
            if bake_resolution_cap:
                res = tuple(min(r, bake_resolution_cap) for r in res)
            vol = bake_mesh_sdf(arrays["positions"], arrays["indices"],
                                bb_min, bb_max, resolution=res,
                                device=device)
            mesh_cache[obj.mesh_index] = (vol, bb_min, bb_max)
        if skip:
            volumes.append(None)
            bb_mins.append(np.zeros(3, np.float32))
            bb_maxs.append(np.ones(3, np.float32))
        else:
            vol, bb_min, bb_max = mesh_cache[obj.mesh_index]
            volumes.append(vol)
            bb_mins.append(bb_min)
            bb_maxs.append(bb_max)
        mats.append(np.asarray(obj.model_matrix, np.float32))
        albedos.append(np.asarray(mesh.mean_albedo, np.float32))
    dyn = set(int(i) for i in dynamic_objects)
    gsdf = composite_global_sdf(
        [None if o in dyn else v for o, v in enumerate(volumes)],
        np.stack(bb_mins), np.stack(bb_maxs), np.stack(mats),
        np.stack(albedos), voxel_size=voxel_size)
    if not dyn:
        return gsdf

    d_vols, d_pmin, d_pmax, d_alb, d_obj, d_win = [], [], [], [], [], []
    safety = 2.0  # the static composite's conservative-bound ring
    for o in sorted(dyn):
        if volumes[o] is None:
            continue  # noSDF meshes contribute nothing when moved, either
        pmin, pmax = pad_sdf_bounding_box(bb_mins[o], bb_maxs[o])
        pmin = np.asarray(pmin, np.float32)
        pmax = np.asarray(pmax, np.float32)
        # static window: the rotated padded box always fits in its
        # diagonal, so a diag + 2 * safety cube of bricks covers every
        # orientation, never larger than the brick-padded grid
        diag = float(np.linalg.norm(pmax - pmin))
        scale = float(np.cbrt(abs(np.linalg.det(
            np.asarray(mats[o])[:3, :3]))))
        side = diag * max(scale, 1.0) + 2.0 * safety
        nvox = int(np.ceil(side / gsdf.voxel_size)) + 16
        nvox = (nvox + 15) // 16 * 16
        grid_pad = [max(32, (n + 15) // 16 * 16) for n in gsdf.volume.shape]
        d_vols.append(np.asarray(volumes[o], np.float32))
        d_pmin.append(pmin)
        d_pmax.append(pmax)
        d_alb.append(albedos[o])
        d_obj.append(o)
        d_win.append(tuple(min(nvox, g) for g in grid_pad))
    return gsdf, DynamicSDFSet(
        volumes=d_vols, pad_min=np.stack(d_pmin), pad_max=np.stack(d_pmax),
        albedo=np.stack(d_alb), object_index=np.asarray(d_obj, np.int32),
        window_vox=d_win)
