"""Global scene SDF: compositing per-mesh SDF volumes into one world volume
(plainrenderer_tpu/ops/sdf_scene.py, the static-scene part).

The reference traces per-instance 3D SDF textures through a bindless
texture array (SDF.inc:103-185). The JAX package composites every
instance's baked SDF into ONE world-space volume plus a mean-albedo volume
at scene registration, at the reference's 0.25 m texel density; the trace
kernel (ops/sdfgi.py) then marches that single volume. The composite is
host numpy + scipy, copied so that it gives the JAX package's arrays bit
for bit. The per-frame on-device recomposite of dynamic objects is not in
this port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..scene.aabb import pad_sdf_bounding_box

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


def build_scene_sdf(render_scene, scene, voxel_size: float = VOXEL_SIZE,
                    bake_resolution_cap: int | None = None,
                    device="cuda") -> GlobalSDF:
    """Bake per-object SDFs (assets.sdf_bake, on `device`) and composite
    them on the host.

    render_scene: scenebuild.RenderScene; scene: the source Scene (for
    mesh geometry). Objects whose mesh has an empty SDF path are skipped
    (the noSDF tag, ModelImport.cpp:237-253). Each mesh is baked once
    however many objects use it."""
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
    return composite_global_sdf(
        volumes, np.stack(bb_mins), np.stack(bb_maxs), np.stack(mats),
        np.stack(albedos), voxel_size=voxel_size)
