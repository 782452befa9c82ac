"""Procedural atrium scene (plainrenderer_tpu/assets/procedural.py, numpy).

A copy of the JAX package's deterministic colonnaded hall: floor, walls,
two rows of columns, scattered boxes and hanging banners, each mesh with
procedural checker / brick / marble textures when textured=True (banners
get an alpha-tested lattice). World is y-down (the floor at y = 0,
everything else at negative y). The same config and seed give
bit-identical meshes and texture images on both sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .plain_format import MeshData, ObjectBinary, Scene, TexturePaths
from .textures import MaterialTextures


def _quad(p0, p1, p2, p3, normal, tangent, uv_scale=1.0, subdiv=1):
    """One subdivided quad patch: p0->p1 is the tangent (u) edge, p0->p3 the
    v edge. Returns (positions, normals, tangents, uvs, indices)."""
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    n = subdiv + 1
    us, vs = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="xy")
    u = us.reshape(-1, 1)
    v = vs.reshape(-1, 1)
    pos = (
        p0 * (1 - u) * (1 - v) + p1 * u * (1 - v) + p2 * u * v
        + p3 * (1 - u) * v
    ).astype(np.float32)
    uvs = np.concatenate([us.reshape(-1, 1), vs.reshape(-1, 1)],
                         axis=1) * uv_scale
    normals = np.broadcast_to(np.asarray(normal, np.float32), pos.shape).copy()
    tangents = np.broadcast_to(np.asarray(tangent, np.float32),
                               pos.shape).copy()
    idx = []
    for j in range(subdiv):
        for i in range(subdiv):
            a = j * n + i
            b = j * n + i + 1
            c = (j + 1) * n + i + 1
            d = (j + 1) * n + i
            idx += [a, b, c, a, c, d]
    return (pos, normals, tangents, uvs.astype(np.float32),
            np.asarray(idx, np.uint32))


def _merge(parts):
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    offset = 0
    for p, nrm, t, uv, idx in parts:
        positions.append(p)
        normals.append(nrm)
        tangents.append(t)
        uvs.append(uv)
        indices.append(idx + offset)
        offset += p.shape[0]
    positions = np.concatenate(positions)
    normals = np.concatenate(normals)
    tangents = np.concatenate(tangents)
    bitangents = np.cross(tangents, normals)
    bitangents /= np.maximum(np.linalg.norm(bitangents, axis=-1, keepdims=True),
                             1e-20)
    return MeshData(
        indices=np.concatenate(indices),
        positions=positions,
        normals=normals,
        tangents=tangents,
        bitangents=bitangents,
        uvs=np.concatenate(uvs),
        # non-empty sdf marker (the reference's noSDF tag is an empty path)
        texture_paths=TexturePaths(sdf="procedural://bake"),
        mean_albedo=np.full(3, 0.5, np.float32),
    )


def box_mesh(sx, sy, sz, uv_scale=1.0, subdiv=1) -> MeshData:
    """Axis-aligned box centered at origin, outward normals, per-face UVs,
    counter-clockwise seen from outside in the y-down world."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    parts = [
        # +x
        _quad([hx, hy, -hz], [hx, hy, hz], [hx, -hy, hz], [hx, -hy, -hz],
              [1, 0, 0], [0, 0, 1], uv_scale, subdiv),
        # -x
        _quad([-hx, hy, hz], [-hx, hy, -hz], [-hx, -hy, -hz], [-hx, -hy, hz],
              [-1, 0, 0], [0, 0, -1], uv_scale, subdiv),
        # +y (down in world)
        _quad([-hx, hy, hz], [hx, hy, hz], [hx, hy, -hz], [-hx, hy, -hz],
              [0, 1, 0], [1, 0, 0], uv_scale, subdiv),
        # -y (up in world)
        _quad([-hx, -hy, -hz], [hx, -hy, -hz], [hx, -hy, hz], [-hx, -hy, hz],
              [0, -1, 0], [1, 0, 0], uv_scale, subdiv),
        # +z
        _quad([hx, hy, hz], [-hx, hy, hz], [-hx, -hy, hz], [hx, -hy, hz],
              [0, 0, 1], [-1, 0, 0], uv_scale, subdiv),
        # -z
        _quad([-hx, hy, -hz], [hx, hy, -hz], [hx, -hy, -hz], [-hx, -hy, -hz],
              [0, 0, -1], [1, 0, 0], uv_scale, subdiv),
    ]
    return _merge(parts)


def cylinder_mesh(radius, height, segments=24, rings=4,
                  uv_scale=1.0) -> MeshData:
    """Vertical cylinder (axis = y), base at y=0 extending to y=-height."""
    ang = np.linspace(0, 2 * np.pi, segments + 1)
    ys = np.linspace(0, -height, rings + 1)
    aa, yy = np.meshgrid(ang, ys, indexing="xy")
    nx = np.cos(aa)
    nz = np.sin(aa)
    pos = np.stack([radius * nx, yy, radius * nz], axis=-1).reshape(-1, 3)
    normals = np.stack([nx, np.zeros_like(nx), nz], axis=-1).reshape(-1, 3)
    tangents = np.stack([-nz, np.zeros_like(nx), nx], axis=-1).reshape(-1, 3)
    us = (aa / (2 * np.pi)).reshape(-1, 1)
    vs = (yy / max(height, 1e-6)).reshape(-1, 1)
    uvs = np.concatenate([us, -vs], axis=1) * uv_scale
    n = segments + 1
    idx = []
    for j in range(rings):
        for i in range(segments):
            a = j * n + i
            b = j * n + i + 1
            c = (j + 1) * n + i + 1
            d = (j + 1) * n + i
            idx += [a, c, b, a, d, c]
    parts = [
        (pos.astype(np.float32), normals.astype(np.float32),
         tangents.astype(np.float32), uvs.astype(np.float32),
         np.asarray(idx, np.uint32))
    ]
    return _merge(parts)


@dataclasses.dataclass
class AtriumConfig:
    half_length: float = 12.0  # x extent
    half_width: float = 6.0  # z extent
    height: float = 7.0
    columns_per_row: int = 6
    column_segments: int = 24
    floor_subdiv: int = 8
    box_count: int = 12
    box_subdiv: int = 3
    banner_count: int = 0  # hanging banners (alpha-tested when textured)
    seed: int = 7


def procedural_texture(albedo, kind: str, size: int = 256, seed: int = 0):
    """Deterministic material textures (checker / brick / lattice / marble)
    with a normal map from the height field and an ORM specular map
    (procedural.py:154)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    base = np.asarray(albedo, np.float32)

    if kind == "checker":
        c = (((ys // (size // 8)) + (xs // (size // 8))) % 2).astype(
            np.float32)
        alb = base[None, None, :] * (0.7 + 0.6 * c)[..., None]
        height = c
    elif kind == "brick":
        row = ys // (size // 8)
        xoff = (xs + (row % 2) * (size // 8)) % (size // 4)
        mortar = ((ys % (size // 8)) < 2) | (xoff < 2)
        alb = np.where(mortar[..., None], base * 0.55, base)
        tint = rng.normal(0, 0.05, (8, 4, 1)).astype(np.float32)
        tint_full = np.repeat(np.repeat(tint, size // 8, 0), size // 4, 1)
        alb = np.clip(alb * (1.0 + tint_full[:size, :size]), 0.0, 1.0)
        height = 1.0 - mortar.astype(np.float32)
    elif kind == "lattice":
        # woven fabric with cut-outs: alpha-tested (depthPrepass.frag:28-31)
        fx = np.sin(xs / size * np.pi * 16)
        fy = np.sin(ys / size * np.pi * 16)
        holes = (np.abs(fx) < 0.45) & (np.abs(fy) < 0.45)
        weave = 0.8 + 0.2 * np.sign(fx * fy)
        alb3 = base[None, None, :] * weave[..., None]
        alpha = np.where(holes, 0.0, 1.0).astype(np.float32)
        alb = np.concatenate([alb3, alpha[..., None]], -1)
        height = weave.astype(np.float32) * 0.5
    else:  # marble-ish bands
        p = np.sin(xs / size * 12.0 + 3.0 * np.sin(ys / size * 6.0))
        alb = base[None, None, :] * (0.8 + 0.25 * p)[..., None]
        height = p.astype(np.float32) * 0.5 + 0.5

    # normal map from the height field (central differences)
    gx = np.roll(height, -1, 1) - np.roll(height, 1, 1)
    gy = np.roll(height, -1, 0) - np.roll(height, 1, 0)
    strength = 1.5
    nz = np.ones_like(gx)
    n = np.stack([-gx * strength, -gy * strength, nz], -1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    normal = (n[..., :2] * 0.5 + 0.5).astype(np.float32)
    rough = np.clip(0.75 - 0.35 * height, 0.05, 1.0).astype(np.float32)
    spec = np.stack([np.ones_like(rough), rough,
                     np.zeros_like(rough)], -1)
    return MaterialTextures(albedo=np.clip(alb, 0, 1).astype(np.float32),
                            normal=normal, specular=spec)


def build_atrium_scene(config: AtriumConfig | None = None,
                       textured: bool = True) -> Scene:
    """Deterministic colonnaded-hall scene (the bench/test flagship)."""
    cfg = config or AtriumConfig()
    rng = np.random.default_rng(cfg.seed)
    meshes: list[MeshData] = []
    objects: list[ObjectBinary] = []

    tex_kinds = ("checker", "brick", "marble")

    def add_object(mesh: MeshData, translate, albedo, tex_kind=None):
        mesh.mean_albedo = np.asarray(albedo, np.float32)
        mesh_index = len(meshes)
        if textured:
            mesh.texture_images = procedural_texture(
                albedo, tex_kind or tex_kinds[mesh_index % 3],
                seed=mesh_index)
        meshes.append(mesh)
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = translate
        objects.append(ObjectBinary(model_matrix=m, mesh_index=mesh_index))

    L, W, H = cfg.half_length, cfg.half_width, cfg.height

    # floor slab (top surface at y=0) and ceiling slab
    add_object(box_mesh(2 * L, 0.5, 2 * W, uv_scale=8.0,
                        subdiv=cfg.floor_subdiv),
               [0.0, 0.25, 0.0], [0.46, 0.42, 0.38])
    add_object(box_mesh(2 * L, 0.5, 2 * W, uv_scale=8.0,
                        subdiv=cfg.floor_subdiv),
               [0.0, -H - 0.25, 0.0], [0.5, 0.48, 0.45])
    # long walls (+z / -z) and end walls
    add_object(box_mesh(2 * L, H, 0.4, uv_scale=6.0, subdiv=cfg.floor_subdiv),
               [0.0, -H / 2, W], [0.55, 0.5, 0.42])
    add_object(box_mesh(2 * L, H, 0.4, uv_scale=6.0, subdiv=cfg.floor_subdiv),
               [0.0, -H / 2, -W], [0.55, 0.5, 0.42])
    add_object(box_mesh(0.4, H, 2 * W, uv_scale=6.0, subdiv=cfg.floor_subdiv),
               [-L, -H / 2, 0.0], [0.52, 0.47, 0.4])

    # two rows of columns
    for row_z in (-W * 0.55, W * 0.55):
        for i in range(cfg.columns_per_row):
            x = -L * 0.8 + i * (1.6 * L / max(cfg.columns_per_row - 1, 1))
            col = cylinder_mesh(0.35, H * 0.82, segments=cfg.column_segments,
                                rings=6, uv_scale=2.0)
            add_object(col, [x, 0.0, row_z], [0.62, 0.58, 0.5])
            cap = box_mesh(1.0, 0.35, 1.0, uv_scale=1.0, subdiv=2)
            add_object(cap, [x, -H * 0.82 - 0.17, row_z], [0.6, 0.55, 0.48])

    # scattered boxes (saturated albedos)
    palette = np.asarray(
        [[0.7, 0.15, 0.1], [0.1, 0.5, 0.12], [0.12, 0.2, 0.65],
         [0.65, 0.5, 0.1], [0.5, 0.12, 0.55]], np.float32
    )
    for i in range(cfg.box_count):
        size = float(rng.uniform(0.5, 1.4))
        b = box_mesh(size, size, size, uv_scale=1.0, subdiv=cfg.box_subdiv)
        x = float(rng.uniform(-L * 0.85, L * 0.85))
        z = float(rng.uniform(-W * 0.8, W * 0.8))
        add_object(b, [x, -size / 2, z], palette[i % len(palette)])

    # hanging banners across the hall, double-sided: two opposing quads
    # (alpha-tested lattice when textured)
    for i in range(cfg.banner_count):
        x = -L * 0.7 + i * (1.4 * L / max(cfg.banner_count - 1, 1))
        front = _quad([x, -H * 0.75, -1.2], [x, -H * 0.75, 1.2],
                      [x, -H * 0.2, 1.2], [x, -H * 0.2, -1.2],
                      normal=[1, 0, 0], tangent=[0, 0, 1], uv_scale=1.0,
                      subdiv=4)
        back = _quad([x, -H * 0.75, 1.2], [x, -H * 0.75, -1.2],
                     [x, -H * 0.2, -1.2], [x, -H * 0.2, 1.2],
                     normal=[-1, 0, 0], tangent=[0, 0, -1], uv_scale=1.0,
                     subdiv=4)
        add_object(_merge([front, back]), [0.0, 0.0, 0.0], [0.7, 0.25, 0.2],
                   tex_kind="lattice")

    return Scene(objects=objects, meshes=meshes)

