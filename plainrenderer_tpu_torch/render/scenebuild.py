"""Scene registration: Scene -> flat render arrays (numpy).

Copy of plainrenderer_tpu/render/scenebuild.py: instances are flattened
into UNINDEXED per-corner world-space arrays, one material per mesh becomes
a row of a small constant table, object AABBs drive per-frame frustum
culling, and meshes that carry texture images go into one brick pool
(assets/textures.py). Textures named by file path need the image readers
and raise until the asset slice; the alpha-test tables are built as data
(render_frame refuses them until the alpha-test slice).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..assets import textures as tex_mod
from ..assets.plain_format import MeshData, Scene


@dataclasses.dataclass
class RenderScene:
    """Device-ready scene arrays (numpy; moved to device by the caller)."""

    corners: np.ndarray  # (T, 3, 3) world-space corner positions
    corner_uvs: np.ndarray  # (T, 3, 2)
    corner_normals: np.ndarray  # (T, 3, 3) world-space
    corner_tangents: np.ndarray  # (T, 3, 3)
    corner_bitangents: np.ndarray  # (T, 3, 3)
    tri_material: np.ndarray  # (T,) f32 material id
    tri_object: np.ndarray  # (T,) int32 object id
    tri_alpha_slot: np.ndarray  # (T,) int32 — 0 = opaque
    material_table: np.ndarray  # (M, 8): albedo rgb, roughness, metal, pad
    object_bb_min: np.ndarray  # (O, 3) world AABBs for culling
    object_bb_max: np.ndarray  # (O, 3)
    object_matrices: np.ndarray  # (O, 4, 4) build-time model matrices
    mean_albedo: np.ndarray  # (M, 3) per-material mean albedo
    sdf_paths: list  # per-object SDF volume path ('' if none)
    triangle_count: int
    object_count: int
    mat_tex: np.ndarray | None = None  # (M,) i32 material -> texture (-1)
    tex_info: np.ndarray | None = None  # (n_tex * n_mips, 4) i32
    tex_word0: np.ndarray | None = None  # (NB, 8, 128) i32
    tex_word1: np.ndarray | None = None  # (NB, 8, 128) i32
    alpha_masks: np.ndarray | None = None  # (MAX_ALPHA_MATERIALS, 128) i32


def _mesh_arrays(mesh: MeshData) -> dict:
    return {
        "indices": np.asarray(mesh.indices, np.int64).reshape(-1, 3),
        "positions": np.asarray(mesh.positions, np.float32),
        "uvs": np.asarray(mesh.uvs, np.float32),
        "normals": np.asarray(mesh.normals, np.float32),
        "tangents": np.asarray(mesh.tangents, np.float32),
        "bitangents": np.asarray(mesh.bitangents, np.float32),
    }


DEFAULT_ROUGHNESS = 0.6
DEFAULT_METAL = 0.0
PAD_TRIANGLES_TO = 64


def build_render_scene(scene: Scene) -> RenderScene:
    """Flatten a scene's objects into unindexed world-space corner arrays
    (one material per mesh, constants = mesh mean albedo, roughness 0.6,
    metal 0), padded to a multiple of 64 triangles; textured meshes fill
    the brick pool (scenebuild.py:129-165)."""
    if not all(isinstance(m, MeshData) for m in scene.meshes):
        raise NotImplementedError(
            "quantized .plain meshes: the .plain loader arrives with the "
            "courtyard slice")
    corners, uvs, normals, tangents, bitangents = [], [], [], [], []
    tri_material, tri_object = [], []
    bb_mins, bb_maxs = [], []
    sdf_paths = []
    materials = []
    mean_albedos = []

    mesh_cache = {}
    for obj_index, obj in enumerate(scene.objects):
        mesh = scene.meshes[obj.mesh_index]
        if obj.mesh_index not in mesh_cache:
            mesh_cache[obj.mesh_index] = _mesh_arrays(mesh)
        arrays = mesh_cache[obj.mesh_index]
        m = np.asarray(obj.model_matrix, np.float32)
        rot = m[:3, :3]
        # normal matrix = inverse-transpose (handles non-uniform scale)
        nrm_mat = np.linalg.inv(rot).T

        pos_world = arrays["positions"] @ rot.T + m[:3, 3]
        nrm_world = arrays["normals"] @ nrm_mat.T
        tan_world = arrays["tangents"] @ rot.T
        bit_world = arrays["bitangents"] @ rot.T

        def _unit(v):
            return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                                  1e-20)

        idx = arrays["indices"]
        corners.append(pos_world[idx])
        uvs.append(arrays["uvs"][idx])
        normals.append(_unit(nrm_world)[idx])
        tangents.append(_unit(tan_world)[idx])
        bitangents.append(_unit(bit_world)[idx])

        material_id = len(materials)
        mean_albedo = np.asarray(getattr(mesh, "mean_albedo", [0.5] * 3),
                                 np.float32)
        materials.append(np.concatenate([
            mean_albedo, [DEFAULT_ROUGHNESS, DEFAULT_METAL, 0.0, 0.0, 0.0]
        ]).astype(np.float32))
        mean_albedos.append(mean_albedo)

        t_count = idx.shape[0]
        tri_material.append(np.full(t_count, material_id, np.float32))
        tri_object.append(np.full(t_count, obj_index, np.int32))
        bb_mins.append(pos_world.min(axis=0))
        bb_maxs.append(pos_world.max(axis=0))
        paths = getattr(mesh, "texture_paths", None)
        sdf_paths.append(paths.sdf if paths is not None else "")

    # material textures: one pool entry per unique mesh that carries images
    # or texture paths
    mesh_tex_index: dict[int, int] = {}
    tex_sets: list = []
    for obj in scene.objects:
        mi = obj.mesh_index
        if mi in mesh_tex_index:
            continue
        mesh = scene.meshes[mi]
        images = getattr(mesh, "texture_images", None)
        if images is None:
            paths = getattr(mesh, "texture_paths", None)
            if paths is not None and paths.albedo:
                images = _load_texture_images(paths)
        if images is not None:
            mesh_tex_index[mi] = len(tex_sets)
            tex_sets.append(images)
        else:
            mesh_tex_index[mi] = -1

    mat_tex = np.asarray(
        [mesh_tex_index[obj.mesh_index] for obj in scene.objects], np.int32)
    pool = tex_mod.build_texture_pool(tex_sets) if tex_sets else None

    # per-object alpha-test slot: objects whose texture the pool gave a
    # mask slot alpha-test against alpha_masks[slot - 1]
    obj_slot = []
    for obj in scene.objects:
        ti = mesh_tex_index[obj.mesh_index]
        obj_slot.append(int(pool.alpha_slot[ti])
                        if (pool is not None and ti >= 0) else 0)
    tri_alpha_slot = [np.full(len(tm), obj_slot[oi], np.int32)
                      for oi, tm in enumerate(tri_material)]
    any_alpha = any(s > 0 for s in obj_slot)

    corners = np.concatenate(corners)
    t_count = corners.shape[0]
    pad = (-t_count) % PAD_TRIANGLES_TO

    def _pad(arr, value=0):
        if pad == 0:
            return arr
        shape = (pad,) + arr.shape[1:]
        return np.concatenate([arr, np.full(shape, value, arr.dtype)])

    return RenderScene(
        corners=_pad(corners),
        corner_uvs=_pad(np.concatenate(uvs)),
        corner_normals=_pad(np.concatenate(normals)),
        corner_tangents=_pad(np.concatenate(tangents)),
        corner_bitangents=_pad(np.concatenate(bitangents)),
        tri_material=_pad(np.concatenate(tri_material)),
        tri_object=_pad(np.concatenate(tri_object)),
        tri_alpha_slot=_pad(np.concatenate(tri_alpha_slot)),
        material_table=np.stack(materials),
        object_bb_min=np.stack(bb_mins),
        object_bb_max=np.stack(bb_maxs),
        object_matrices=np.stack([
            np.asarray(obj.model_matrix, np.float32)
            for obj in scene.objects]),
        mean_albedo=np.stack(mean_albedos),
        sdf_paths=sdf_paths,
        triangle_count=t_count,
        object_count=len(scene.objects),
        mat_tex=mat_tex,
        tex_info=pool.info if pool is not None else None,
        tex_word0=pool.word0 if pool is not None else None,
        tex_word1=pool.word1 if pool is not None else None,
        alpha_masks=pool.alpha_masks if (pool is not None and any_alpha)
        else None,
    )


def _load_texture_images(paths):
    """Texture files named by path (scenebuild.py:205) need the image
    readers of the asset slice."""
    raise NotImplementedError(
        f"texture files ({paths.albedo!r}): the image readers arrive with "
        "the asset slice")
