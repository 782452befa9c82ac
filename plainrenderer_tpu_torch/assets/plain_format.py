"""Scene data types of the .plain format (plainrenderer_tpu/assets/
plain_format.py:45-108).

Only the full-precision dataclasses the procedural scene needs. The .plain
reader and writer (quantized MeshBinary/SceneBinary) arrive with the
courtyard slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TexturePaths:
    """Common/MeshData.h:6-11."""

    albedo: str = ""
    normal: str = ""
    specular: str = ""
    sdf: str = ""


@dataclasses.dataclass
class MeshData:
    """Common/MeshData.h:13-23 — full-precision mesh, importer output."""

    indices: np.ndarray  # (I,) uint32
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 3) f32
    bitangents: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    texture_paths: TexturePaths = dataclasses.field(default_factory=TexturePaths)
    mean_albedo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 0.5, np.float32))
    # in-memory texture images (textured scenes: the texture slice)
    texture_images: object = None


@dataclasses.dataclass
class ObjectBinary:
    """Common/Scene.h:6-9."""

    model_matrix: np.ndarray  # (4, 4) f32 row-major in memory here
    mesh_index: int


@dataclasses.dataclass
class Scene:
    """Common/Scene.h:11-14 — full-precision scene (importer output)."""

    objects: list  # ObjectBinary
    meshes: list  # MeshData
