"""The .plain binary scene format, byte-compatible with the reference
(a copy of plainrenderer_tpu/assets/plain_format.py: the same file loads to
the same arrays and saves to the same bytes, tests/test_torch_assets.py).

Parity: Plain/src/Common/ModelLoadSaveBinary.cpp. File layout (little-endian,
matching the reference's raw-struct writes including MSVC x64 padding):

  ModelFileHeader (24 bytes):
    u32 magic 'PlMB' | 4 pad | u64 objectCount | u64 meshCount
  objectCount x ObjectBinary (72 bytes):
    f32[16] modelMatrix (glm column-major) | u64 meshIndex
  meshCount x mesh:
    u32 indexCount | u32 vertexCount | f32[6] AABB min/max
    u32 albedoPathLen | chars | u32 normalPathLen | chars
    u32 specularPathLen | chars | u32 sdfPathLen | chars
    f32[3] meanAlbedo
    indices (u16 if indexCount < 65535 else u32)
    vertexCount x 28-byte vertex (pos f32x3 | uv f16x2 | nrm/tan/bitan
    R10G10B10A2, MeshProcessing.cpp:14-113)
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from . import compressed

MAGIC = int.from_bytes(b"PlMB", "little")
VERTEX_BYTE_SIZE = 28  # VertexInput.h:39-45

_VERTEX_DTYPE = np.dtype(
    [
        ("position", np.float32, 3),
        ("uv", np.float16, 2),
        ("normal", np.uint32),
        ("tangent", np.uint32),
        ("bitangent", np.uint32),
    ]
)
assert _VERTEX_DTYPE.itemsize == VERTEX_BYTE_SIZE


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
    # in-memory texture images (procedural scenes / pre-loaded imports);
    # NOT serialized to .plain: the binary format carries paths only
    texture_images: object = None  # assets.textures.MaterialTextures | None


@dataclasses.dataclass
class MeshBinary:
    """Common/MeshData.h:26-35 — quantized mesh as stored on disk."""

    index_count: int
    vertex_count: int
    bb_min: np.ndarray  # (3,) f32
    bb_max: np.ndarray  # (3,) f32
    texture_paths: TexturePaths
    mean_albedo: np.ndarray  # (3,) f32
    index_buffer: np.ndarray  # uint16 or uint32
    vertex_buffer: np.ndarray  # (V,) _VERTEX_DTYPE


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


@dataclasses.dataclass
class SceneBinary:
    """Common/Scene.h:16-18 — quantized scene (disk format)."""

    objects: list  # ObjectBinary
    meshes: list  # MeshBinary


def scene_to_binary(scene: Scene) -> SceneBinary:
    """MeshProcessing.cpp:14-113 applied over the whole scene."""
    return SceneBinary(
        objects=list(scene.objects),
        meshes=[mesh_data_to_binary(m) for m in scene.meshes],
    )


def mesh_data_to_binary(mesh: MeshData) -> MeshBinary:
    """MeshProcessing.cpp:14-113 — quantize one mesh (vectorized)."""
    index_count = int(mesh.indices.shape[0])
    if index_count < 0xFFFF:
        index_buffer = mesh.indices.astype(np.uint16)
    else:
        index_buffer = mesh.indices.astype(np.uint32)
    v = np.zeros(mesh.positions.shape[0], _VERTEX_DTYPE)
    v["position"] = mesh.positions.astype(np.float32)
    v["uv"] = mesh.uvs.astype(np.float16)
    v["normal"] = compressed.vec3_to_r10g10b10a2(mesh.normals)
    v["tangent"] = compressed.vec3_to_r10g10b10a2(mesh.tangents)
    v["bitangent"] = compressed.vec3_to_r10g10b10a2(mesh.bitangents)
    return MeshBinary(
        index_count=index_count,
        vertex_count=int(mesh.positions.shape[0]),
        bb_min=mesh.positions.min(axis=0).astype(np.float32),
        bb_max=mesh.positions.max(axis=0).astype(np.float32),
        texture_paths=mesh.texture_paths,
        mean_albedo=np.asarray(mesh.mean_albedo, np.float32),
        index_buffer=index_buffer,
        vertex_buffer=v,
    )


def mesh_binary_to_arrays(mesh: MeshBinary) -> dict:
    """Dequantize a MeshBinary into f32 planar arrays for the TPU geometry
    stage (inverse of MeshProcessing.cpp; the reference leaves this to Vulkan
    vertex fetch hardware)."""
    v = mesh.vertex_buffer
    return {
        "indices": mesh.index_buffer.astype(np.int32).reshape(-1, 3),
        "positions": v["position"].astype(np.float32),
        "uvs": v["uv"].astype(np.float32),
        "normals": compressed.r10g10b10a2_to_vec3(v["normal"]),
        "tangents": compressed.r10g10b10a2_to_vec3(v["tangent"]),
        "bitangents": compressed.r10g10b10a2_to_vec3(v["bitangent"]),
    }


def _write_path(out: bytearray, path: str):
    encoded = path.encode("utf-8")
    out += struct.pack("<I", len(encoded))
    out += encoded


def save_binary_scene(filename: str | Path, scene: SceneBinary) -> None:
    """ModelLoadSaveBinary.cpp:40-140."""
    out = bytearray()
    out += struct.pack("<I4xQQ", MAGIC, len(scene.objects), len(scene.meshes))
    for obj in scene.objects:
        # glm stores column-major; our matrices are row-major -> transpose.
        m = np.asarray(obj.model_matrix, np.float32).T
        out += m.tobytes()
        out += struct.pack("<Q", obj.mesh_index)
    for mesh in scene.meshes:
        out += struct.pack("<II", mesh.index_count, mesh.vertex_count)
        out += np.asarray(mesh.bb_min, np.float32).tobytes()
        out += np.asarray(mesh.bb_max, np.float32).tobytes()
        _write_path(out, mesh.texture_paths.albedo)
        _write_path(out, mesh.texture_paths.normal)
        _write_path(out, mesh.texture_paths.specular)
        _write_path(out, mesh.texture_paths.sdf)
        out += np.asarray(mesh.mean_albedo, np.float32).tobytes()
        out += mesh.index_buffer.tobytes()
        out += mesh.vertex_buffer.tobytes()
    Path(filename).write_bytes(bytes(out))


def load_binary_scene(filename: str | Path) -> SceneBinary:
    """ModelLoadSaveBinary.cpp:142-239."""
    data = Path(filename).read_bytes()
    magic, object_count, mesh_count = struct.unpack_from("<I4xQQ", data, 0)
    if magic != MAGIC:
        raise ValueError(f"not a .plain scene (bad magic) in {filename}")
    offset = 24

    objects = []
    for _ in range(object_count):
        m = np.frombuffer(data, np.float32, 16, offset).reshape(4, 4).T.copy()
        offset += 64
        (mesh_index,) = struct.unpack_from("<Q", data, offset)
        offset += 8
        objects.append(ObjectBinary(model_matrix=m, mesh_index=mesh_index))

    meshes = []
    for _ in range(mesh_count):
        index_count, vertex_count = struct.unpack_from("<II", data, offset)
        offset += 8
        bb = np.frombuffer(data, np.float32, 6, offset)
        offset += 24
        paths = []
        for _ in range(4):
            (n,) = struct.unpack_from("<I", data, offset)
            offset += 4
            paths.append(data[offset:offset + n].decode("utf-8"))
            offset += n
        mean_albedo = np.frombuffer(data, np.float32, 3, offset).copy()
        offset += 12
        idx_dtype = np.uint16 if index_count < 0xFFFF else np.uint32
        index_buffer = np.frombuffer(data, idx_dtype, index_count, offset).copy()
        offset += index_buffer.nbytes
        vertex_buffer = np.frombuffer(data, _VERTEX_DTYPE, vertex_count, offset).copy()
        offset += vertex_buffer.nbytes
        meshes.append(
            MeshBinary(
                index_count=index_count,
                vertex_count=vertex_count,
                bb_min=bb[:3].copy(),
                bb_max=bb[3:].copy(),
                texture_paths=TexturePaths(*paths),
                mean_albedo=mean_albedo,
                index_buffer=index_buffer,
                vertex_buffer=vertex_buffer,
            )
        )
    return SceneBinary(objects=objects, meshes=meshes)
