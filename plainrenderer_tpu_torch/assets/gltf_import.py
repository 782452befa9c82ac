"""glTF 2.0 scene importer (a copy of plainrenderer_tpu/assets/
gltf_import.py).

Parity: AssetPipeline/ModelImport.cpp (tinygltf replaced by a direct JSON +
binary-buffer parser; no third-party glTF package is available).

Reference semantics kept exactly (they define how existing .plain scenes were
produced, so they matter for scene compatibility):
  - requires POSITION / NORMAL / TANGENT / TEXCOORD_0 (ModelImport.cpp:149-157);
  - bitangent = normalize(cross(tangent, normal)) computed BEFORE the y-flip
    (ModelImport.cpp:180-186, a quirk preserved deliberately);
  - coordinate correction: positions.y *= -1, normals.y *= -1
    (ModelImport.cpp:187-194), node matrices conjugated c*M*c with
    c = diag(1,-1,1,1) (ModelImport.cpp:290-308);
  - mean albedo = alpha-weighted average of the 8-bit base-color texture
    (ModelImport.cpp:78-112), read with the port's own PNG reader
    (assets/image_io.py) and summed as the JAX package sums it, so the
    .plain bytes match;
  - mesh.extras.noSDF skips the SDF path (ModelImport.cpp:237-253);
  - sdf path = <modelDir>/sdfTextures/<meshName>[_<prim>].dds.

Extensions beyond the reference (no compat impact): .glb container,
u8/u16/u32 indices, strided buffer views, node.matrix.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from .plain_format import MeshData, ObjectBinary, Scene, TexturePaths

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfFile:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        if self.path.suffix.lower() == ".glb":
            blob = self.path.read_bytes()
            magic, _version, _length = struct.unpack_from("<III", blob, 0)
            if magic != 0x46546C67:
                raise ValueError(f"bad glb magic in {path}")
            offset = 12
            self.json = None
            self._bin_chunk = b""
            while offset < len(blob):
                chunk_len, chunk_type = struct.unpack_from("<II", blob, offset)
                offset += 8
                data = blob[offset:offset + chunk_len]
                offset += chunk_len
                if chunk_type == 0x4E4F534A:  # JSON
                    self.json = json.loads(data)
                elif chunk_type == 0x004E4942:  # BIN
                    self._bin_chunk = data
            if self.json is None:
                raise ValueError(f"glb without JSON chunk: {path}")
        else:
            self.json = json.loads(self.path.read_text())
            self._bin_chunk = b""
        self._buffers: dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        if index not in self._buffers:
            buf = self.json["buffers"][index]
            uri = buf.get("uri")
            if uri is None:
                self._buffers[index] = self._bin_chunk
            elif uri.startswith("data:"):
                import base64

                self._buffers[index] = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                self._buffers[index] = (self.path.parent / unquote(uri)).read_bytes()
        return self._buffers[index]

    def accessor(self, index: int) -> np.ndarray:
        """Accessor -> (count, components) array (ModelImport.cpp:36-55,
        extended with byteStride/byteOffset support)."""
        acc = self.json["accessors"][index]
        view = self.json["bufferViews"][acc["bufferView"]]
        data = self.buffer(view["buffer"])
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
        n_comp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", 0)
        item_size = dtype.itemsize * n_comp
        if stride in (0, item_size):
            arr = np.frombuffer(data, dtype, count * n_comp, start)
            return arr.reshape(count, n_comp).copy()
        out = np.empty((count, n_comp), dtype)
        for i in range(count):
            out[i] = np.frombuffer(data, dtype, n_comp, start + i * stride)
        return out


def _node_matrix(node: dict) -> np.ndarray:
    """ModelImport.cpp:60-76: T*R*S (plus glTF node.matrix support)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(np.asarray(list(node["scale"]) + [1.0], np.float32))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        rm = np.eye(4, dtype=np.float32)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4, dtype=np.float32)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _compute_mean_albedo(image_path: Path) -> np.ndarray:
    """ModelImport.cpp:78-112: alpha-weighted mean of the base color; 0.5
    grey when the image does not load (gltf_import.py:131-143)."""
    from .image_io import load_image

    try:
        arr = np.asarray(load_image(image_path), np.float32)
    except (OSError, ValueError):
        return np.full(3, 0.5, np.float32)
    alpha = arr[..., 3:4] / 255.0
    weighted = (arr[..., :3] * alpha).sum(axis=(0, 1))
    n = arr.shape[0] * arr.shape[1]
    return (weighted / 255.0 / n).astype(np.float32)


def load_model_gltf(filename: str | Path) -> Scene:
    """ModelImport.cpp:114-316: glTF -> Scene (full-precision MeshData list +
    flattened ObjectBinary list with y-flip-conjugated model matrices)."""
    gltf = GltfFile(filename)
    doc = gltf.json
    model_dir = Path(filename).parent

    meshes: list[MeshData] = []
    per_mesh_primitives: list[list[int]] = []

    for mesh in doc.get("meshes", []):
        primitive_list: list[int] = []
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            for required in ("POSITION", "NORMAL", "TANGENT", "TEXCOORD_0"):
                if required not in attrs:
                    raise ValueError(
                        f"primitive missing attribute {required} in {filename}"
                    )
            positions = gltf.accessor(attrs["POSITION"]).astype(np.float32)
            normals = gltf.accessor(attrs["NORMAL"]).astype(np.float32)
            tangents4 = gltf.accessor(attrs["TANGENT"]).astype(np.float32)
            uvs = gltf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            tangents = tangents4[:, :3]

            # bitangent from UNFLIPPED normal/tangent (reference quirk,
            # ModelImport.cpp:180-186)
            bitangents = np.cross(tangents, normals)
            bitangents /= np.maximum(
                np.linalg.norm(bitangents, axis=-1, keepdims=True), 1e-20
            )

            positions = positions.copy()
            normals = normals.copy()
            positions[:, 1] *= -1.0
            normals[:, 1] *= -1.0

            indices = gltf.accessor(prim["indices"]).reshape(-1).astype(np.uint32)

            paths = TexturePaths()
            mean_albedo = np.full(3, 0.5, np.float32)
            if "material" in prim:
                material = doc["materials"][prim["material"]]
                pbr = material.get("pbrMetallicRoughness", {})

                def image_uri(tex_index):
                    source = doc["textures"][tex_index]["source"]
                    return doc["images"][source].get("uri")

                base = pbr.get("baseColorTexture")
                if base is not None and image_uri(base["index"]):
                    uri = image_uri(base["index"])
                    paths.albedo = str(model_dir / uri)
                    mean_albedo = _compute_mean_albedo(model_dir / uri)
                mr = pbr.get("metallicRoughnessTexture")
                if mr is not None and image_uri(mr["index"]):
                    paths.specular = str(model_dir / image_uri(mr["index"]))
                nt = material.get("normalTexture")
                if nt is not None and image_uri(nt["index"]):
                    paths.normal = str(model_dir / image_uri(nt["index"]))

            compute_sdf = "noSDF" not in mesh.get("extras", {})
            if compute_sdf:
                prim_index = len(primitive_list)
                name = mesh.get("name", f"mesh{len(per_mesh_primitives)}")
                suffix = f"_{prim_index}" if prim_index > 0 else ""
                paths.sdf = str(model_dir / "sdfTextures" / f"{name}{suffix}.dds")

            primitive_list.append(len(meshes))
            meshes.append(
                MeshData(
                    indices=indices,
                    positions=positions,
                    normals=normals,
                    tangents=tangents,
                    bitangents=bitangents,
                    uvs=uvs,
                    texture_paths=paths,
                    mean_albedo=mean_albedo,
                )
            )
        per_mesh_primitives.append(primitive_list)

    # flatten node hierarchy (ModelImport.cpp:262-316)
    objects: list[ObjectBinary] = []
    correction = np.diag(np.asarray([1.0, -1.0, 1.0, 1.0], np.float32))
    for scene in doc.get("scenes", []):
        stack = [(idx, np.eye(4, dtype=np.float32)) for idx in scene.get("nodes", [])]
        while stack:
            node_index, parent = stack.pop()
            node = doc["nodes"][node_index]
            model_matrix = parent @ _node_matrix(node)
            for child in node.get("children", []):
                stack.append((child, model_matrix))
            if "mesh" in node:
                corrected = correction @ model_matrix @ correction
                for prim_index in per_mesh_primitives[node["mesh"]]:
                    objects.append(
                        ObjectBinary(model_matrix=corrected, mesh_index=prim_index)
                    )
    return Scene(objects=objects, meshes=meshes)
